// Phase marks: one empty kernel per phase of a step, launched at the
// phase's start on the step's stream (utils/trace.py `phase`). A device
// trace (CUPTI, as torch.profiler records it) then shows where each phase
// begins, also inside a replayed CUDA graph, where the host has no boundary
// within a step: every device interval after a mark belongs to that mark's
// phase until the next mark. The kernels do nothing; their names are what
// a reader matches, so they are extern "C" (not mangled). The attention
// marks bound a multi-head attention block (nn/attention.py): forward, the
// start mark at its input and the end mark at its output; backward, the
// start mark where the output's gradient arrives and the end mark where
// the input's leaves.

#include <cuda_runtime.h>

extern "C" __global__ void bla_mark_forward() {}
extern "C" __global__ void bla_mark_backward() {}
extern "C" __global__ void bla_mark_adam() {}
extern "C" __global__ void bla_mark_update() {}
extern "C" __global__ void bla_mark_attention() {}
extern "C" __global__ void bla_mark_attention_end() {}

// Launches mark `phase` (0 forward, 1 backward, 2 adam, 3 update,
// 4 attention, 5 attention_end) as one
// thread on `stream`; returns cudaGetLastError() after the launch.
extern "C" int bla_mark(int phase, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case 0:
      bla_mark_forward<<<1, 1, 0, s>>>();
      break;
    case 1:
      bla_mark_backward<<<1, 1, 0, s>>>();
      break;
    case 2:
      bla_mark_adam<<<1, 1, 0, s>>>();
      break;
    case 3:
      bla_mark_update<<<1, 1, 0, s>>>();
      break;
    case 4:
      bla_mark_attention<<<1, 1, 0, s>>>();
      break;
    case 5:
      bla_mark_attention_end<<<1, 1, 0, s>>>();
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* bla_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

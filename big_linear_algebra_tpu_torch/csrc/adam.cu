// One Adam step over many leaves, in place, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's Adam (big_linear_algebra_tpu/
// nn/optim.py) is a tree_map that XLA fuses into a few loops. Op by op,
// nn/optim.py's _adam_core launches about 14 elementwise kernels a leaf,
// and TrainSteps then copies p, m and v back into its buffers: over the
// U-Net's 122 leaves about 2,076 launches a step. Here one pass reads p,
// g, m and v once and writes p, m and v once, in the buffers themselves.
//
// What bounds it on the H100: bytes. 28 bytes an f32 parameter (four
// reads, three writes) at 3.35 TB/s; the arithmetic (two divides and a
// square root an element) is far below the CUDA cores' rate. What the
// design does about it:
// - Multi-tensor launches (apex's multi_tensor_apply shape). The leaves'
//   pointers and sizes travel by value in the kernel's arguments, up to
//   kLeaves leaves a launch, so the leaves stay where they are: nothing is
//   flattened into one buffer, nothing is copied. A block takes one
//   (leaf, chunk) pair: kChunk elements of one leaf, found from the
//   launch's prefix sum of chunks a leaf.
// - 16-byte loads and stores. Where a leaf's four pointers are 16-byte
//   aligned each thread moves kUnroll float4s of each array, all loads
//   issued before any arithmetic; a misaligned leaf, and the tail of a
//   leaf past its last whole float4, take the scalar path.
// - The bias corrections are read on the device, row *counter of table,
//   as nn/optim.py's adam_update_at reads them: no host copy, so a CUDA
//   graph captures the launches and replays them as they stand.
//
// Bit for bit _adam_core in f32: the same operations in the same order,
// each rounded once to nearest (the _rn intrinsics, which nvcc never
// contracts into an FMA, as torch's separate kernels never do):
//   m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*(g*g);
//   p = p - (lr*(m/bc1)) / (sqrt(v/bc2) + eps)
// with the constants rounded as torch rounds a Python scalar into an f32
// kernel: (float)b1, and (float)(1.0 - b1) with the subtraction in double.
// Deterministic: each element is one thread's, so replicas stay equal.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cassert>

namespace {

constexpr int kLeaves = 48;       // leaves a launch (kernel arguments < 4 KB)
constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // float4s of each array a thread moves
constexpr int64_t kChunk = int64_t(kThreads) * 4 * kUnroll;  // elements

struct Leaves {
  float* p[kLeaves];
  const float* g[kLeaves];
  float* m[kLeaves];
  float* v[kLeaves];
  int64_t n[kLeaves];
  int first_block[kLeaves + 1];   // leaf l has blocks [first_block[l], [l+1])
};

struct Consts {
  float b1, omb1, b2, omb2, lr, eps;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m,
                                         float& v, const Consts& c,
                                         float bc1, float bc2) {
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  const float num = __fmul_rn(c.lr, __fdiv_rn(m, bc1));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), c.eps);
  p = __fsub_rn(p, __fdiv_rn(num, den));
}

__device__ __forceinline__ void adam_four(float4& p, const float4& g,
                                          float4& m, float4& v,
                                          const Consts& c, float bc1,
                                          float bc2) {
  adam_one(p.x, g.x, m.x, v.x, c, bc1, bc2);
  adam_one(p.y, g.y, m.y, v.y, c, bc1, bc2);
  adam_one(p.z, g.z, m.z, v.z, c, bc1, bc2);
  adam_one(p.w, g.w, m.w, v.w, c, bc1, bc2);
}

__global__ void __launch_bounds__(kThreads)
    bla_adam_kernel(const Leaves leaves, const int64_t* __restrict__ counter,
                    const float* __restrict__ table, const int64_t rows,
                    const Consts c) {
  const int block = blockIdx.x;
  int l = 0;
  while (block >= leaves.first_block[l + 1]) ++l;
  const int64_t start = int64_t(block - leaves.first_block[l]) * kChunk;
  const int64_t n = leaves.n[l];
  const int64_t stop = start + kChunk < n ? start + kChunk : n;
  float* p = leaves.p[l] + start;
  const float* g = leaves.g[l] + start;
  float* m = leaves.m[l] + start;
  float* v = leaves.v[l] + start;
  const int64_t row = *counter;
  assert(row >= 0 && row < rows);  // as index_select's bound check
  const float bc1 = table[2 * row];
  const float bc2 = table[2 * row + 1];
  const int len = int(stop - start);

  // start is a multiple of kChunk (of 4), so a leaf's alignment holds for
  // every chunk of it
  const bool vec = ((reinterpret_cast<uintptr_t>(p) |
                     reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(m) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  int scalar_from = 0;
  if (vec) {
    const int quads = len / 4;
    float4 rp[kUnroll], rg[kUnroll], rm[kUnroll], rv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < quads) {
        rp[k] = reinterpret_cast<const float4*>(p)[i];
        rg[k] = reinterpret_cast<const float4*>(g)[i];
        rm[k] = reinterpret_cast<const float4*>(m)[i];
        rv[k] = reinterpret_cast<const float4*>(v)[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < quads) {
        adam_four(rp[k], rg[k], rm[k], rv[k], c, bc1, bc2);
        reinterpret_cast<float4*>(p)[i] = rp[k];
        reinterpret_cast<float4*>(m)[i] = rm[k];
        reinterpret_cast<float4*>(v)[i] = rv[k];
      }
    }
    scalar_from = quads * 4;
  }
  for (int i = scalar_from + threadIdx.x; i < len; i += kThreads) {
    float pi = p[i], mi = m[i], vi = v[i];
    adam_one(pi, g[i], mi, vi, c, bc1, bc2);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

// One Adam step over the n leaves whose device pointers are p[i], g[i],
// m[i], v[i] (f32, contiguous, sizes[i] elements each; the arrays of
// pointers are on the host), in place, with the bias corrections of row
// *counter (a device assert unless 0 <= *counter < rows) of the (rows, 2)
// f32 table: ceil(n / kLeaves) launches on `stream` (none for a group
// without elements), their number written to *launches. Returns
// cudaGetLastError() after the last launch, or the first launch's error.
extern "C" int bla_adam_update(int n, float* const* p, const float* const* g,
                               float* const* m, float* const* v,
                               const int64_t* sizes, const int64_t* counter,
                               const float* table, int64_t rows,
                               double lr, double b1, double b2, double eps,
                               int* launches, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Consts c = {static_cast<float>(b1), static_cast<float>(1.0 - b1),
                    static_cast<float>(b2), static_cast<float>(1.0 - b2),
                    static_cast<float>(lr), static_cast<float>(eps)};
  *launches = 0;
  for (int first = 0; first < n; first += kLeaves) {
    const int count = n - first < kLeaves ? n - first : kLeaves;
    Leaves leaves = {};
    int64_t blocks = 0;
    for (int l = 0; l < count; ++l) {
      leaves.p[l] = p[first + l];
      leaves.g[l] = g[first + l];
      leaves.m[l] = m[first + l];
      leaves.v[l] = v[first + l];
      leaves.n[l] = sizes[first + l];
      leaves.first_block[l] = static_cast<int>(blocks);
      blocks += (sizes[first + l] + kChunk - 1) / kChunk;
    }
    // past the group's last leaf: a bound no block reaches
    for (int l = count; l <= kLeaves; ++l)
      leaves.first_block[l] = static_cast<int>(blocks);
    if (blocks == 0) continue;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    bla_adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        leaves, counter, table, rows, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  return cudaGetLastError();
}

extern "C" int bla_adam_leaves_per_launch() { return kLeaves; }

extern "C" const char* bla_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

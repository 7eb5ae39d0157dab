// K1: the GEMM with a fused bias + ReLU epilogue, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of big_linear_algebra_tpu/ops/matmul.py:
//   _mm_kernel_2d (full-K 2-D grid, launched by _pallas_mm)
//   _mm_kernel    (K-split 3-D grid with an f32 VMEM scratch accumulator)
// and their _epilogue. It computes
//   C = op(A) . op(B) (+ bias[n]) (then ReLU), cast to the output type,
// for the variants nn (A (M,K), B (K,N)), nt (A (M,K), B (N,K)) and
// tn (A (K,M), B (K,N)). A and B are read in their stored layout; no
// transpose is materialized (on the TPU the transposes lived in the block
// index maps).
//
// Design:
// - One block per 64x64 output tile; M tiles on gridDim.x (the eval batch
//   can be 10,000 rows), N tiles on gridDim.y. A loop over K inside the block
//   takes the place of both the full-K and the K-split grids: blocks on a GPU
//   run in no order, so nothing can carry a sum from one block to the next.
// - Each K step stages a 64x16 strip of A and a 16x64 strip of B in shared
//   memory, converted to f32. The loads follow each operand's contiguous
//   axis, so neighbouring threads read neighbouring addresses.
// - Ragged M, N and K are masked in the kernel (out-of-range loads read 0,
//   out-of-range stores are skipped); the wrapper never pads or copies.
// - 256 threads, each holding a 4x4 tile of f32 accumulators in registers.
// - Epilogue in f32: + bias, ReLU (NaN propagates, like jnp.maximum), cast.
//
// Types: f32 in with true f32 FMA (no TF32), or bf16 in (exact products in
// f32, f32 accumulation); f32 or bf16 out. The bias is f32.
//
// What bounds it on the H100: an f32 product can only use the CUDA cores'
// FP32 FMA rate (67 TFLOP/s dense at 700 W), since true f32 has no tensor-core
// path; the shared-memory tiling keeps it off the memory bound (each staged
// element feeds 64 FMAs per K step). This first version also runs bf16 on the
// FMA path, so it does not reach the tensor cores; mma.sync / wgmma with TMA
// staging are the next steps.
//
// C interface (bound with ctypes): bla_matmul returns cudaGetLastError()
// after the launch; it launches on the given stream and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;  // rows per thread
constexpr int TN = 4;  // columns per thread
constexpr int ROW_THREADS = BM / TM;  // 16
constexpr int COL_THREADS = BN / TN;  // 16
constexpr int THREADS = ROW_THREADS * COL_THREADS;  // 256

enum Variant { kNN = 0, kNT = 1, kTN = 2 };
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int kVariant, typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS)
    mm_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
              const float* __restrict__ bias, int relu, TOut* __restrict__ c,
              int M, int N, int K) {
  // +1 column: the k-contiguous loads write down a column of the strip, and
  // the padding spreads those writes over the shared-memory banks.
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

  // A is stored (M, K) for nn and nt (K contiguous), (K, M) for tn;
  // B is stored (K, N) for nn and tn (N contiguous), (N, K) for nt.
  constexpr bool a_k_contig = kVariant != kTN;
  constexpr bool b_k_contig = kVariant == kNT;

  const int tid = threadIdx.x;
  const int tx = tid % COL_THREADS;
  const int ty = tid / COL_THREADS;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int kk = a_k_contig ? idx % BK : idx / BM;
      const int mm = a_k_contig ? idx / BK : idx % BM;
      const int gm = m0 + mm;
      const int gk = k0 + kk;
      float v = 0.f;
      if (gm < M && gk < K) {
        v = to_f32(a_k_contig ? a[static_cast<size_t>(gm) * K + gk]
                              : a[static_cast<size_t>(gk) * M + gm]);
      }
      As[kk][mm] = v;
    }
#pragma unroll
    for (int r = 0; r < (BN * BK) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int kk = b_k_contig ? idx % BK : idx / BN;
      const int nn = b_k_contig ? idx / BK : idx % BN;
      const int gn = n0 + nn;
      const int gk = k0 + kk;
      float v = 0.f;
      if (gn < N && gk < K) {
        v = to_f32(b_k_contig ? b[static_cast<size_t>(gn) * K + gk]
                              : b[static_cast<size_t>(gk) * N + gn]);
      }
      Bs[kk][nn] = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ra[TM];
      float rb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ra[i] = As[kk][ty + i * ROW_THREADS];
#pragma unroll
      for (int j = 0; j < TN; ++j) rb[j] = Bs[kk][tx + j * COL_THREADS];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tx + j * COL_THREADS;
    if (n >= N) continue;
    const float bn = bias != nullptr ? bias[n] : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + i * ROW_THREADS;
      if (m >= M) continue;
      float v = acc[i][j] + bn;
      if (relu && v < 0.f) v = 0.f;
      store(&c[static_cast<size_t>(m) * N + n], v);
    }
  }
}

template <int kVariant, typename TIn, typename TOut>
cudaError_t launch(const void* a, const void* b, const float* bias, int relu,
                   void* c, int m, int n, int k, cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  mm_kernel<kVariant, TIn, TOut><<<grid, THREADS, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b), bias, relu,
      static_cast<TOut*>(c), m, n, k);
  return cudaGetLastError();
}

template <int kVariant>
cudaError_t launch_typed(int in_dtype, int out_dtype, const void* a,
                         const void* b, const float* bias, int relu, void* c,
                         int m, int n, int k, cudaStream_t stream) {
  if (in_dtype == kF32 && out_dtype == kF32)
    return launch<kVariant, float, float>(a, b, bias, relu, c, m, n, k, stream);
  if (in_dtype == kF32 && out_dtype == kBF16)
    return launch<kVariant, float, __nv_bfloat16>(a, b, bias, relu, c, m, n, k,
                                                  stream);
  if (in_dtype == kBF16 && out_dtype == kF32)
    return launch<kVariant, __nv_bfloat16, float>(a, b, bias, relu, c, m, n, k,
                                                  stream);
  if (in_dtype == kBF16 && out_dtype == kBF16)
    return launch<kVariant, __nv_bfloat16, __nv_bfloat16>(a, b, bias, relu, c,
                                                          m, n, k, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int bla_matmul(int variant, int in_dtype, int out_dtype,
                          const void* a, const void* b, const void* bias,
                          int relu, void* c, int m, int n, int k,
                          void* stream) {
  if (m <= 0 || n <= 0 || k < 0) return cudaErrorInvalidValue;
  const float* bias_f32 = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kNN:
      return launch_typed<kNN>(in_dtype, out_dtype, a, b, bias_f32, relu, c, m,
                               n, k, s);
    case kNT:
      return launch_typed<kNT>(in_dtype, out_dtype, a, b, bias_f32, relu, c, m,
                               n, k, s);
    case kTN:
      return launch_typed<kTN>(in_dtype, out_dtype, a, b, bias_f32, relu, c, m,
                               n, k, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* bla_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

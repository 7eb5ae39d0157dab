// K2: the flash-attention forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of big_linear_algebra_tpu/nn/attention.py:
//   _flash_fwd_kernel        (K/V rows resident in VMEM; launched by
//                             _flash_fwd at :545)
//   _flash_fwd_stream_kernel (K/V blocks streamed through the grid, the
//                             running (m, l, acc) carried in VMEM scratch;
//                             launched by _flash_fwd at :508)
// Both compute the same function of q, k, v of shape (B, N, D), single
// head, unmasked:
//   o   = softmax(q k^T / sqrt(D)) v, in the input type;
//   lse = the per-row logsumexp of the scaled scores, natural log, (B, N) f32.
// Their arithmetic is kept step for step:
// - exp2 domain: q is scaled by qscale = log2(e)/sqrt(D) in f32 and rounded
//   back to the input type, so every score needs only exp2;
// - P is rounded to the input type before the PV product;
// - all sums are f32; keys past N score -inf.
// The plain PyTorch version is _plain_flash in nn/attention.py.
//
// Design: one kernel covers both TPU kernels. They differ only in whether
// the K/V rows stay resident in VMEM (the TPU chose streaming past a 64 MB
// budget); here K/V tiles always stream through shared memory and nothing is
// sized by N.
// - One block of 256 threads per (batch, tile of 16 q rows); a loop over
//   K/V tiles of BK rows inside the block takes the place of the TPU's
//   sequential key grid axis (GPU blocks run in no order).
// - 16 threads share a q row: G of them split its D dims (dims g, g+G, ...;
//   a shuffle sums the partial scores) and S = 16/G split the keys of each
//   tile (keys s, s+S, ...). Each thread keeps its own running max m, sum l
//   and accumulator acc in registers; at the end the S key slices are merged
//   with shuffles (rescaled to the common max), within one warp.
// - Tiles are staged in shared memory as f32. The row stride D+G puts the
//   words that a warp reads at once in distinct banks.
// - Ragged N is masked in the kernel (staged rows past N read 0 and score
//   -inf; rows past N are not stored): no padding copy. A slice whose keys
//   so far are all masked has m = -inf; the exp2 offset then uses 0, not
//   -inf - -inf.
// - D is a template parameter: 4, 8, 16, 32, 64 or 128. The wrapper rejects
//   any other D.
//
// What bounds it on the H100: per score one D-long dot product, one exp2 and
// one D-long update of acc. At the U-Net's D = 16 that is 4·D = 64 flops per
// exp2, below the exp2 units' share of the peak, so an ideal kernel would be
// bound by exp2 (16 per clock per SM) and, at the U-Net's N = 1024, would
// take well under a microsecond, where the launch dominates. This first
// version does its products with FP32 FMA on the CUDA cores, also for bf16,
// and issues its loads without prefetch; mma.sync / wgmma for the two
// products are the next steps.
//
// C interface (bound with ctypes): bla_flash_fwd returns cudaGetLastError()
// after the launch; it launches on the given stream and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int ROW_THREADS = 16;            // threads that share one q row
constexpr int BQ = THREADS / ROW_THREADS;  // q rows per block
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// An f32 value rounded to the input type T and widened back: the plain
// version's .to(dtype) of the scaled q and of P.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
struct Geometry {
  static constexpr int DP = D < 16 ? D : 16;     // dims per thread
  static constexpr int G = D / DP;               // threads splitting the dims
  static constexpr int S = ROW_THREADS / G;      // threads splitting the keys
  static constexpr int BK = D <= 64 ? 64 : 32;   // keys per staged tile
  static constexpr int KPT = BK / S;             // keys per thread per tile
  static constexpr int LD = D + G;               // shared row stride (floats)
  static_assert(DP * G == D && S * G == ROW_THREADS && KPT * S == BK,
                "unsupported head dim");
};

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int n, float qscale) {
  using Geo = Geometry<D>;
  constexpr int DP = Geo::DP;
  constexpr int G = Geo::G;
  constexpr int S = Geo::S;
  constexpr int BK = Geo::BK;
  constexpr int KPT = Geo::KPT;
  constexpr int LD = Geo::LD;
  __shared__ float ks[BK * LD];
  __shared__ float vs[BK * LD];

  const int tid = threadIdx.x;
  const int g = tid % G;                // owns dims g + G*i
  const int s = (tid / G) % S;          // owns keys s + S*j of each tile
  const int row = blockIdx.x * BQ + tid / ROW_THREADS;
  const bool row_ok = row < n;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;

  float qr[DP];
  float acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = row_ok ? round_to<T>(to_f32(q[base + static_cast<size_t>(row) * D
                                          + g + G * i]) * qscale)
                   : 0.f;
    acc[i] = 0.f;
  }
  float m = -CUDART_INF_F;
  float l = 0.f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    for (int e = tid; e < BK * D; e += THREADS) {
      const int key = e / D;
      const int dim = e % D;
      const bool ok = k0 + key < n;
      const size_t idx = base + static_cast<size_t>(k0 + key) * D + dim;
      ks[key * LD + dim] = ok ? to_f32(k[idx]) : 0.f;
      vs[key * LD + dim] = ok ? to_f32(v[idx]) : 0.f;
    }
    __syncthreads();

    float sc[KPT];
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int key = s + S * j;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i)
        part = fmaf(qr[i], ks[key * LD + g + G * i], part);
#pragma unroll
      for (int off = 1; off < G; off <<= 1)
        part += __shfl_xor_sync(FULL_MASK, part, off);
      sc[j] = k0 + key < n ? part : -CUDART_INF_F;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    // all keys of this slice masked so far: offset by 0, so that exp2 sees
    // -inf - 0 = -inf (giving 0) and never -inf - -inf
    const float m_off = m_new == -CUDART_INF_F ? 0.f : m_new;
    const float alpha = exp2f(m - m_off);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = exp2f(sc[j] - m_off);
      l += p;
      const float pr = round_to<T>(p);
      const int key = s + S * j;
#pragma unroll
      for (int i = 0; i < DP; ++i)
        acc[i] = fmaf(pr, vs[key * LD + g + G * i], acc[i]);
    }
    m = m_new;
    __syncthreads();
  }

  // Merge the S key slices of the row: lanes G, 2G, ... apart in one warp.
  float m_all = m;
#pragma unroll
  for (int off = G; off < ROW_THREADS; off <<= 1)
    m_all = fmaxf(m_all, __shfl_xor_sync(FULL_MASK, m_all, off));
  const float f = m_all == -CUDART_INF_F ? 0.f : exp2f(m - m_all);
  l *= f;
#pragma unroll
  for (int i = 0; i < DP; ++i) acc[i] *= f;
#pragma unroll
  for (int off = G; off < ROW_THREADS; off <<= 1) {
    l += __shfl_xor_sync(FULL_MASK, l, off);
#pragma unroll
    for (int i = 0; i < DP; ++i)
      acc[i] += __shfl_xor_sync(FULL_MASK, acc[i], off);
  }
  if (row_ok && s == 0) {
#pragma unroll
    for (int i = 0; i < DP; ++i)
      store(&o[base + static_cast<size_t>(row) * D + g + G * i], acc[i] / l);
    if (g == 0)
      lse[static_cast<size_t>(blockIdx.y) * n + row] =
          (m_all + log2f(l)) / LOG2E;
  }
}

template <int D, typename T>
cudaError_t launch(int b, int n, const void* q, const void* k, const void* v,
                   void* o, float* lse, float qscale, cudaStream_t stream) {
  const dim3 grid((n + BQ - 1) / BQ, b);
  flash_fwd_kernel<D, T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, n, qscale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int d, int b, int n, const void* q, const void* k,
                       const void* v, void* o, float* lse, float qscale,
                       cudaStream_t stream) {
  switch (d) {
    case 4:
      return launch<4, T>(b, n, q, k, v, o, lse, qscale, stream);
    case 8:
      return launch<8, T>(b, n, q, k, v, o, lse, qscale, stream);
    case 16:
      return launch<16, T>(b, n, q, k, v, o, lse, qscale, stream);
    case 32:
      return launch<32, T>(b, n, q, k, v, o, lse, qscale, stream);
    case 64:
      return launch<64, T>(b, n, q, k, v, o, lse, qscale, stream);
    case 128:
      return launch<128, T>(b, n, q, k, v, o, lse, qscale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int bla_flash_fwd(int dtype, int b, int n, int d, const void* q,
                             const void* k, const void* v, void* o, void* lse,
                             float qscale, void* stream) {
  if (b <= 0 || b > 65535 || n <= 0) return cudaErrorInvalidValue;
  float* lse_f32 = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_dim<float>(d, b, n, q, k, v, o, lse_f32, qscale, s);
    case kBF16:
      return launch_dim<__nv_bfloat16>(d, b, n, q, k, v, o, lse_f32, qscale,
                                       s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* bla_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K2c and K2d: the flash-attention backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of big_linear_algebra_tpu/nn/attention.py that
// the JAX package's backward runs by default (_flash_bwd_padded, stream):
//   _flash_bwd_stream_dq_kernel  (K2c, launched at :662) -> flash_bwd_dq_kernel
//   _flash_bwd_stream_dkv_kernel (K2d, launched at :682) -> flash_bwd_dkv_kernel
// Inputs: q, k, v, g of shape (B, N, D) in the input type (g already cast to
// it), and per row lse2 = lse * log2(e) and delta = sum_d g * o, both (B, N)
// f32 (the JAX package's _flash_bwd_prepare, done in plain torch by the
// wrapper). Per score, with sscale = log2(e)/sqrt(D):
//   s  = round_to_input(q * sscale) . k    f32 sums: the forward's score
//   p  = exp2(s - lse2)            0 for keys / query rows past N
//   dp = g . v                     f32
//   ds = round_to_input(p * (dp - delta))
// and the kernels sum, in f32:
//   K2c: dq = scale * sum_j ds * k_j
//   K2d: dv = sum_i round_to_input(p) * g_i,  dk = scale * sum_i ds * q_i
// with scale = 1/sqrt(D) applied once at the end; outputs in the input type.
// The plain PyTorch version is _plain_flash_bwd in nn/attention.py.
//
// Design. The TPU walked a sequential grid axis (k/v blocks for dq, q blocks
// for dk/dv) and carried the sums in VMEM scratch. GPU blocks run in no
// order, so each block owns a tile of output rows and loops over the other
// side's tiles itself:
// - K2c: one block of 256 threads per (batch, tile of 16 q rows); K/V tiles
//   of BT rows are staged in shared memory as f32.
// - K2d: one block per (batch, tile of 16 k rows); q/g tiles and their lse2
//   and delta are staged, and query rows past N are masked (their lse rows
//   are not read).
// - As in the forward (flash_attn.cu), 16 threads share an output row: G of
//   them split its D dims (a shuffle sums the partial dot products) and
//   S = 16/G split the rows of each staged tile; the S partial sums are
//   merged with shuffles at the end. Each output row is owned by one block,
//   so there are no atomics and the results are deterministic.
// - The scores are recomputed exactly as the forward (flash_attn.cu) formed
//   them, from q scaled and rounded to the input type, so p <= 1 against
//   the forward's lse. The Pallas kernels instead scale the unrounded f32
//   score; in bf16 that score can exceed the forward's by more than 128
//   once |s| nears 1e5 (the full-width U-Net's up_3 sites at init), and p
//   then overflows to inf and the gradient to NaN. In f32 both agree to
//   rounding.
// - The other rounding points are the Pallas kernels': ds is rounded to the
//   input type before both of its products, p before the dv product.
// - Ragged N is masked in the kernel (staged rows past N read 0): no padding
//   copy. D is a template parameter: 4, 8, 16, 32, 64 or 128.
//
// What bounds it on the H100: per score two D-long dot products and one exp2
// (both kernels), then one D-long update (K2c) or two (K2d). At the U-Net's
// D = 16 that is 6*D = 96 (K2c) and 8*D = 128 (K2d) flops per exp2, so an
// ideal kernel is bound by exp2 (16 per clock per SM) in bf16 and by the f32
// CUDA-core rate in f32. This first version does every product with FP32 FMA
// on the CUDA cores and stages tiles without prefetch; mma.sync / wgmma for
// the products, cp.async staging and a key split across blocks are the next
// steps.
//
// C interface (bound with ctypes): each entry returns cudaGetLastError()
// after its launch; it launches on the given stream and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int ROW_THREADS = 16;            // threads that share an output row
constexpr int BR = THREADS / ROW_THREADS;  // output rows per block
constexpr unsigned FULL_MASK = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// An f32 value rounded to the input type T and widened back: the plain
// version's .to(dtype) of p and of ds.
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
  static constexpr int S = ROW_THREADS / G;      // threads splitting a tile
  static constexpr int BT = D <= 64 ? 64 : 32;   // rows per staged tile
  static constexpr int TPT = BT / S;             // tile rows per thread
  static constexpr int LD = D + G;               // shared row stride (floats)
  static_assert(DP * G == D && S * G == ROW_THREADS && TPT * S == BT,
                "unsupported head dim");
};

// Sum a partial dot product over the G threads that split the dims.
template <int G>
__device__ __forceinline__ float sum_dims(float part) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1)
    part += __shfl_xor_sync(FULL_MASK, part, off);
  return part;
}

// Sum a row's accumulator over its S tile slices (lanes G, 2G, ... apart).
template <int G, int DP>
__device__ __forceinline__ void merge_slices(float (&acc)[DP]) {
#pragma unroll
  for (int off = G; off < ROW_THREADS; off <<= 1) {
#pragma unroll
    for (int i = 0; i < DP; ++i)
      acc[i] += __shfl_xor_sync(FULL_MASK, acc[i], off);
  }
}

// Stage rows [r0, r0 + BT) of two (n, D) matrices into shared memory as
// f32; rows past n read 0.
template <int D, typename T>
__device__ __forceinline__ void stage(const T* __restrict__ a,
                                      const T* __restrict__ b, float* as,
                                      float* bs, size_t base, int r0, int n) {
  using Geo = Geometry<D>;
  for (int e = threadIdx.x; e < Geo::BT * D; e += THREADS) {
    const int r = e / D;
    const int dim = e % D;
    const bool ok = r0 + r < n;
    const size_t idx = base + static_cast<size_t>(r0 + r) * D + dim;
    as[r * Geo::LD + dim] = ok ? to_f32(a[idx]) : 0.f;
    bs[r * Geo::LD + dim] = ok ? to_f32(b[idx]) : 0.f;
  }
}

// K2c: dq for one tile of 16 q rows.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse2,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int n, float sscale, float scale) {
  using Geo = Geometry<D>;
  constexpr int DP = Geo::DP;
  constexpr int G = Geo::G;
  constexpr int S = Geo::S;
  constexpr int BT = Geo::BT;
  constexpr int LD = Geo::LD;
  __shared__ float ks[BT * LD];
  __shared__ float vs[BT * LD];

  const int tid = threadIdx.x;
  const int gd = tid % G;               // owns dims gd + G*i
  const int s = (tid / G) % S;          // owns rows s + S*j of each tile
  const int row = blockIdx.x * BR + tid / ROW_THREADS;
  const bool row_ok = row < n;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const size_t rbase = base + static_cast<size_t>(row) * D;

  float qr[DP];  // q scaled and rounded as the forward has it
  float gr[DP];
  float acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = row_ok ? round_to<T>(__fmul_rn(to_f32(q[rbase + gd + G * i]),
                                           sscale))
                   : 0.f;
    gr[i] = row_ok ? to_f32(g[rbase + gd + G * i]) : 0.f;
    acc[i] = 0.f;
  }
  const size_t stat = static_cast<size_t>(blockIdx.y) * n + row;
  const float l2 = row_ok ? lse2[stat] : 0.f;
  const float dl = row_ok ? delta[stat] : 0.f;

  for (int k0 = 0; k0 < n; k0 += BT) {
    stage<D, T>(k, v, ks, vs, base, k0, n);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < Geo::TPT; ++j) {
      const int key = s + S * j;
      float sp = 0.f;
      float dpp = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        sp = fmaf(qr[i], ks[key * LD + gd + G * i], sp);
        dpp = fmaf(gr[i], vs[key * LD + gd + G * i], dpp);
      }
      sp = sum_dims<G>(sp);
      dpp = sum_dims<G>(dpp);
      const float p = k0 + key < n ? exp2f(sp - l2) : 0.f;
      const float ds = round_to<T>(p * (dpp - dl));
#pragma unroll
      for (int i = 0; i < DP; ++i)
        acc[i] = fmaf(ds, ks[key * LD + gd + G * i], acc[i]);
    }
    __syncthreads();
  }
  merge_slices<G, DP>(acc);
  if (row_ok && s == 0) {
#pragma unroll
    for (int i = 0; i < DP; ++i) store(&dq[rbase + gd + G * i], acc[i] * scale);
  }
}

// K2d: dk and dv for one tile of 16 k rows.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ lse2,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int n, float sscale,
                         float scale) {
  using Geo = Geometry<D>;
  constexpr int DP = Geo::DP;
  constexpr int G = Geo::G;
  constexpr int S = Geo::S;
  constexpr int BT = Geo::BT;
  constexpr int LD = Geo::LD;
  __shared__ float qs[BT * LD];
  __shared__ float gs[BT * LD];
  __shared__ float ls[BT];
  __shared__ float dls[BT];

  const int tid = threadIdx.x;
  const int gd = tid % G;
  const int s = (tid / G) % S;
  const int row = blockIdx.x * BR + tid / ROW_THREADS;
  const bool row_ok = row < n;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const size_t rbase = base + static_cast<size_t>(row) * D;
  const size_t sbase = static_cast<size_t>(blockIdx.y) * n;

  float kr[DP];
  float vr[DP];
  float dk_acc[DP];
  float dv_acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    kr[i] = row_ok ? to_f32(k[rbase + gd + G * i]) : 0.f;
    vr[i] = row_ok ? to_f32(v[rbase + gd + G * i]) : 0.f;
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += BT) {
    stage<D, T>(q, g, qs, gs, base, q0, n);
    if (tid < BT) {
      const bool ok = q0 + tid < n;
      ls[tid] = ok ? lse2[sbase + q0 + tid] : 0.f;
      dls[tid] = ok ? delta[sbase + q0 + tid] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < Geo::TPT; ++j) {
      const int qi = s + S * j;
      float sp = 0.f;
      float dpp = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        const float qsc = round_to<T>(__fmul_rn(qs[qi * LD + gd + G * i],
                                                sscale));
        sp = fmaf(qsc, kr[i], sp);
        dpp = fmaf(gs[qi * LD + gd + G * i], vr[i], dpp);
      }
      sp = sum_dims<G>(sp);
      dpp = sum_dims<G>(dpp);
      // query rows past N: their lse and delta are not real rows
      const float p = q0 + qi < n ? exp2f(sp - ls[qi]) : 0.f;
      const float pr = round_to<T>(p);
      const float ds = round_to<T>(p * (dpp - dls[qi]));
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        dv_acc[i] = fmaf(pr, gs[qi * LD + gd + G * i], dv_acc[i]);
        dk_acc[i] = fmaf(ds, qs[qi * LD + gd + G * i], dk_acc[i]);
      }
    }
    __syncthreads();
  }
  merge_slices<G, DP>(dk_acc);
  merge_slices<G, DP>(dv_acc);
  if (row_ok && s == 0) {
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      store(&dk[rbase + gd + G * i], dk_acc[i] * scale);
      store(&dv[rbase + gd + G * i], dv_acc[i]);
    }
  }
}

struct Args {
  int b, n;
  const void *q, *k, *v, *g;
  const float *lse2, *delta;
  void *dq, *dk, *dv;
  float sscale, scale;
  cudaStream_t stream;
};

template <int D, typename T>
cudaError_t launch(const Args& a, bool dkv) {
  const dim3 grid((a.n + BR - 1) / BR, a.b);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.g);
  if (dkv) {
    flash_bwd_dkv_kernel<D, T><<<grid, THREADS, 0, a.stream>>>(
        q, k, v, g, a.lse2, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.n, a.sscale, a.scale);
  } else {
    flash_bwd_dq_kernel<D, T><<<grid, THREADS, 0, a.stream>>>(
        q, k, v, g, a.lse2, a.delta, static_cast<T*>(a.dq), a.n, a.sscale,
        a.scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int d, const Args& a, bool dkv) {
  switch (d) {
    case 4:
      return launch<4, T>(a, dkv);
    case 8:
      return launch<8, T>(a, dkv);
    case 16:
      return launch<16, T>(a, dkv);
    case 32:
      return launch<32, T>(a, dkv);
    case 64:
      return launch<64, T>(a, dkv);
    case 128:
      return launch<128, T>(a, dkv);
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch(int dtype, int d, const Args& a, bool dkv) {
  if (a.b <= 0 || a.b > 65535 || a.n <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return launch_dim<float>(d, a, dkv);
    case kBF16:
      return launch_dim<__nv_bfloat16>(d, a, dkv);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int bla_flash_bwd_dq(int dtype, int b, int n, int d, const void* q,
                                const void* k, const void* v, const void* g,
                                const void* lse2, const void* delta, void* dq,
                                float sscale, float scale, void* stream) {
  const Args a{b,       n,       q,
               k,       v,       g,
               static_cast<const float*>(lse2),
               static_cast<const float*>(delta),
               dq,      nullptr, nullptr,
               sscale,  scale,   static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, d, a, false);
}

extern "C" int bla_flash_bwd_dkv(int dtype, int b, int n, int d,
                                 const void* q, const void* k, const void* v,
                                 const void* g, const void* lse2,
                                 const void* delta, void* dk, void* dv,
                                 float sscale, float scale, void* stream) {
  const Args a{b,       n,  q,
               k,       v,  g,
               static_cast<const float*>(lse2),
               static_cast<const float*>(delta),
               nullptr, dk, dv,
               sscale,  scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, d, a, true);
}

extern "C" const char* bla_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

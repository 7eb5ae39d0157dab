// K3a: the fused flash-attention backward (dq, dk and dv in one pass), for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of big_linear_algebra_tpu/nn/attention.py that
// the JAX package's backward runs with stream=False while its row-resident
// operands fit the VMEM budget (_flash_bwd_padded, launched at :712):
//   _flash_bwd_fused_kernel (:178) -> flash_bwd_fused_kernel, then
//                                     flash_bwd_dq_reduce_kernel
// Inputs as K2c/K2d (flash_attn_bwd.cu): q, k, v, g of shape (B, N, D) in
// the input type (g already cast to it), and per row lse2 = lse * log2(e)
// and delta = sum_d g * o, both (B, N) f32 (the JAX package's
// _flash_bwd_prepare, done in plain torch by the wrapper). Per score, with
// sscale = log2(e)/sqrt(D):
//   s  = round_to_input(q * sscale) . k    f32 sums: the forward's score
//   p  = exp2(s - lse2)            0 for keys / query rows past N
//   dp = g . v                     f32
//   ds = round_to_input(p * (dp - delta))
// and, summed in f32:
//   dq = scale * sum_j ds * k_j
//   dk = scale * sum_i ds * q_i,   dv = sum_i round_to_input(p) * g_i
// with scale = 1/sqrt(D) applied once at the end; outputs in the input type.
// The plain PyTorch version is _plain_flash_bwd in nn/attention.py.
//
// Design. The TPU kernel walks the k-blocks along a sequential grid axis and
// carries dq for the whole row in VMEM scratch: each (q-block, k-block) pair
// recomputes p once and feeds all three gradients. GPU blocks run in no
// order, so nothing can carry dq from one block to the next:
// - One block of 256 threads per (batch, tile of BT key rows), BT = 64 (32
//   at D = 128). It stages its keys and values once, then walks the query
//   tiles: it stages BT rows of q (as given, and scaled and rounded as the
//   forward has it), g, lse2 and delta, forms the BT x BT tiles of
//   round_to_input(p) and ds in shared memory (each thread a 4x4 (2x2)
//   tile of scores), and from them adds to its keys' dk and dv (registers,
//   BT*D/256 of each per thread) and forms the query tile's share of dq.
// - The share of dq is written, unscaled, to an f32 workspace slot
//   (key tile, B, N, D): ceil(N/BT) * B * N * D * 4 bytes, 16.8 MB at
//   (16, 1024, 16) and 268 MB at (4, 4096, 64). A second kernel sums the
//   slots in key-tile order and applies the scale. No atomics: the
//   gradients are deterministic, bit for bit from run to run.
// - Rounding points as K2c/K2d: the scores are recomputed from q scaled and
//   rounded to the input type, as the forward formed them, so p <= 1
//   against the forward's lse (the Pallas kernel scales the unrounded f32
//   score, which overflows p in bf16 once |s| nears 1e5); ds is rounded to
//   the input type before its products, p before the dv product.
// - Ragged N is masked in the kernel (staged rows past N read 0, their p is
//   0, their lse and delta are not read): no padding copy. D is a template
//   parameter: 4, 8, 16, 32, 64 or 128. Shared rows are padded to an odd
//   stride so that the 16 key rows a warp reads fall in distinct banks.
//
// What bounds it on the H100: per score one exp2 and five D-long products
// (s, dp, dv, dk, dq: 10*D flops). At the U-Net's D = 16 an ideal kernel is
// bound by exp2 (16 per clock per SM) in bf16; at D = 64 by the bf16
// tensor-core rate. This first version does every product with FP32 FMA on
// the CUDA cores out of shared memory (about 1 load per 2 FMAs in the
// score phase, 1 per FMA in the dk/dv/dq phase); it also reads and writes
// the workspace through L2 and device memory. mma.sync / wgmma for the
// products and a dq split that needs no workspace are the next steps.
//
// C interface (bound with ctypes): bla_flash_bwd_fused returns the first
// CUDA error of its two launches (cudaGetLastError() after each); it
// launches on the given stream and never synchronises.
// bla_flash_bwd_fused_tiles gives the workspace's key-tile count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int REDUCE_THREADS = 256;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// An f32 value rounded to the input type T and widened back: the plain
// version's .to(dtype) of q * sscale, p and ds.
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
struct Tiles {
  static constexpr int BT = D <= 64 ? 64 : 32;  // key rows = query rows a step
  static constexpr int MT = BT / 16;            // a thread's score tile side
  static constexpr int LD = D + 1;              // shared stride of (BT, D)
  static constexpr int LS = BT + 1;             // shared stride of (BT, BT)
  static constexpr int EPT = BT * D / THREADS;  // (BT, D) elements a thread
  // ks, vs, qs, qr, gs; ps, dss; ls, dls
  static constexpr int SMEM_FLOATS = 5 * BT * LD + 2 * BT * LS + 2 * BT;
  static_assert(MT * 16 == BT && EPT * THREADS == BT * D,
                "unsupported head dim");
};

// One block: the key rows [k0, k0 + BT) of batch element blockIdx.y.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ g,
                           const float* __restrict__ lse2,
                           const float* __restrict__ delta,
                           float* __restrict__ ws, T* __restrict__ dk,
                           T* __restrict__ dv, int n, float sscale,
                           float scale) {
  using Tl = Tiles<D>;
  constexpr int BT = Tl::BT;
  constexpr int MT = Tl::MT;
  constexpr int LD = Tl::LD;
  constexpr int LS = Tl::LS;
  constexpr int EPT = Tl::EPT;
  extern __shared__ float smem[];
  float* ks = smem;            // this block's keys
  float* vs = ks + BT * LD;    // and values
  float* qs = vs + BT * LD;    // the query tile as given
  float* qr = qs + BT * LD;    // scaled and rounded: the forward's
  float* gs = qr + BT * LD;    // the cotangent tile
  float* ps = gs + BT * LD;    // (query, key): round_to_input(p)
  float* dss = ps + BT * LS;   // (query, key): ds
  float* ls = dss + BT * LS;   // the query tile's lse2
  float* dls = ls + BT;        // and delta

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BT;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const size_t sbase = static_cast<size_t>(blockIdx.y) * n;
  // this key tile's workspace slot of dq shares, (B, N, D)
  float* slot = ws + (static_cast<size_t>(blockIdx.x) * gridDim.y +
                      blockIdx.y) * n * D;

  for (int e = tid; e < BT * D; e += THREADS) {
    const int r = e / D;
    const int c = e % D;
    const bool ok = k0 + r < n;
    const size_t idx = base + static_cast<size_t>(k0 + r) * D + c;
    ks[r * LD + c] = ok ? to_f32(k[idx]) : 0.f;
    vs[r * LD + c] = ok ? to_f32(v[idx]) : 0.f;
  }

  // score phase: query rows ti + 16a, keys tj + 16b (a, b < MT)
  const int ti = tid / 16;
  const int tj = tid % 16;
  // (BT, D) tiles: this thread's elements are rows r0 + r*RS, column col
  constexpr int RS = THREADS / D;
  const int r0 = tid / D;
  const int col = tid % D;
  float dk_acc[EPT];
  float dv_acc[EPT];
#pragma unroll
  for (int r = 0; r < EPT; ++r) {
    dk_acc[r] = 0.f;
    dv_acc[r] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += BT) {
    for (int e = tid; e < BT * D; e += THREADS) {
      const int r = e / D;
      const int c = e % D;
      const bool ok = q0 + r < n;
      const size_t idx = base + static_cast<size_t>(q0 + r) * D + c;
      const float qv = ok ? to_f32(q[idx]) : 0.f;
      qs[r * LD + c] = qv;
      qr[r * LD + c] = round_to<T>(__fmul_rn(qv, sscale));
      gs[r * LD + c] = ok ? to_f32(g[idx]) : 0.f;
    }
    if (tid < BT) {
      const bool ok = q0 + tid < n;
      ls[tid] = ok ? lse2[sbase + q0 + tid] : 0.f;
      dls[tid] = ok ? delta[sbase + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[MT][MT];
    float dp[MT][MT];
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int b = 0; b < MT; ++b) {
        s[a][b] = 0.f;
        dp[a][b] = 0.f;
      }
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float rq[MT];
      float rg[MT];
      float rk[MT];
      float rv[MT];
#pragma unroll
      for (int a = 0; a < MT; ++a) {
        rq[a] = qr[(ti + 16 * a) * LD + c];
        rg[a] = gs[(ti + 16 * a) * LD + c];
      }
#pragma unroll
      for (int b = 0; b < MT; ++b) {
        rk[b] = ks[(tj + 16 * b) * LD + c];
        rv[b] = vs[(tj + 16 * b) * LD + c];
      }
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int b = 0; b < MT; ++b) {
          s[a][b] = fmaf(rq[a], rk[b], s[a][b]);
          dp[a][b] = fmaf(rg[a], rv[b], dp[a][b]);
        }
    }
#pragma unroll
    for (int a = 0; a < MT; ++a) {
      const int i = ti + 16 * a;
#pragma unroll
      for (int b = 0; b < MT; ++b) {
        const int j = tj + 16 * b;
        const bool live = q0 + i < n && k0 + j < n;
        const float p = live ? exp2f(s[a][b] - ls[i]) : 0.f;
        ps[i * LS + j] = round_to<T>(p);
        dss[i * LS + j] = round_to<T>(p * (dp[a][b] - dls[i]));
      }
    }
    __syncthreads();

    // dk and dv of this block's keys: elements (r0 + r*RS, col) of the
    // (BT, D) tile; a thread's elements share the column col, so each staged
    // q and g value is loaded once for all of them
#pragma unroll 4
    for (int i = 0; i < BT; ++i) {
      const float gv = gs[i * LD + col];
      const float qv = qs[i * LD + col];
#pragma unroll
      for (int r = 0; r < EPT; ++r) {
        const int j = r0 + r * RS;
        dv_acc[r] = fmaf(ps[i * LS + j], gv, dv_acc[r]);
        dk_acc[r] = fmaf(dss[i * LS + j], qv, dk_acc[r]);
      }
    }
    // the query tile's share of dq: elements (r0 + r*RS, col)
    float dq_acc[EPT];
#pragma unroll
    for (int r = 0; r < EPT; ++r) dq_acc[r] = 0.f;
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      const float kv = ks[j * LD + col];
#pragma unroll
      for (int r = 0; r < EPT; ++r)
        dq_acc[r] = fmaf(dss[(r0 + r * RS) * LS + j], kv, dq_acc[r]);
    }
#pragma unroll
    for (int r = 0; r < EPT; ++r) {
      const int i = r0 + r * RS;
      if (q0 + i < n) slot[static_cast<size_t>(q0 + i) * D + col] = dq_acc[r];
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < EPT; ++r) {
    const int j = r0 + r * RS;
    if (k0 + j < n) {
      const size_t idx = base + static_cast<size_t>(k0 + j) * D + col;
      store(&dk[idx], dk_acc[r] * scale);
      store(&dv[idx], dv_acc[r]);
    }
  }
}

// dq = scale * sum over the key tiles, in tile order, of their shares.
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
    flash_bwd_dq_reduce_kernel(const float* __restrict__ ws,
                               T* __restrict__ dq, int tiles, size_t count,
                               float scale) {
  const size_t e = static_cast<size_t>(blockIdx.x) * REDUCE_THREADS +
                   threadIdx.x;
  if (e >= count) return;
  float acc = 0.f;
  for (int t = 0; t < tiles; ++t) acc += ws[static_cast<size_t>(t) * count + e];
  store(&dq[e], acc * scale);
}

struct Args {
  int b, n;
  const void *q, *k, *v, *g;
  const float *lse2, *delta;
  float* ws;
  void *dq, *dk, *dv;
  float sscale, scale;
  cudaStream_t stream;
};

template <int D>
int tiles(int n) {
  return (n + Tiles<D>::BT - 1) / Tiles<D>::BT;
}

template <int D, typename T>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = Tiles<D>::SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_fused_kernel<D, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles<D>(a.n), a.b);
  flash_bwd_fused_kernel<D, T><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse2, a.delta,
      a.ws, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.n, a.sscale,
      a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t count = static_cast<size_t>(a.b) * a.n * D;
  const size_t blocks = (count + REDUCE_THREADS - 1) / REDUCE_THREADS;
  flash_bwd_dq_reduce_kernel<T>
      <<<static_cast<unsigned>(blocks), REDUCE_THREADS, 0, a.stream>>>(
          a.ws, static_cast<T*>(a.dq), static_cast<int>(grid.x), count,
          a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int d, const Args& a) {
  switch (d) {
    case 4:
      return launch<4, T>(a);
    case 8:
      return launch<8, T>(a);
    case 16:
      return launch<16, T>(a);
    case 32:
      return launch<32, T>(a);
    case 64:
      return launch<64, T>(a);
    case 128:
      return launch<128, T>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int bla_flash_bwd_fused_tiles(int n, int d) {
  switch (d) {
    case 4:
      return tiles<4>(n);
    case 8:
      return tiles<8>(n);
    case 16:
      return tiles<16>(n);
    case 32:
      return tiles<32>(n);
    case 64:
      return tiles<64>(n);
    case 128:
      return tiles<128>(n);
    default:
      return -1;
  }
}

extern "C" int bla_flash_bwd_fused(int dtype, int b, int n, int d,
                                   const void* q, const void* k,
                                   const void* v, const void* g,
                                   const void* lse2, const void* delta,
                                   void* ws, void* dq, void* dk, void* dv,
                                   float sscale, float scale, void* stream) {
  if (b <= 0 || b > 65535 || n <= 0) return cudaErrorInvalidValue;
  const Args a{b,
               n,
               q,
               k,
               v,
               g,
               static_cast<const float*>(lse2),
               static_cast<const float*>(delta),
               static_cast<float*>(ws),
               dq,
               dk,
               dv,
               sscale,
               scale,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kF32:
      return launch_dim<float>(d, a);
    case kBF16:
      return launch_dim<__nv_bfloat16>(d, a);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* bla_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K2c and K2d: the flash-attention backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of big_linear_algebra_tpu/nn/attention.py that
// the JAX package's backward runs by default (_flash_bwd_padded, stream):
//   _flash_bwd_stream_dq_kernel  (K2c, launched at :662) -> flash_bwd_dq_tc
//     (bf16) and flash_bwd_dq_kernel (f32, and bf16 at D < 16)
//   _flash_bwd_stream_dkv_kernel (K2d, launched at :682) -> flash_bwd_dkv_tc
//     (bf16) and flash_bwd_dkv_kernel (f32, and bf16 at D < 16)
// Past the TPU's fused budget the same entries stand for the row-resident
// two-pass kernels (:738 _flash_bwd_dq_kernel, :762 _flash_bwd_dkv_kernel).
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
// The TPU walked a sequential grid axis (k/v blocks for dq, q blocks for
// dk/dv) and carried the sums in VMEM scratch. GPU blocks run in no order,
// so each block owns a tile of output rows and loops over the other side's
// tiles itself. Each output row is owned by one warp: no atomics, and two
// runs are bit-equal.
//
// What bounds them on the H100. Per score both kernels do two D-long dot
// products (s, dp) and one exp2, then one D-long update (K2c) or two (K2d):
// 6*D or 8*D flops per exp2. At the U-Net's D = 16 that is 96 or 128 flops
// per exp2, so in bf16 the exp2 rate (16 per clock per SM) bounds them, and
// the per-score f32 work around it (subtract, multiply, mask, round) comes
// next; at D = 64 the products do (bf16 tensor-core flops).
//
// bf16, D in {16, 32, 64, 128}: the tensor-core kernels (namespace tc).
// - Every product is mma.sync.m16n8k16 (bf16 in, f32 sums in registers).
//   mma.sync, not wgmma: a warp owns 16 output rows and the S/dP
//   accumulators feed the next product straight from registers, which
//   mma.sync's fragment layouts allow with no shared-memory round trip; at
//   D = 16 the products are not what bounds the kernel.
//   K2c: S = q^ K^T and dP = G V^T, then dQ += dS K.
//   K2d: S^T = K q^^T and dP^T = V G^T, then dV += P^T G and dK += dS^T Q;
//   the transposed orientation puts P^T and dS^T in the A position.
//   An m16n8 accumulator pair packs (as bf16, round to nearest even) into
//   the m16k16 A fragment of the next product: that packing is exactly the
//   rounding of p and ds that the plain version does.
// - A block is 4 warps x 16 rows = 64 output rows (256 blocks at the train
//   step's (16, 1024, 16), more than the 132 SMs; 128-row blocks would give
//   128). The warp's own operands (q^ and G for K2c, K and V for K2d) are
//   A fragments loaded once from global memory into registers; q^ is formed
//   there: bf16(q * sscale), as the forward forms it.
// - The other side is staged as bf16 through a two-stage ring of BT-row
//   tiles with cp.async (16-byte pieces; rows past N zero-filled by
//   src-size 0; lse2 and delta for K2d by 4-byte pieces), so the next
//   tile's copy overlaps this tile's products. Rows are padded by 16 bytes
//   so that ldmatrix's eight rows fall on distinct banks. B fragments come
//   from ldmatrix: K (K2c) and q^, G (K2d) as stored for S and dP; with
//   .trans for the second products, whose B operand is k-major.
// - K2d scales and rounds the staged raw q in registers after ldmatrix for
//   S^T, and uses the raw tile for dK. It reads lse2 and delta per column of
//   the S^T fragment, from the staged copies.
// - Ragged N is masked in the kernel: p = 0 for keys past N (K2c) and for
//   query rows past N (K2d), whose lse2 and delta are not read; rows of
//   the warp's own side past N read 0 and are not stored.
// - BT = 64 rows for D <= 64 and 32 at D = 128: static shared memory at
//   most 38 KB. A warp holds its fragments, its sums and one 16x16 S/dP
//   chunk in registers. At D = 128 K2d's K and V fragments and dK and dV
//   sums would pass 255 registers, so it sums dv and dk in two sweeps.
// - Only a tile that reaches past N pays for the mask (a second copy of
//   the tile's code); shared addresses are formed once per lane.
// - __launch_bounds__(128, 1): with no minimum of blocks per SM, ptxas kept
//   the d = 16 kernels at 64-78 registers, left the 16-row chunks of a tile
//   in sequence, and spilled at d = 32; with it they take 111-114 registers
//   (4 blocks per SM, more than the 2 that the train step's 256 blocks put
//   on an SM) and overlap the chunks' products, exp2 and loads. ptxas -v
//   reports no spills at any d (chip_smoke.py phase 8 fails on one).
// - Operands must be 16-byte aligned (the wrapper makes them so); the
//   entry returns cudaErrorMisalignedAddress otherwise.
//
// f32, and bf16 at D in {4, 8}: the FMA kernels below. mma on f32 operands
// would be TF32, and the port keeps f32 true f32; D < 16 would have to pad
// the k16 step. As in the forward (flash_attn.cu), 16 threads of a 256-
// thread block share an output row (G split its D dims, S = 16/G split the
// rows of each staged tile; shuffles merge them) and a block owns 16 rows;
// tiles are staged in shared memory as f32, so each FMA reads one operand
// from shared memory: bound by the f32 CUDA-core rate and shared memory.
//
// C interface (bound with ctypes): each entry returns cudaGetLastError()
// after its launch; it launches on the given stream and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "mma_sm80.cuh"

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

// ---- The tensor-core kernels (bf16, D in {16, 32, 64, 128}) ----
// The warp-level helpers (cp.async ring, ldmatrix, mma, load_a, stage)
// are in mma_sm80.cuh, shared with the forward.
namespace tc {

// Stage lse2 and delta of rows [r0, r0 + BT) into a ring slot.
template <int BT>
__device__ __forceinline__ void stage_stats(const float* __restrict__ lse2,
                                            const float* __restrict__ delta,
                                            uint32_t ls, uint32_t dls,
                                            size_t sbase, int r0, int n) {
  static_assert(2 * BT <= THREADS, "one value per thread");
  const int e = threadIdx.x;
  const int r = e % BT;
  const bool ok = r0 + r < n;
  const size_t off = ok ? sbase + r0 + r : 0;
  if (e < BT)
    cp_async4(ls + 4 * r, lse2 + off, ok);
  else if (e < 2 * BT)
    cp_async4(dls + 4 * r, delta + off, ok);
}

// Store a warp's 16 x D f32 sums (times mul) as bf16 rows [r0, r0 + 16).
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           bf16* __restrict__ out,
                                           size_t base, int r0, int n,
                                           float mul) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + lane / 4 + 8 * h;
    if (r >= n) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int col = nt * 8 + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(out + base + static_cast<size_t>(r) * D +
                                   col) =
          pack(acc[nt][2 * h] * mul, acc[nt][2 * h + 1] * mul);
    }
  }
}

// K2c's work on one staged K/V tile (shared addresses kt, vt) of keys
// [k0, k0 + BT). MASK: the tile reaches past N, so p = 0 for keys >= n.
template <int D, bool MASK>
__device__ __forceinline__ void dq_tile(uint32_t kt, uint32_t vt,
                                        const uint32_t (&qa)[D / 16][4],
                                        const uint32_t (&ga)[D / 16][4],
                                        const float (&l2)[2],
                                        const float (&dl)[2],
                                        float (&acc)[D / 8][4], int k0,
                                        int n) {
  using G = Geo<D>;
  constexpr int LD = G::LD;
  const int lane = threadIdx.x % 32;
  const uint32_t on = lane_n_major<LD>();
  const uint32_t ok = lane_k_major<LD>();
#pragma unroll
  for (int j = 0; j < G::CHUNKS; ++j) {
    float s[2][4] = {};
    float dp[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < G::KT; ++kk) {
      uint32_t b[4];
      ldsm(b, kt + on + at<LD>(16 * j, 16 * kk));
      mma(s[0], qa[kk], b[0], b[1]);
      mma(s[1], qa[kk], b[2], b[3]);
      ldsm(b, vt + on + at<LD>(16 * j, 16 * kk));
      mma(dp[0], ga[kk], b[0], b[1]);
      mma(dp[1], ga[kk], b[2], b[3]);
    }
    uint32_t dsa[4];  // dS as the A fragment of dQ += dS K
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int key = k0 + 16 * j + 8 * nt + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = !MASK || key + e < n
                              ? exp2f(s[nt][2 * h + e] - l2[h])
                              : 0.f;
          ds[e] = p * (dp[nt][2 * h + e] - dl[h]);
        }
        dsa[2 * nt + h] = pack(ds[0], ds[1]);
      }
    }
#pragma unroll
    for (int np = 0; np < G::KT; ++np) {
      uint32_t b[4];
      ldsm_trans(b, kt + ok + at<LD>(16 * j, 16 * np));
      mma(acc[2 * np], dsa, b[0], b[1]);
      mma(acc[2 * np + 1], dsa, b[2], b[3]);
    }
  }
}

// K2c: dq for one block of 64 q rows, 16 per warp.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int n, float sscale, float scale) {
  using G = Geo<D>;
  constexpr uint32_t SLOT = G::BT * G::LD * 2;  // bytes per ring slot
  __shared__ __align__(16) bf16 ks[2 * G::BT * G::LD];
  __shared__ __align__(16) bf16 vs[2 * G::BT * G::LD];

  const int lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * ROWS + (threadIdx.x / 32) * 16;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const size_t sbase = static_cast<size_t>(blockIdx.y) * n;
  const int tiles = (n + G::BT - 1) / G::BT;
  const uint32_t ks0 = smem(ks);
  const uint32_t vs0 = smem(vs);

  stage<D>(k, v, ks0, vs0, base, 0, n);
  cp_async_commit();

  uint32_t qa[G::KT][4];
  uint32_t ga[G::KT][4];
  load_a<D, true>(qa, q, base, r0, n, sscale);
  load_a<D, false>(ga, g, base, r0, n, 0.f);
  float l2[2];  // the thread's rows of a C fragment: lane / 4 and + 8
  float dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + lane / 4 + 8 * h;
    l2[h] = r < n ? lse2[sbase + r] : 0.f;
    dl[h] = r < n ? delta[sbase + r] : 0.f;
  }
  float acc[G::NT][4] = {};

  for (int t = 0; t < tiles; ++t) {
    const uint32_t cur = (t % 2) * SLOT;
    if (t + 1 < tiles)
      stage<D>(k, v, ks0 + (SLOT - cur), vs0 + (SLOT - cur), base,
               (t + 1) * G::BT, n);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if ((t + 1) * G::BT <= n)
      dq_tile<D, false>(ks0 + cur, vs0 + cur, qa, ga, l2, dl, acc,
                        t * G::BT, n);
    else
      dq_tile<D, true>(ks0 + cur, vs0 + cur, qa, ga, l2, dl, acc, t * G::BT,
                       n);
    __syncthreads();
  }
  store_rows<D>(acc, dq, base, r0, n, scale);
}

// K2d's work on one staged Q/G tile (shared addresses qt, gt; lse2 and
// delta at lt, dlt) of query rows [q0, q0 + BT): S^T and dP^T, then dv
// (DV) and dk (DK). MASK: the tile reaches past N, so p = 0 for query rows
// >= n.
template <int D, bool DV, bool DK, bool MASK>
__device__ __forceinline__ void dkv_tile(
    uint32_t qt, uint32_t gt, const float* lt, const float* dlt,
    const uint32_t (&ka)[D / 16][4], const uint32_t (&va)[DK ? D / 16 : 1][4],
    float (&dka)[DK ? D / 8 : 1][4], float (&dva)[DV ? D / 8 : 1][4],
    int q0, int n, float sscale) {
  using G = Geo<D>;
  constexpr int LD = G::LD;
  const int lane = threadIdx.x % 32;
  const uint32_t on = lane_n_major<LD>();
  const uint32_t ok = lane_k_major<LD>();
#pragma unroll
  for (int j = 0; j < G::CHUNKS; ++j) {
    float s[2][4] = {};  // S^T: 16 keys x 16 queries
    float dp[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < G::KT; ++kk) {
      uint32_t b[4];
      ldsm(b, qt + on + at<LD>(16 * j, 16 * kk));
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = scale2(b[i], sscale);
      mma(s[0], ka[kk], b[0], b[1]);
      mma(s[1], ka[kk], b[2], b[3]);
      if constexpr (DK) {
        ldsm(b, gt + on + at<LD>(16 * j, 16 * kk));
        mma(dp[0], va[kk], b[0], b[1]);
        mma(dp[1], va[kk], b[2], b[3]);
      }
    }
    uint32_t pa[4];   // P^T (bf16) as the A fragment of dV += P^T G
    uint32_t dsa[4];  // dS^T as the A fragment of dK += dS^T Q
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      // the thread's two query columns of this n8 tile
      const int col = 16 * j + 8 * nt + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(lt + col);
      const float2 dl = *reinterpret_cast<const float2*>(dlt + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = !MASK || q0 + col < n
                             ? exp2f(s[nt][2 * h] - l2.x)
                             : 0.f;
        const float p1 = !MASK || q0 + col + 1 < n
                             ? exp2f(s[nt][2 * h + 1] - l2.y)
                             : 0.f;
        pa[2 * nt + h] = pack(p0, p1);
        dsa[2 * nt + h] = pack(p0 * (dp[nt][2 * h] - dl.x),
                               p1 * (dp[nt][2 * h + 1] - dl.y));
      }
    }
#pragma unroll
    for (int np = 0; np < G::KT; ++np) {
      uint32_t b[4];
      if constexpr (DV) {
        ldsm_trans(b, gt + ok + at<LD>(16 * j, 16 * np));
        mma(dva[2 * np], pa, b[0], b[1]);
        mma(dva[2 * np + 1], pa, b[2], b[3]);
      }
      if constexpr (DK) {
        ldsm_trans(b, qt + ok + at<LD>(16 * j, 16 * np));
        mma(dka[2 * np], dsa, b[0], b[1]);
        mma(dka[2 * np + 1], dsa, b[2], b[3]);
      }
    }
  }
}

// One sweep of K2d over the q tiles for a warp's 16 k rows: dv (DV) and
// dk (DK) summed in registers and stored at the end. qs/gs hold two ring
// slots of BT rows each, ls/dls two slots of BT values.
template <int D, bool DV, bool DK>
__device__ __forceinline__ void dkv_sweep(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int n, float sscale,
    float scale, bf16* qs, bf16* gs, float* ls, float* dls) {
  using G = Geo<D>;
  constexpr uint32_t SLOT = G::BT * G::LD * 2;  // bytes per ring slot
  const int r0 = blockIdx.x * ROWS + (threadIdx.x / 32) * 16;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const size_t sbase = static_cast<size_t>(blockIdx.y) * n;
  const int tiles = (n + G::BT - 1) / G::BT;
  const uint32_t qs0 = smem(qs);
  const uint32_t gs0 = smem(gs);
  const uint32_t ls0 = smem(ls);
  const uint32_t dls0 = smem(dls);

  stage<D>(q, g, qs0, gs0, base, 0, n);
  stage_stats<G::BT>(lse2, delta, ls0, dls0, sbase, 0, n);
  cp_async_commit();

  uint32_t ka[G::KT][4];
  uint32_t va[DK ? G::KT : 1][4];
  load_a<D, false>(ka, k, base, r0, n, 0.f);
  if constexpr (DK) load_a<D, false>(va, v, base, r0, n, 0.f);
  float dka[DK ? G::NT : 1][4] = {};
  float dva[DV ? G::NT : 1][4] = {};

  for (int t = 0; t < tiles; ++t) {
    const int slot = t % 2;
    if (t + 1 < tiles) {
      const int nxt = slot ^ 1;
      stage<D>(q, g, qs0 + nxt * SLOT, gs0 + nxt * SLOT, base,
               (t + 1) * G::BT, n);
      stage_stats<G::BT>(lse2, delta, ls0 + nxt * G::BT * 4,
                         dls0 + nxt * G::BT * 4, sbase, (t + 1) * G::BT, n);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const uint32_t qt = qs0 + slot * SLOT;
    const uint32_t gt = gs0 + slot * SLOT;
    const float* lt = ls + slot * G::BT;
    const float* dlt = dls + slot * G::BT;
    if ((t + 1) * G::BT <= n)
      dkv_tile<D, DV, DK, false>(qt, gt, lt, dlt, ka, va, dka, dva,
                                 t * G::BT, n, sscale);
    else
      dkv_tile<D, DV, DK, true>(qt, gt, lt, dlt, ka, va, dka, dva, t * G::BT,
                                n, sscale);
    __syncthreads();
  }
  if constexpr (DK) store_rows<D>(dka, dk, base, r0, n, scale);
  if constexpr (DV) store_rows<D>(dva, dv, base, r0, n, 1.f);
}

// K2d: dk and dv for one block of 64 k rows, 16 per warp. At D = 128 the
// two sums and the K and V fragments would need more than 255 registers
// (ptxas spilled), so dv and dk are summed in two sweeps there (S^T is
// formed twice).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse2,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int n, float sscale,
                     float scale) {
  using G = Geo<D>;
  __shared__ __align__(16) bf16 qs[2 * G::BT * G::LD];
  __shared__ __align__(16) bf16 gs[2 * G::BT * G::LD];
  __shared__ __align__(16) float ls[2 * G::BT];
  __shared__ __align__(16) float dls[2 * G::BT];
  if constexpr (D <= 64) {
    dkv_sweep<D, true, true>(q, k, v, g, lse2, delta, dk, dv, n, sscale,
                             scale, qs, gs, ls, dls);
  } else {
    dkv_sweep<D, true, false>(q, k, v, g, lse2, delta, dk, dv, n, sscale,
                              scale, qs, gs, ls, dls);
    dkv_sweep<D, false, true>(q, k, v, g, lse2, delta, dk, dv, n, sscale,
                              scale, qs, gs, ls, dls);
  }
}

}  // namespace tc

struct Args {
  int b, n;
  const void *q, *k, *v, *g;
  const float *lse2, *delta;
  void *dq, *dk, *dv;
  float sscale, scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_tc(const Args& a, bool dkv) {
  using tc::bf16;
  const void* ptrs[] = {a.q, a.k, a.v, a.g, dkv ? a.dk : a.dq,
                        dkv ? a.dv : a.dq};
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;
  }
  const dim3 grid((a.n + tc::ROWS - 1) / tc::ROWS, a.b);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* g = static_cast<const bf16*>(a.g);
  if (dkv) {
    tc::flash_bwd_dkv_tc<D><<<grid, tc::THREADS, 0, a.stream>>>(
        q, k, v, g, a.lse2, a.delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.n, a.sscale, a.scale);
  } else {
    tc::flash_bwd_dq_tc<D><<<grid, tc::THREADS, 0, a.stream>>>(
        q, k, v, g, a.lse2, a.delta, static_cast<bf16*>(a.dq), a.n,
        a.sscale, a.scale);
  }
  return cudaGetLastError();
}

// bf16 at D >= 16 on the tensor cores; the rest on the FMA kernels.
template <int D, typename T>
cudaError_t launch(const Args& a, bool dkv) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && D >= 16) {
    return launch_tc<D>(a, dkv);
  } else {
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
          q, k, v, g, a.lse2, a.delta, static_cast<T*>(a.dq), a.n,
          a.sscale, a.scale);
    }
    return cudaGetLastError();
  }
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

// Blocks per SM of the tensor-core kernel for head dim d (16, 32, 64 or
// 128): K2c when dkv is 0, K2d otherwise; -1 for another d.
extern "C" int bla_flash_bwd_tc_blocks_per_sm(int d, int dkv) {
  int blocks = -1;
  auto query = [&](auto kernel) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                  tc::THREADS, 0);
  };
  switch (d) {
    case 16:
      dkv ? query(tc::flash_bwd_dkv_tc<16>) : query(tc::flash_bwd_dq_tc<16>);
      break;
    case 32:
      dkv ? query(tc::flash_bwd_dkv_tc<32>) : query(tc::flash_bwd_dq_tc<32>);
      break;
    case 64:
      dkv ? query(tc::flash_bwd_dkv_tc<64>) : query(tc::flash_bwd_dq_tc<64>);
      break;
    case 128:
      dkv ? query(tc::flash_bwd_dkv_tc<128>)
          : query(tc::flash_bwd_dq_tc<128>);
      break;
    default:
      break;
  }
  return blocks;
}

extern "C" const char* bla_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K3a: the fused flash-attention backward (dq, dk and dv in one pass), for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of big_linear_algebra_tpu/nn/attention.py that
// the JAX package's backward runs with stream=False while its row-resident
// operands fit the VMEM budget (_flash_bwd_padded, launched at :712):
//   _flash_bwd_fused_kernel (:178) -> flash_bwd_fused_tc (bf16, D >= 16)
//     or flash_bwd_fused_kernel, then flash_bwd_dq_reduce_kernel where
//     partial sums of dq remain
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
// order, so nothing can carry dq from one block to the next.
//
// bf16, D in {16, 32, 64, 128}: the tensor-core kernel (namespace tc), K2d's
// (flash_attn_bwd.cu, flash_bwd_dkv_tc) with each query tile's share of dq
// added.
// - One block of 4 warps per (batch, 64 key rows), 16 rows a warp; K and V
//   held as A fragments in registers; q and g (with lse2 and delta) staged
//   through a two-slot cp.async ring of BT query rows (64; 32 at D = 128).
//   Per 16-query chunk, on mma.sync.m16n8k16: S^T = K q^^T and dP^T =
//   V G^T; P^T and dS^T packed into A fragments (the plain version's bf16
//   rounding); dV += P^T G and dK += dS^T Q, summed in registers.
// - dS^T (bf16, already rounded) also goes to shared memory. After the
//   tile, the block's share of dq, dQ = dS K over its 64 keys, is one more
//   mma.sync product: A from dS^T by ldmatrix.trans, B from the block's
//   keys, staged once in shared memory; each warp a 16 x D (16 x 64 at
//   D = 128) piece, written as f32 into a ring of three shares.
// - The shares are summed across a thread-block cluster of consecutive key
//   blocks of one batch element (16 blocks, a non-portable size, where the
//   card holds such a cluster, else 8), which walk the query tiles in
//   lockstep: after each tile every rank arrives at a split cluster
//   barrier; after the next tile's products it waits, then sums its slice
//   of the previous tile's rows over the ranks in rank order through
//   distributed shared memory. The wait overlaps the products, and the
//   ring of three shares keeps a rank from overwriting a share another
//   rank still reads. Where one cluster covers all N keys (N <= 1024 with
//   16-block clusters) it writes dq itself, scaled, in bf16; else each
//   cluster writes its f32 sum into its own workspace slot (ceil(N/64) /
//   cluster size slots of B x N x D) and the reduce kernel below sums the
//   slots in slot order. No atomics: two runs are bit-equal.
// - At D = 128 the K and V fragments and the dk and dv sums would pass 255
//   registers in one sweep, as in K2d, so dv is summed in a first sweep
//   and dk and dq in a second (S^T is formed twice).
// - Operands must be 16-byte aligned (the wrapper makes them so); the
//   entry returns cudaErrorMisalignedAddress otherwise.
//
// f32, and bf16 at D in {4, 8}: the FMA kernel (flash_bwd_fused_kernel).
// - One block of 256 threads per (batch, tile of BT key rows), BT = 64 (32
//   at D = 128). It stages its keys and values once, then walks the query
//   tiles: it stages BT rows of q (as given, and scaled and rounded as the
//   forward has it), g, lse2 and delta, forms the BT x BT tiles of
//   round_to_input(p) and ds in shared memory (each thread a 4x4 (2x2)
//   tile of scores), and from them adds to its keys' dk and dv (registers,
//   BT*D/256 of each per thread) and forms the query tile's share of dq.
// - The share of dq is written, unscaled, to an f32 workspace slot
//   (key tile, B, N, D): ceil(N/BT) * B * N * D * 4 bytes. The reduce
//   kernel sums the slots in key-tile order and applies the scale.
// - Shared rows are padded to an odd stride so that the 16 key rows a warp
//   reads fall in distinct banks.
//
// Both: rounding points as K2c/K2d. The scores are recomputed from q scaled
// and rounded to the input type, as the forward formed them, so p <= 1
// against the forward's lse (the Pallas kernel scales the unrounded f32
// score, which overflows p in bf16 once |s| nears 1e5); ds is rounded to
// the input type before its products, p before the dv product. Ragged N is
// masked in the kernels (staged rows past N read 0, their p is 0, their lse
// and delta are not read): no padding copy.
//
// What bounds it on the H100: per score one exp2 and five D-long products
// (s, dp, dv, dk, dq: 10*D flops). At the U-Net's D = 16 it is bound by
// exp2 (16 per clock per SM) in bf16; at D = 64 by the bf16 tensor-core
// rate, of which mma.sync reaches a part (wgmma is the next step). Beyond
// the function's own work, dq's shares move ceil(N/64) * B * N * D * 4
// bytes between SMs (the bytes the first version's workspace moved through
// device memory), and each query tile ends on a cluster barrier. The f32
// kernel runs every product as an FMA on the CUDA cores out of shared
// memory and reads and writes its workspace through L2 and device memory.
// The tensor-core kernel keeps its own copies of K2d's helpers
// (stage_stats, store_rows and the tile body, fused_tile here).
//
// C interface (bound with ctypes): bla_flash_bwd_fused returns the first
// CUDA error of its launches (cudaGetLastError() after each); it launches
// on the given stream and never synchronises. bla_flash_bwd_fused_slots
// gives the workspace's slot count for an input type, N and d.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma_sm80.cuh"

namespace cg = cooperative_groups;

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

// ---- The tensor-core kernel (bf16, D in {16, 32, 64, 128}) ----
// K2d's kernel (flash_attn_bwd.cu, flash_bwd_dkv_tc) with the query tile's
// share of dq added; the warp-level helpers are in mma_sm80.cuh.
namespace tc {

// K3a's shared memory: K2d's ring of q/g tiles and their lse2/delta, then
// the block's keys (dQ's B operand), dS^T of the current query tile, and a
// ring of three dq shares (f32) for the cluster's sum.
template <int D>
struct Fused {
  using G = Geo<D>;
  static constexpr int BT = G::BT;           // query rows per tile
  static constexpr int LD = G::LD;
  static constexpr int LDS = BT + 8;         // dS^T row stride (bf16)
  static constexpr int RG = BT / 16;         // 16-row groups of a tile
  static constexpr int DW = D * RG / WARPS;  // dq columns per warp
  static constexpr int LDQ = D + 4;          // share row stride (f32)
  static constexpr int SHARE = BT * LDQ;      // floats of one share
  static constexpr int SHARES = 3;
  static constexpr int RING = 2 * BT * LD * 2;
  static constexpr int OFF_G = RING;
  static constexpr int OFF_L = 2 * RING;
  static constexpr int OFF_DL = OFF_L + 2 * BT * 4;
  static constexpr int OFF_K = OFF_DL + 2 * BT * 4;
  static constexpr int OFF_DS = OFF_K + ROWS * LD * 2;
  static constexpr int OFF_SH = OFF_DS + ROWS * LDS * 2;
  static constexpr int SMEM = OFF_SH + SHARES * SHARE * 4;
  static_assert(DW % 16 == 0 && OFF_SH % 16 == 0, "unsupported head dim");
};

// Split cluster barrier: arrive publishes this thread's shared-memory
// writes (release); wait returns once every thread of the cluster has
// arrived (acquire). Each wait follows one arrive.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

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

// Stage the block's ROWS keys [k0, k0 + ROWS) (rows past n read 0).
template <int D>
__device__ __forceinline__ void stage_keys(const bf16* __restrict__ k,
                                           uint32_t ks, size_t base, int k0,
                                           int n) {
  using G = Geo<D>;
  for (int e = threadIdx.x; e < ROWS * G::CPR; e += THREADS) {
    const int r = e / G::CPR;
    const int c = (e % G::CPR) * 8;
    const bool ok = k0 + r < n;
    const size_t off = ok ? base + static_cast<size_t>(k0 + r) * D + c : 0;
    cp_async16(ks + at<G::LD>(r, c), k + off, ok);
  }
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

// K2d's work on one staged Q/G tile (shared addresses qt, gt; lse2 and
// delta at lt, dlt) of query rows [q0, q0 + BT): S^T and dP^T, then dv
// (DV) and dk (DK); with DK, dS^T (bf16, the rounding of the plain
// version) is also stored at dst, rows = the block's keys, for dq. MASK:
// the tile reaches past N, so p = 0 for query rows >= n.
template <int D, bool DV, bool DK, bool MASK>
__device__ __forceinline__ void fused_tile(
    uint32_t qt, uint32_t gt, const float* lt, const float* dlt, uint32_t dst,
    const uint32_t (&ka)[D / 16][4], const uint32_t (&va)[DK ? D / 16 : 1][4],
    float (&dka)[DK ? D / 8 : 1][4], float (&dva)[DV ? D / 8 : 1][4],
    int q0, int n, float sscale) {
  using G = Geo<D>;
  constexpr int LD = G::LD;
  constexpr int LDS = Fused<D>::LDS;
  const int lane = threadIdx.x % 32;
  const uint32_t on = lane_n_major<LD>();
  const uint32_t ok = lane_k_major<LD>();
  const uint32_t ds_lane =
      dst + (((threadIdx.x / 32) * 16 + lane / 4) * LDS + 2 * (lane % 4)) * 2;
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
    if constexpr (DK) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                           ds_lane + (8 * h * LDS + 16 * j + 8 * nt) * 2),
                       "r"(dsa[2 * nt + h])
                       : "memory");
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

// The warp's piece of this block's dq share for a query tile, dQ = dS K
// over the block's ROWS keys: rows 16 * (warp % RG) of the tile, columns
// DW * (warp / RG); A from dS^T by ldmatrix.trans, B from the staged keys.
// Written as f32 into sh (the tile's BT rows of a share, row stride LDQ).
template <int D>
__device__ __forceinline__ void dq_share(uint32_t ds, uint32_t ks,
                                         float* sh) {
  using Fu = Fused<D>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rg = warp % Fu::RG;
  const int cgp = warp / Fu::RG;
  const uint32_t on = lane_n_major<Fu::LDS>();
  const uint32_t ok = lane_k_major<Fu::LD>();
  float acc[Fu::DW / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk) {
    uint32_t a[4];
    ldsm_trans(a, ds + on + at<Fu::LDS>(16 * kk, 16 * rg));
#pragma unroll
    for (int np = 0; np < Fu::DW / 16; ++np) {
      uint32_t b[4];
      ldsm_trans(b, ks + ok + at<Fu::LD>(16 * kk, cgp * Fu::DW + 16 * np));
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < Fu::DW / 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(
          &sh[(16 * rg + lane / 4 + 8 * h) * Fu::LDQ + cgp * Fu::DW + nt * 8 +
              2 * (lane % 4)]) =
          make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
}

// This rank's slice of a query tile's dq (rows from q0): the shares of the
// cluster's ranks summed in rank order (distributed shared memory),
// then dq = scale * sum in bf16, or, where the cluster does not cover all
// N keys, the unscaled f32 sum into the cluster's workspace slot.
template <int D>
__device__ __forceinline__ void dq_reduce(cg::cluster_group& cluster,
                                          float* sh, bf16* __restrict__ dq,
                                          float* __restrict__ slot,
                                          size_t base, int q0, int n,
                                          float scale) {
  using Fu = Fused<D>;
  constexpr int E = Fu::BT * D;
  constexpr int MAX_CLUSTER = 16;
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int e_end = (rank + 1) * E / cs;
  for (int e = rank * E / cs + threadIdx.x; e < e_end; e += THREADS) {
    const int row = e / D;
    const int col = e % D;
    if (q0 + row >= n) break;
    const int off = row * Fu::LDQ + col;
    float part[MAX_CLUSTER];  // all remote loads in flight at once
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < cs) part[r] = cluster.map_shared_rank(sh, r)[off];
    float sum = part[0];
#pragma unroll
    for (int r = 1; r < MAX_CLUSTER; ++r)
      if (r < cs) sum += part[r];
    const size_t idx = base + static_cast<size_t>(q0 + row) * D + col;
    if (slot != nullptr)
      slot[idx] = sum;
    else
      dq[idx] = __float2bfloat16(sum * scale);
  }
}

// One sweep over the q tiles for a warp's 16 k rows: dv (DV) and dk (DK)
// summed in registers and stored at the end; with DK, also the tiles' dq
// (each tile's share summed over the cluster after the next tile's
// products, so the barrier's wait overlaps them).
template <int D, bool DV, bool DK>
__device__ __forceinline__ void fused_sweep(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    float* __restrict__ ws, bf16* __restrict__ dq, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int n, float sscale, float scale,
    unsigned char* sm) {
  using G = Geo<D>;
  using Fu = Fused<D>;
  constexpr uint32_t SLOT = G::BT * G::LD * 2;  // bytes per ring slot
  cg::cluster_group cluster = cg::this_cluster();
  const int k0 = blockIdx.x * ROWS;
  const int r0 = k0 + (threadIdx.x / 32) * 16;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  const size_t sbase = static_cast<size_t>(blockIdx.y) * n;
  const int tiles = (n + G::BT - 1) / G::BT;
  const uint32_t s0 = smem(sm);
  const uint32_t qs0 = s0;
  const uint32_t gs0 = s0 + Fu::OFF_G;
  const uint32_t ls0 = s0 + Fu::OFF_L;
  const uint32_t dls0 = s0 + Fu::OFF_DL;
  const uint32_t ks0 = s0 + Fu::OFF_K;
  const uint32_t ds0 = s0 + Fu::OFF_DS;
  const float* ls = reinterpret_cast<const float*>(sm + Fu::OFF_L);
  const float* dls = reinterpret_cast<const float*>(sm + Fu::OFF_DL);
  float* sh = reinterpret_cast<float*>(sm + Fu::OFF_SH);
  // this cluster's workspace slot, (B, N, D); none if it covers all keys
  float* slot = ws == nullptr
                    ? nullptr
                    : ws + static_cast<size_t>(blockIdx.x /
                                               cluster.num_blocks()) *
                               gridDim.y * n * D;

  stage<D>(q, g, qs0, gs0, base, 0, n);
  stage_stats<G::BT>(lse2, delta, ls0, dls0, sbase, 0, n);
  if constexpr (DK) stage_keys<D>(k, ks0, base, k0, n);
  cp_async_commit();

  uint32_t ka[G::KT][4];
  uint32_t va[DK ? G::KT : 1][4];
  load_a<D, false>(ka, k, base, r0, n, 0.f);
  if constexpr (DK) load_a<D, false>(va, v, base, r0, n, 0.f);
  float dka[DK ? G::NT : 1][4] = {};
  float dva[DV ? G::NT : 1][4] = {};

  for (int t = 0; t < tiles; ++t) {
    const int cur = t % 2;
    if (t + 1 < tiles) {
      const int nxt = cur ^ 1;
      stage<D>(q, g, qs0 + nxt * SLOT, gs0 + nxt * SLOT, base,
               (t + 1) * G::BT, n);
      stage_stats<G::BT>(lse2, delta, ls0 + nxt * G::BT * 4,
                         dls0 + nxt * G::BT * 4, sbase, (t + 1) * G::BT, n);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const uint32_t qt = qs0 + cur * SLOT;
    const uint32_t gt = gs0 + cur * SLOT;
    const float* lt = ls + cur * G::BT;
    const float* dlt = dls + cur * G::BT;
    if ((t + 1) * G::BT <= n)
      fused_tile<D, DV, DK, false>(qt, gt, lt, dlt, ds0, ka, va, dka, dva,
                                   t * G::BT, n, sscale);
    else
      fused_tile<D, DV, DK, true>(qt, gt, lt, dlt, ds0, ka, va, dka, dva,
                                  t * G::BT, n, sscale);
    if constexpr (DK) {
      __syncthreads();  // dS^T of all four warps
      dq_share<D>(ds0, ks0, sh + (t % Fu::SHARES) * Fu::SHARE);
      if (t > 0) {
        cluster_wait();
        dq_reduce<D>(cluster, sh + ((t - 1) % Fu::SHARES) * Fu::SHARE, dq,
                     slot, base, (t - 1) * G::BT, n, scale);
      }
      cluster_arrive();
    }
    __syncthreads();
  }
  if constexpr (DK) {
    cluster_wait();
    dq_reduce<D>(cluster, sh + ((tiles - 1) % Fu::SHARES) * Fu::SHARE, dq,
                 slot, base, (tiles - 1) * G::BT, n, scale);
    // no block leaves while another may still read its shares
    cluster_arrive();
    cluster_wait();
  }
  if constexpr (DK) store_rows<D>(dka, dk, base, r0, n, scale);
  if constexpr (DV) store_rows<D>(dva, dv, base, r0, n, 1.f);
}

// K3a: dk, dv and dq for one block of 64 k rows, 16 per warp. At D = 128
// the sums would pass 255 registers in one sweep (as in K2d), so dv is
// summed in a first sweep and dk and dq in a second (S^T formed twice).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_fused_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ g,
                       const float* __restrict__ lse2,
                       const float* __restrict__ delta, float* __restrict__ ws,
                       bf16* __restrict__ dq, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int n, float sscale,
                       float scale) {
  extern __shared__ __align__(16) unsigned char sm[];
  if constexpr (D <= 64) {
    fused_sweep<D, true, true>(q, k, v, g, lse2, delta, ws, dq, dk, dv, n,
                               sscale, scale, sm);
  } else {
    fused_sweep<D, true, false>(q, k, v, g, lse2, delta, ws, dq, dk, dv, n,
                                sscale, scale, sm);
    fused_sweep<D, false, true>(q, k, v, g, lse2, delta, ws, dq, dk, dv, n,
                                sscale, scale, sm);
  }
}

}  // namespace tc

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

// The tensor-core kernel's cluster size limit: 16 blocks (a non-portable
// size) where the card holds such a cluster of it, else 8. Also raises the
// kernel's dynamic shared memory limit. Once per head dim.
template <int D>
int max_cluster() {
  static const int cs = [] {
    const auto kernel = tc::flash_bwd_fused_tc<D>;
    constexpr int smem = tc::Fused<D>::SMEM;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess ||
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) != cudaSuccess) {
      cudaGetLastError();
      return 8;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(16, 1, 1);
    cfg.blockDim = dim3(tc::THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 16;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) !=
        cudaSuccess) {
      cudaGetLastError();
      return 8;
    }
    return clusters > 0 ? 16 : 8;
  }();
  return cs;
}

// The tensor-core kernel's plan for n keys: blocks of ROWS keys in
// clusters of cs consecutive blocks; slots = the clusters per batch
// element where more than one (each sums into its own workspace slot, a
// second kernel sums the slots), else 0 (the cluster writes dq).
template <int D>
void tc_plan(int n, int& cs, int& clusters) {
  const int blocks = (n + tc::ROWS - 1) / tc::ROWS;
  const int limit = max_cluster<D>();
  cs = blocks < limit ? blocks : limit;
  clusters = (blocks + cs - 1) / cs;
}

template <int D>
int slots(int n, bool tc_path) {
  if constexpr (D >= 16) {
    if (tc_path) {
      int cs, clusters;
      tc_plan<D>(n, cs, clusters);
      return clusters > 1 ? clusters : 0;
    }
  }
  return tiles<D>(n);
}

template <int D>
cudaError_t launch_tc(const Args& a) {
  using tc::bf16;
  const void* ptrs[] = {a.q, a.k, a.v, a.g, a.dq, a.dk, a.dv};
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;
  }
  int cs, clusters;
  tc_plan<D>(a.n, cs, clusters);
  if (clusters > 1 && a.ws == nullptr) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cs, a.b, 1);
  cfg.blockDim = dim3(tc::THREADS, 1, 1);
  cfg.dynamicSmemBytes = tc::Fused<D>::SMEM;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, tc::flash_bwd_fused_tc<D>, static_cast<const bf16*>(a.q),
      static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.g), a.lse2, a.delta,
      clusters > 1 ? a.ws : nullptr, static_cast<bf16*>(a.dq),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.n, a.sscale,
      a.scale);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || clusters == 1) return err;
  const size_t count = static_cast<size_t>(a.b) * a.n * D;
  const size_t blocks = (count + REDUCE_THREADS - 1) / REDUCE_THREADS;
  flash_bwd_dq_reduce_kernel<bf16>
      <<<static_cast<unsigned>(blocks), REDUCE_THREADS, 0, a.stream>>>(
          a.ws, static_cast<bf16*>(a.dq), clusters, count, a.scale);
  return cudaGetLastError();
}

// bf16 at D >= 16 on the tensor cores; the rest on the FMA kernel.
template <int D, typename T>
cudaError_t launch(const Args& a) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && D >= 16) {
    return launch_tc<D>(a);
  } else {
    constexpr size_t smem = Tiles<D>::SMEM_FLOATS * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_fused_kernel<D, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(tiles<D>(a.n), a.b);
    flash_bwd_fused_kernel<D, T><<<grid, THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse2,
        a.delta, a.ws, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.n,
        a.sscale, a.scale);
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

// Workspace slots of (B, N, d) f32 that bla_flash_bwd_fused needs for input
// type dtype (0 f32, 1 bf16), n keys and head dim d: 0 where none; -1 for
// another d.
extern "C" int bla_flash_bwd_fused_slots(int dtype, int n, int d) {
  const bool tc_path = dtype == kBF16;
  switch (d) {
    case 4:
      return slots<4>(n, false);
    case 8:
      return slots<8>(n, false);
    case 16:
      return slots<16>(n, tc_path);
    case 32:
      return slots<32>(n, tc_path);
    case 64:
      return slots<64>(n, tc_path);
    case 128:
      return slots<128>(n, tc_path);
    default:
      return -1;
  }
}

// Blocks per SM of the tensor-core kernel for head dim d (16, 32, 64 or
// 128), and its cluster size limit in *cluster; -1 for another d.
extern "C" int bla_flash_bwd_fused_tc_blocks_per_sm(int d, int* cluster) {
  int blocks = -1;
  auto query = [&](auto kernel, int smem, int cs) {
    *cluster = cs;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                  tc::THREADS, smem);
  };
  switch (d) {
    case 16:
      query(tc::flash_bwd_fused_tc<16>, tc::Fused<16>::SMEM,
            max_cluster<16>());
      break;
    case 32:
      query(tc::flash_bwd_fused_tc<32>, tc::Fused<32>::SMEM,
            max_cluster<32>());
      break;
    case 64:
      query(tc::flash_bwd_fused_tc<64>, tc::Fused<64>::SMEM,
            max_cluster<64>());
      break;
    case 128:
      query(tc::flash_bwd_fused_tc<128>, tc::Fused<128>::SMEM,
            max_cluster<128>());
      break;
    default:
      break;
  }
  return blocks;
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

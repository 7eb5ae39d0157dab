// K5a and K5b on the tensor cores: the bf16 forward and recompute backward
// of the U-Net's fused resnet block, for NVIDIA Hopper (sm_90a).
//
// Replaces, for bf16 operands, the TPU kernels of
// big_linear_algebra_tpu/nn/fused_block.py:
//   _fused_fwd_kernel (K5a, launched at :396 by _frb_fwd) -> fused_block_fwd_tc
//   _fused_bwd_kernel (K5b, launched at :441 by _frb_bwd) ->
//     fused_block_bwd_tc (data gradients), then fused_block_wgrad_tc
//     (weight gradients); see "K5b" below
// The block, per example, on x (C, HW), td (F), w1 (F, C, 3, 3),
// w2 (F, F, 3, 3) and w3 (F, C, 1, 1) or none (C == F):
//   a1  = bf16(relu(gn(x)))             gn: one-pass f32 statistics per group
//   h1t = conv(a1, w1) + td              "same" zero padding, f32 sums
//   d   = bf16(dropout(relu(gn(h1t))))
//   out = bf16(conv(d, w2) + (w3 ? w3 . x : x))
// with var = max(E[x^2] - mean^2, 0), rstd = rsqrt(var + eps). Dropout keeps
// element i of the packed (F, B*HW) layout iff fmix32(i * 0x9E3779B1 ^
// fmix32(seed)) >= thresh and scales it by `scale`: the hash of
// fused_block.cu, so that K5b regenerates the mask. The plain PyTorch version
// is _plain_fused_fwd in nn/fused_block.py. It takes 3x3 convs on 8x8 and
// 4x4 maps with channels and group size powers of two (every full-width
// U-Net block); f32 operands, and bf16 shapes it does not take, go to
// fused_block.cu's FMA kernel by the wrapper's rule (_fwd_route). A launch
// failure raises.
//
// Design.
// - One thread-block cluster per example, of nc blocks: 16 (a non-portable
//   size) at B <= SMALL_BATCH, else 8, so that the sampler's single example
//   spreads over 16 SMs and the train step's 16 examples fit one wave at two
//   blocks an SM. Block r owns output channels [r*mb, (r+1)*mb), mb = F / nc
//   (16 or 32 at F = 256), within one GN group (mb <= group size). The map's
//   geometry is fixed per instantiation (Map<NT>), so that index arithmetic
//   is shifts and masks.
// - Each conv is an implicit GEMM, M = mb output channels, N = H*W tokens
//   (64 or 16), K = 9 * C_in, on mma.sync m16n8k16 in bf16 with f32 sums.
//   Warp (wm, wk) of the 8 owns m16 tile wm, all the tokens, and every
//   nwk-th k16 step (nwk = 8 / (mb / 16)); the warps' partial tiles are
//   summed in warp order in shared memory.
// - The conv input lives in shared memory as bf16, channel-last, with a zero
//   halo: (H+2)(W+2) rows of max(C, F) + 8 channels (the 16 bytes of padding
//   put ldmatrix's 8 rows on distinct banks). A tap is a fixed row offset,
//   and the B fragments are ldmatrix.x4 of 16-byte runs of 8 channels.
// - The weights stream from the stored (F, C, 3, 3) tensor through a
//   three-slot cp.async ring: a chunk is the block's mb rows of CHUNK input
//   channels x 9 taps, 576 contiguous bytes a row; two chunks are in flight
//   while one chunk's products run. The ring keeps the stored order, so an A
//   fragment's channel pairs (9 elements apart) are read as 16-bit loads and
//   packed: the transposition is in the loads, and no repacked copy exists.
//   The row stride RING_ROW puts a warp's 32 such loads on distinct banks.
//   Each block first starts its loads of x, then asks L2 to prefetch its
//   rows of w1, w2 and w3 (cp.async.bulk.prefetch) and starts the ring, so
//   that these overlap.
// - GN 1's statistics: every block sums the whole example, which its conv
//   input holds anyway, in 16-byte pieces. GN 2's: each block sums its
//   channels while it adds up the warps' partial tiles; at mb = 16 a group
//   of 32 channels spans two blocks, which add the two sums through
//   distributed shared memory in rank order after a cluster barrier (both
//   get the same statistics).
// - d moves through distributed shared memory: each block computes its bf16
//   slice in registers and, after a cluster barrier (every block done with
//   its conv input), stores it into every rank's conv input, channel-last;
//   a second barrier publishes the stores. No global workspace and no
//   __threadfence.
// - The 1x1 residual w3 . x runs after conv_2 on the same ring and fragments
//   (x reloaded into the conv input), into conv_2's sums; an identity
//   residual is copied from the conv input before GN 1 into a small buffer
//   that the epilogue reads.
// - Fixed sum orders and no atomics: two runs are bit-equal.
//
// What bounds it on the H100: 2 * B * HW * F * 9 * (C + F) flops, 2.4 GFLOP
// at the train step's (16, 256, 256, 8x8), 2.4 us at the bf16 peak; and each
// cluster reads its example's weights (2.36 MB at C = F = 256) through L2,
// 38 MB at B = 16. Neither sets the pace at these sizes: a block runs a
// chain of short phases, each bound by latency (tools/k5a_phases.py times
// them apart; PERF.md). The two convs' chunk loops take about half of it
// (about 0.2 us a chunk to start the next copies and pass the barrier,
// besides the products), the all-to-all of d through distributed shared
// memory about a tenth, and at B = 16 the 16th cluster shares its SMs with
// others (15 clusters of 8 fill the card one block an SM). wgmma, larger
// chunks and TMA multicast of the weights across the cluster are the next
// steps.
//
// K5b's data gradients (fused_block_bwd_tc), per example, at the rounding
// points of _plain_fused_bwd, from x, td, g, w1 and the flipped, transposed
// copies w2^T (F, F, 3, 3), w1^T (C, F, 3, 3) and w3^T (C, F) that the
// wrapper makes (as the JAX wrapper's _taps_t), so that conv_2's and conv_1's
// transposes are forward convs on K5a's ring and fragments:
//   a1 = bf16(relu(gn(x)))  (the block's C slice to ws_a1)
//   h1t = conv(a1, w1) + td; d = bf16(dropout(relu(gn(h1t))))  (to ws_d)
//   dd = conv(g, w2^T), through the dropout mask and ReLU 2's, then GN 2's
//     backward: dh1t; d_td = its sum over the tokens, unrounded; dh1t
//     rounded to bf16 (to ws_dh)
//   da1 = conv(dh1t, w1^T), through ReLU 1's mask and GN 1's backward, plus
//     g or w3^T . g: dx
// It leaves a1, d and dh1t of every example in bf16 workspaces for the
// weight gradients (fused_block_wgrad_tc):
//   dw1[f][c][tap] = sum over b, t of dh1t[b][f][t] * a1[b][c][t + shift(tap)]
//   dw2 likewise of g and d, dw3 of g and x (one tap)
// f32 operands, and bf16 shapes the plan does not take, go to
// fused_block.cu's FMA kernels by the wrapper's rule (_bwd_route).
// Design of the data gradients, as K5a's where not said:
// - Clusters of BWD_CLUSTER = 8 blocks per example at every B (no sampling
//   step runs a backward). Block r owns F / 8 channels of h1t, dd and dh1t
//   (mb) and C / 8 of da1 and dx (cb), each whole GN groups, so every GN
//   statistic and every GN-backward sum stays in one block.
// - One weight stream through the ring: w3^T's chunks (with w3), w1's, w2^T's
//   and w1^T's, slots of max(mb, cb) rows. The conv input holds x, then g,
//   then dh1t; dh1t reaches every rank through distributed shared memory, as
//   K5a's d (no global workspace, no __threadfence).
// - The epilogues keep their values in registers: thread tid holds token
//   tid % HW of channels tid / HW + i * TPI, so a pass of the block's threads
//   lies in one GN group; GN 2's x-hat and the dropout's kept bits stay in
//   registers through conv_2^T. w3^T . g is formed first and parked in f32
//   in ws_res, read back by the thread that wrote it.
// - At the train step's blocks: two blocks an SM (110,160 B at C = F = 256,
//   8x8; the 512 -> 256 4x4 block takes 151,648 B, one block an SM, for its
//   64-row slots of w1^T).
// - Fixed sum orders and no atomics: two runs are bit-equal.
// What bounds it: 2 * B * HW * 9 * (2 * C * F + F * F) flops, 3.7 us at the
// bf16 peak at (16, 256, 256, 8x8); as K5a, the chain of short phases and the
// chunk loop's barriers set its pace.
// The weight gradients: each tap is a GEMM, dW_tap = A . shift(X)^T with M =
// F, N = C_in and K = B * HW. A block owns a 32 x 32 tile of (f, c) at every
// tap; each example's rows of A and its channels of X (channel-last with a
// zero halo, so that a tap is a fixed row offset) are staged in shared
// memory while the next example's loads are in flight in registers, and
// the products are mma.sync with A from ldmatrix.x4 and X from
// ldmatrix.x2.trans, summed over the examples in order (no atomics). Bound:
// 2 * B * HW * 9 * (C * F + F * F) flops, 2.4 us at the bf16 peak at the
// train step's 8x8 block; 128-192 blocks fill the card once.
//
// C interface (bound with ctypes): bla_fused_block_fwd_tc,
// bla_fused_block_bwd_tc and bla_fused_block_wgrad_tc return
// cudaGetLastError() (or the launch's error) after their launch, on the
// given stream, and never synchronise; bla_fused_block_tc_info,
// bla_fused_block_bwd_tc_info and bla_fused_block_wgrad_tc_info report the
// plan and the occupancy.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_sm80.cuh"

namespace cg = cooperative_groups;

namespace {

using tc::bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 16;
constexpr int SMALL_BATCH = 4;  // B <= SMALL_BATCH: clusters of 16, else 8
constexpr int CHUNK = 32;       // input channels per staged 3x3 chunk
constexpr int RING_ROW = 296;   // bf16 per staged weight row (9 * CHUNK used)
constexpr int RING_SLOTS = 3;
constexpr int PART_PAD = 4;     // f32 padding of a partial-tile row
constexpr size_t MAX_SMEM = 232448;
constexpr unsigned FULL_MASK = 0xffffffffu;
// A row holds a chunk, 16-byte aligned; a stride of 20 words (mod 32) puts
// the 8 rows x 4 channel pairs of an A fragment's loads on 32 banks.
static_assert(9 * CHUNK <= RING_ROW && RING_ROW % 8 == 0 &&
                  (RING_ROW / 2) % 32 == 20,
              "staged weight row");

struct TcParams {
  int b, c, f, h, w, hw, gsz, nc, mb, ck1;
  int ldc;                           // conv input row stride (bf16)
  int off_ring, off_stats, off_res;  // shared-memory offsets (bytes)
  const bf16 *x, *td, *w1, *w2, *w3;  // w3 may be null
  const int* seed;
  bf16* out;
  int drop;
  uint32_t thresh;
  float scale, eps;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

#ifdef BLA_K5A_STAMPS
// Built with -DBLA_K5A_STAMPS (tools/k5a_phases.py): clock64() at the 12
// phase boundaries, after a block barrier, of the first and the last block.
__device__ long long k5a_stamps[2][12];
#define STAMP(i)                                                          \
  do {                                                                    \
    __syncthreads();                                                      \
    if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0)           \
      k5a_stamps[0][i] = clock64();                                       \
    if (threadIdx.x == 0 && blockIdx.x == gridDim.x - 1 &&                \
        blockIdx.y == gridDim.y - 1)                                      \
      k5a_stamps[1][i] = clock64();                                       \
  } while (0)
#else
#define STAMP(i)
#endif

// Wait until at most RING_SLOTS - 2 committed groups are still in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(RING_SLOTS - 2) : "memory");
}

// Ask L2 to fetch [p, p + bytes) (16-byte aligned, a multiple of 16).
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

__device__ __forceinline__ int ilog2(int v) { return 31 - __clz(v); }

__device__ __forceinline__ uint4 ld16(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void st16(unsigned char* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// The example's map, fixed per instantiation: NT n8 tiles of tokens, square
// (8x8 or 4x4), padded by one on each side in the conv input.
template <int NT>
struct Map {
  static_assert(NT == 8 || NT == 2, "8x8 or 4x4 maps");
  static constexpr int HW = NT * 8;
  static constexpr int W = NT == 8 ? 8 : 4;
  static constexpr int H = HW / W;
  static constexpr int WS = W + 2;              // padded row
  static constexpr int LDP = HW + PART_PAD;     // partial-tile row (f32)
  // the conv input row of token n
  __device__ static __forceinline__ int row(int n) {
    const unsigned u = static_cast<unsigned>(n);
    return static_cast<int>((u / W + 1) * WS + u % W + 1);
  }
};

// Zero channels [0, nch) of the conv input's halo rows: the top and bottom
// padded rows, then the left and right ends of the rows between.
template <int NT>
__device__ void zero_halo(unsigned char* smem, int ldc, int nch) {
  using M = Map<NT>;
  constexpr int ROWS = 2 * M::WS + 2 * M::H;
  const int lp = ilog2(nch / 8);
  for (int e = threadIdx.x; e < (ROWS << lp); e += THREADS) {
    const int i = e >> lp;
    const int pc = e & ((1 << lp) - 1);
    int row;
    if (i < M::WS) {
      row = i;
    } else if (i < 2 * M::WS) {
      row = (M::H + 1) * M::WS + i - M::WS;
    } else {
      const int j = i - 2 * M::WS;
      row = (j / 2 + 1) * M::WS + (j % 2) * (M::WS - 1);
    }
    st16(smem + (row * ldc + pc * 8) * 2, make_uint4(0u, 0u, 0u, 0u));
  }
}

// One example's x (C, HW) into the conv input's interior, channel-last, in
// batches: a unit is 8 tokens of a channel pair, two 16-byte loads written
// as 8 words (one per token); fetch() starts a batch's loads, put() stores
// them, so that other work can run while they are in flight.
template <int NT>
struct XLoader {
  static constexpr int U = 4;  // units a thread has in flight
  uint4 lo[U], hi[U];
  int lpairs, units;

  __device__ __forceinline__ explicit XLoader(int c)
      : lpairs(ilog2(c / 2)), units((c / 2) * (Map<NT>::HW / 8)) {}

  __device__ __forceinline__ void fetch(const bf16* __restrict__ x, int u0) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = u0 + i * THREADS;
      lo[i] = hi[i] = make_uint4(0u, 0u, 0u, 0u);
      if (u < units) {
        const int cp = u & ((1 << lpairs) - 1);
        const bf16* src = x + (2 * cp) * Map<NT>::HW + (u >> lpairs) * 8;
        lo[i] = __ldg(reinterpret_cast<const uint4*>(src));
        hi[i] = __ldg(reinterpret_cast<const uint4*>(src + Map<NT>::HW));
      }
    }
  }

  __device__ __forceinline__ void put(unsigned char* smem, int ldc, int u0) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = u0 + i * THREADS;
      if (u < units) {
        const int cp = u & ((1 << lpairs) - 1);
        const int n0 = (u >> lpairs) * 8;
        const uint32_t a[4] = {lo[i].x, lo[i].y, lo[i].z, lo[i].w};
        const uint32_t b[4] = {hi[i].x, hi[i].y, hi[i].z, hi[i].w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // token n0 + j: channel 2cp in the low half, 2cp + 1 in the high
          const uint32_t v =
              __byte_perm(a[j / 2], b[j / 2], (j & 1) ? 0x7632 : 0x5410);
          *reinterpret_cast<uint32_t*>(
              smem + (Map<NT>::row(n0 + j) * ldc + 2 * cp) * 2) = v;
        }
      }
    }
  }

  // the whole of x: every batch fetched and put
  __device__ __forceinline__ void load(unsigned char* smem, int ldc,
                                       const bf16* __restrict__ x) {
    for (int u0 = threadIdx.x; u0 < units; u0 += U * THREADS) {
      fetch(x, u0);
      put(smem, ldc, u0);
    }
  }
};

// Sums of the 8 bf16 values of v into s, of their squares into ss.
__device__ __forceinline__ void add8(uint4 v, float& s, float& ss) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = lo_f(w[i]);
    const float b = hi_f(w[i]);
    s += a;
    s += b;
    ss = fmaf(a, a, ss);
    ss = fmaf(b, b, ss);
  }
}

// GN 1's statistics of the conv input's interior (C channels): one warp per
// group, 16-byte pieces, f32 sums in a fixed order, into mean[g], rstd[g].
template <int NT>
__device__ void gn1_stats(const unsigned char* smem, const TcParams& p,
                          float* mean, float* rstd) {
  using M = Map<NT>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int lgp = ilog2(p.gsz / 8);  // 16-byte pieces of a group per token
  const float n = static_cast<float>(p.gsz * M::HW);
  for (int g = warp; g < p.c / p.gsz; g += WARPS) {
    float s = 0.f;
    float ss = 0.f;
    for (int e = lane; e < (M::HW << lgp); e += 32) {
      const int pc = e & ((1 << lgp) - 1);
      add8(ld16(smem + (M::row(e >> lgp) * p.ldc + g * p.gsz + pc * 8) * 2),
           s, ss);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(FULL_MASK, s, off);
      ss += __shfl_xor_sync(FULL_MASK, ss, off);
    }
    if (lane == 0) {
      const float m = s / n;
      mean[g] = m;
      rstd[g] = rsqrtf(fmaxf(ss / n - m * m, 0.f) + p.eps);
    }
  }
}

// bf16(relu((a - m) * r)) of the two bf16 values of a word.
__device__ __forceinline__ uint32_t gn_relu2(uint32_t v, float m, float r) {
  return tc::pack(fmaxf((lo_f(v) - m) * r, 0.f), fmaxf((hi_f(v) - m) * r, 0.f));
}

// a1 = bf16(relu((x - mean1) * rstd1)) over the interior, in place, in
// 16-byte pieces (a piece lies in one group: gsz >= 8).
template <int NT>
__device__ void gn1_apply(unsigned char* smem, const TcParams& p,
                          const float* mean, const float* rstd) {
  using M = Map<NT>;
  const int lpc = ilog2(p.c / 8);
  const int lg8 = ilog2(p.gsz / 8);
  for (int e = threadIdx.x; e < (M::HW << lpc); e += THREADS) {
    const int pc = e & ((1 << lpc) - 1);
    unsigned char* q = smem + (M::row(e >> lpc) * p.ldc + pc * 8) * 2;
    const float m = mean[pc >> lg8];
    const float r = rstd[pc >> lg8];
    const uint4 v = ld16(q);
    st16(q, make_uint4(gn_relu2(v.x, m, r), gn_relu2(v.y, m, r),
                       gn_relu2(v.z, m, r), gn_relu2(v.w, m, r)));
  }
}

// The chunks of the block's weight stream, in order: conv_1's C / CHUNK,
// conv_2's F / CHUNK, then the residual's C / ck1 (none without w3). Chunk q
// goes to ring slot q % RING_SLOTS as mb rows of ck * k^2 stored elements
// (RING_ROW apart), in 16-byte cp.async pieces; past the end an empty group
// is committed, so that every call commits exactly one group. Offsets in
// elements fit 32 bits (F * C * 9 < 2^31).
__device__ __forceinline__ void issue_chunk(const TcParams& p, int q,
                                            uint32_t ring, int f0) {
  const int n1 = p.c / CHUNK;
  const int n2 = p.f / CHUNK;
  const int n3 = p.w3 != nullptr ? p.c / 256 + (p.c < 256) : 0;  // ck1
  const uint32_t slot = ring + (q % RING_SLOTS) * (p.mb * RING_ROW * 2);
  if (q < n1 + n2) {
    constexpr int PIECES = CHUNK * 9 / 8;
    const bool first = q < n1;
    const int stride = (first ? p.c : p.f) * 9;
    const bf16* src = (first ? p.w1 : p.w2) +
                      (f0 * stride + (first ? q : q - n1) * (CHUNK * 9));
    for (int e = threadIdx.x; e < p.mb * PIECES; e += THREADS) {
      const int m = e / PIECES;
      const int pc = e - m * PIECES;
      tc::cp_async16(slot + m * (RING_ROW * 2) + pc * 16,
                     src + (m * stride + pc * 8), true);
    }
  } else if (q < n1 + n2 + n3) {
    const int lp = ilog2(p.ck1 / 8);
    const bf16* src = p.w3 + (f0 * p.c + (q - n1 - n2) * p.ck1);
    for (int e = threadIdx.x; e < (p.mb << lp); e += THREADS) {
      const int m = e >> lp;
      const int pc = e & ((1 << lp) - 1);
      tc::cp_async16(slot + m * (RING_ROW * 2) + pc * 16,
                     src + (m * p.c + pc * 8), true);
    }
  }
  tc::cp_async_commit();
}

// Warp (wm, wk)'s k16 steps of one staged chunk: rows [wm*16, wm*16 + 16)
// of the chunk's weights (wrow: this lane's row g and channel 2t) against
// channels [c0, c0 + ck) of the conv input (act_c0) at each of the KK taps.
// A: channel pairs at one tap, KK elements apart in the stored order, as
// 16-bit loads; B: ldmatrix.x4 of two n8 tiles at the tap's row offset.
template <int NT, int KK>
__device__ __forceinline__ void chunk_mma(float (&acc)[NT][4],
                                          const unsigned short* wrow,
                                          uint32_t act_c0,
                                          const uint32_t (&brow)[NT / 2],
                                          int ck, int ldcb, int wk, int nwk) {
  const int steps = (ck / 16) * KK;
  for (int j = wk; j < steps; j += nwk) {
    const int half = j / KK;
    const int tap = j - half * KK;
    const unsigned short* a0 = wrow + half * 16 * KK + tap;
    constexpr int R8 = 8 * RING_ROW;
    uint32_t a[4];
    a[0] = a0[0] | static_cast<uint32_t>(a0[KK]) << 16;
    a[1] = a0[R8] | static_cast<uint32_t>(a0[R8 + KK]) << 16;
    a[2] = a0[8 * KK] | static_cast<uint32_t>(a0[9 * KK]) << 16;
    a[3] = a0[R8 + 8 * KK] | static_cast<uint32_t>(a0[R8 + 9 * KK]) << 16;
    int shift = 0;
    if (KK == 9)
      shift = ((tap / 3 - 1) * Map<NT>::WS + tap % 3 - 1) * ldcb;
    const uint32_t base = act_c0 + half * 32 + static_cast<uint32_t>(shift);
    uint32_t bf[NT / 2][4];  // every ldmatrix in flight before the products
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) tc::ldsm(bf[np], base + brow[np]);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      tc::mma(acc[2 * np], a, bf[np][0], bf[np][1]);
      tc::mma(acc[2 * np + 1], a, bf[np][2], bf[np][3]);
    }
  }
}

// Chunks [q, q_end) of the stream, whose first is at channel 0 of the conv
// input: wait for the chunk, synchronise (its data visible, the slot of the
// chunk before it free), start the copy of the chunk RING_SLOTS - 1 ahead
// into that slot (it may be in the next segment), and run this warp's
// products. Leaves q at q_end.
template <int NT, int KK>
__device__ __forceinline__ void run_chunks(
    float (&acc)[NT][4], const TcParams& p, int& q, int q_end, int ck,
    uint32_t ring, const unsigned short* ring_ptr, uint32_t act,
    const uint32_t (&brow)[NT / 2], int f0, int wm, int wk, int nwk) {
  const int lane = threadIdx.x % 32;
  const int lane_off = (wm * 16 + lane / 4) * RING_ROW + 2 * (lane % 4) * KK;
  for (int c0 = 0; q < q_end; ++q, c0 += ck) {
    cp_async_wait_ring();
    __syncthreads();
    issue_chunk(p, q + RING_SLOTS - 1, ring, f0);
    chunk_mma<NT, KK>(acc,
                      ring_ptr + (q % RING_SLOTS) * p.mb * RING_ROW + lane_off,
                      act + c0 * 2, brow, ck, p.ldc * 2, wk, nwk);
  }
}

// The warp's partial tile into part ([mb][LDP] f32, this wk's).
template <int NT>
__device__ __forceinline__ void store_partial(const float (&acc)[NT][4],
                                              float* part, int wm) {
  constexpr int LDP = Map<NT>::LDP;
  const int lane = threadIdx.x % 32;
  float* r = part + (wm * 16 + lane / 4) * LDP + 2 * (lane % 4);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    *reinterpret_cast<float2*>(r + nt * 8) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(r + 8 * LDP + nt * 8) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// The sum over the nwk (<= WARPS) partial tiles at element e = m * LDP + n,
// in warp order (tiles mb * LDP apart); all loads issued before the sums.
__device__ __forceinline__ float sum_partials(const float* part, int e,
                                              int tile, int nwk) {
  float v[WARPS];
#pragma unroll
  for (int k = 0; k < WARPS; ++k) v[k] = k < nwk ? part[k * tile + e] : 0.f;
  float s = v[0];
#pragma unroll
  for (int k = 1; k < WARPS; ++k)
    if (k < nwk) s += v[k];
  return s;
}

// K5a: one cluster of p.nc blocks per example (blockIdx.y); NT = HW / 8.
// A block's mb channels lie in one GN group (mb <= gsz), which spans rpg
// blocks.
template <int NT>
__global__ void __launch_bounds__(THREADS, 2)
    fused_block_fwd_tc(const TcParams p) {
  using M = Map<NT>;
  constexpr int HW = M::HW;
  constexpr int LDP = M::LDP;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int f0 = rank * p.mb;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwm = p.mb / 16;
  const int nwk = WARPS / nwm;
  const int wm = warp % nwm;
  const int wk = warp / nwm;
  const int tile = p.mb * LDP;     // a partial tile (f32)
  const int rpg = p.gsz / p.mb;    // blocks per GN group

  const uint32_t act = tc::smem(smem);
  const uint32_t ring = act + p.off_ring;
  const unsigned short* ring_ptr =
      reinterpret_cast<const unsigned short*>(smem + p.off_ring);
  float* mean1 = reinterpret_cast<float*>(smem + p.off_stats);
  float* rstd1 = mean1 + p.c / p.gsz;
  float* gpart = rstd1 + p.c / p.gsz;  // [2]: GN 2 sum, sum of squares
  float* stat2 = gpart + 2;            // [2]: GN 2 mean, rstd
  float* wsum = stat2 + 2;             // [WARPS][2]: the warps' GN 2 sums
  float* tds = wsum + 2 * WARPS;       // [mb]: td of the block's channels
  bf16* xres = reinterpret_cast<bf16*>(smem + p.off_res);  // [mb][HW]
  float* part = reinterpret_cast<float*>(smem);  // [nwk][mb][LDP], on act
  float* hbuf = part + nwk * tile;               // [mb][LDP]

  const bf16* x = p.x + static_cast<size_t>(b) * p.c * HW;
  STAMP(0);
  // x's first loads, then the weights (prefetched into L2, the ring's first
  // chunks) and td while they are in flight
  XLoader<NT> xl(p.c);
  xl.fetch(x, threadIdx.x);
  if (threadIdx.x == 0) {
    prefetch_l2(p.w1 + static_cast<size_t>(f0) * p.c * 9, p.mb * p.c * 18);
    prefetch_l2(p.w2 + static_cast<size_t>(f0) * p.f * 9, p.mb * p.f * 18);
    if (p.w3 != nullptr)
      prefetch_l2(p.w3 + static_cast<size_t>(f0) * p.c, p.mb * p.c * 2);
  }
  const float td_own =
      threadIdx.x < p.mb
          ? __bfloat162float(
                p.td[static_cast<size_t>(b) * p.f + f0 + threadIdx.x])
          : 0.f;
  for (int q0 = 0; q0 < RING_SLOTS - 1; ++q0) issue_chunk(p, q0, ring, f0);
  zero_halo<NT>(smem, p.ldc, p.c > p.f ? p.c : p.f);
  xl.put(smem, p.ldc, threadIdx.x);
  for (int u0 = threadIdx.x + XLoader<NT>::U * THREADS; u0 < xl.units;
       u0 += XLoader<NT>::U * THREADS) {
    xl.fetch(x, u0);
    xl.put(smem, p.ldc, u0);
  }
  if (threadIdx.x < p.mb) tds[threadIdx.x] = td_own;

  // this lane's ldmatrix row in each pair of n8 tiles, and its 8 channels
  uint32_t brow[NT / 2];
#pragma unroll
  for (int np = 0; np < NT / 2; ++np)
    brow[np] = M::row(np * 16 + lane % 8 + (lane / 16) * 8) * p.ldc * 2 +
               ((lane / 8) % 2) * 16;
  __syncthreads();
  STAMP(1);

  // an identity residual: the block's channels of x, [mb][HW]
  if (p.w3 == nullptr) {
    for (int e = threadIdx.x; e < HW * (p.mb / 8); e += THREADS) {
      const int n = e % HW;
      const int m0 = e / HW * 8;
      const uint4 v = ld16(smem + (M::row(n) * p.ldc + f0 + m0) * 2);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        reinterpret_cast<unsigned short*>(xres)[(m0 + j) * HW + n] =
            static_cast<unsigned short>(j % 2 ? w[j / 2] >> 16 : w[j / 2]);
    }
  }
  gn1_stats<NT>(smem, p, mean1, rstd1);
  __syncthreads();
  gn1_apply<NT>(smem, p, mean1, rstd1);
  STAMP(2);

  // conv_1 (run_chunks synchronises first)
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  int q = 0;
  run_chunks<NT, 9>(acc, p, q, p.c / CHUNK, CHUNK, ring, ring_ptr, act, brow,
                    f0, wm, wk, nwk);
  __syncthreads();  // every warp done with a1: its rows take the partials
  STAMP(3);
  store_partial<NT>(acc, part + wk * tile, wm);
  __syncthreads();

  // h1t = conv_1 + td, and this block's GN 2 sums: each thread's in order,
  // then the warp's (shuffles), then the warps' in order
  {
    float s = 0.f;
    float ss = 0.f;
    for (int e = threadIdx.x; e < p.mb * HW; e += THREADS) {
      const int m = e / HW;
      const int at = m * LDP + e % HW;
      const float v = sum_partials(part, at, tile, nwk) + tds[m];
      hbuf[at] = v;
      s += v;
      ss = fmaf(v, v, ss);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(FULL_MASK, s, off);
      ss += __shfl_xor_sync(FULL_MASK, ss, off);
    }
    if (lane == 0) {
      wsum[2 * warp] = s;
      wsum[2 * warp + 1] = ss;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    float ss = 0.f;
    for (int k = 0; k < WARPS; ++k) {
      s += wsum[2 * k];
      ss += wsum[2 * k + 1];
    }
    gpart[0] = s;
    gpart[1] = ss;
  }
  STAMP(4);
  // the group's statistics over its rpg blocks, in rank order
  if (rpg > 1)
    cluster.sync();
  else
    __syncthreads();
  STAMP(5);
  if (threadIdx.x == 0) {
    float s = 0.f;
    float ss = 0.f;
    const int r0 = rank / rpg * rpg;
    for (int r = r0; r < r0 + rpg; ++r) {
      const float* g = rpg > 1 ? cluster.map_shared_rank(gpart, r) : gpart;
      s += g[0];
      ss += g[1];
    }
    const float n = static_cast<float>(p.gsz * HW);
    const float m = s / n;
    stat2[0] = m;
    stat2[1] = rsqrtf(fmaxf(ss / n - m * m, 0.f) + p.eps);
  }
  __syncthreads();

  // d = bf16(dropout(relu(gn(h1t)))) of this block's channels, in
  // registers: 16-byte pieces of 8 channels of one token (tokens fastest).
  // Where the pieces are fewer than the threads, reps threads hold each
  // piece and push it to a share of the ranks.
  const uint32_t key = p.drop ? fmix32(static_cast<uint32_t>(*p.seed)) : 0u;
  const int pieces = HW * (p.mb / 8);
  int reps = pieces < THREADS ? THREADS / pieces : 1;
  reps = reps < p.nc ? reps : p.nc;
  const int ranks = p.nc / reps;               // ranks a thread pushes to
  const int r_lo = threadIdx.x / pieces * ranks;
  const bool pusher = threadIdx.x < pieces * reps;
  constexpr int MAXP = HW / 16;  // pieces a thread holds at mb = 128
  const float mean = stat2[0];
  const float rstd = stat2[1];
  uint4 dv[MAXP];
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    const int e = (reps > 1 ? threadIdx.x % pieces : threadIdx.x) +
                  i * THREADS;
    dv[i] = make_uint4(0u, 0u, 0u, 0u);
    if (pusher && e < pieces) {
      const int n = e % HW;
      const int m0 = e / HW * 8;
      uint32_t wd[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 2 * j + h;
          float a = fmaxf((hbuf[m * LDP + n] - mean) * rstd, 0.f);
          if (p.drop) {
            const uint32_t idx =
                static_cast<uint32_t>(f0 + m) *
                    static_cast<uint32_t>(p.b * HW) +
                static_cast<uint32_t>(b * HW + n);
            a = fmix32((idx * 0x9E3779B1u) ^ key) >= p.thresh ? a * p.scale
                                                              : 0.f;
          }
          v[h] = a;
        }
        wd[j] = tc::pack(v[0], v[1]);
      }
      dv[i] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  }
  STAMP(6);
  cluster.sync();  // every block done with its conv input and h1t
  STAMP(7);

  // conv_2's input: this block's slice of d stored into every rank's conv
  // input through distributed shared memory (stores, which do not wait);
  // the halo zeroed again (the partials overwrote it)
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    const int e = (reps > 1 ? threadIdx.x % pieces : threadIdx.x) +
                  i * THREADS;
    if (pusher && e < pieces) {
      unsigned char* at =
          smem + (M::row(e % HW) * p.ldc + rank * p.mb + e / HW * 8) * 2;
      for (int r = r_lo; r < r_lo + ranks; ++r)
        *reinterpret_cast<uint4*>(cluster.map_shared_rank(at, r)) = dv[i];
    }
  }
  zero_halo<NT>(smem, p.ldc, p.f);
  STAMP(8);
  cluster.sync();  // every slice of d in place
  STAMP(9);

  // conv_2, then the 1x1 residual into the same sums
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  run_chunks<NT, 9>(acc, p, q, q + p.f / CHUNK, CHUNK, ring, ring_ptr, act,
                    brow, f0, wm, wk, nwk);
  if (p.w3 != nullptr) {
    __syncthreads();  // every warp done with d
    xl.load(smem, p.ldc, x);
    run_chunks<NT, 1>(acc, p, q, q + p.c / p.ck1, p.ck1, ring, ring_ptr, act,
                      brow, f0, wm, wk, nwk);
  }
  __syncthreads();
  STAMP(10);
  store_partial<NT>(acc, part + wk * tile, wm);
  __syncthreads();

  // out = bf16(sums + residual)
  bf16* out = p.out + (static_cast<size_t>(b) * p.f + f0) * HW;
  for (int e = threadIdx.x; e < p.mb * HW; e += THREADS) {
    float v = sum_partials(part, (e / HW) * LDP + e % HW, tile, nwk);
    if (p.w3 == nullptr) v += __bfloat162float(xres[e]);
    out[e] = __float2bfloat16(v);
  }
  STAMP(11);
}

// ---------------------------------------------------------------------------
// K5b's data gradients on the tensor cores
// ---------------------------------------------------------------------------

constexpr int BWD_CLUSTER = 8;  // blocks per example
constexpr int BWD_MAX_EF = 8;   // GN 2's x-hat a thread holds (mb * HW)
constexpr int BWD_MAX_EC = 16;  // values of the C slice a thread holds

struct BwdParams {
  TcParams t;  // the shape (b, c, f, h, w, hw, gsz, nc, ldc), x, td, w1,
               // seed, the dropout and eps
  int mb, cb, rows, ck3;  // F slice, C slice, ring rows, w3^T chunk
  int off_ring, off_stats;
  const bf16 *g, *w2t, *w1t, *w3t;  // w3t may be null
  bf16* dx;
  float* dtd;
  bf16 *ws_a1, *ws_d, *ws_dh;  // for fused_block_wgrad_tc
  float* ws_res;               // with w3t only
};

// The chunks of the backward's weight stream, in order: w3^T's F / ck3 (with
// w3: rows of the block's C slice), conv_1's C / CHUNK (w1, rows of the F
// slice), conv_2^T's F / CHUNK (w2^T, F slice), conv_1^T's F / CHUNK (w1^T, C
// slice). As issue_chunk: each call commits exactly one group.
__device__ __forceinline__ void issue_chunk_bwd(const BwdParams& p, int q,
                                                uint32_t ring, int rank) {
  const TcParams& t = p.t;
  const int n0 = p.w3t != nullptr ? t.f / p.ck3 : 0;
  const int n1 = t.c / CHUNK;
  const int n2 = t.f / CHUNK;
  const uint32_t slot = ring + (q % RING_SLOTS) * (p.rows * RING_ROW * 2);
  if (q < n0) {
    const int lp = ilog2(p.ck3 / 8);
    const bf16* src = p.w3t + (rank * p.cb * t.f + q * p.ck3);
    for (int e = threadIdx.x; e < (p.cb << lp); e += THREADS) {
      const int m = e >> lp;
      const int pc = e & ((1 << lp) - 1);
      tc::cp_async16(slot + m * (RING_ROW * 2) + pc * 16,
                     src + (m * t.f + pc * 8), true);
    }
  } else if (q < n0 + n1 + 2 * n2) {
    constexpr int PIECES = CHUNK * 9 / 8;
    int j = q - n0;
    const bf16* w = t.w1;
    int stride = t.c * 9;
    int rows = p.mb;
    if (j >= n1 + n2) {
      j -= n1 + n2;
      w = p.w1t;
      stride = t.f * 9;
      rows = p.cb;
    } else if (j >= n1) {
      j -= n1;
      w = p.w2t;
      stride = t.f * 9;
    }
    const bf16* src = w + (rank * rows * stride + j * (CHUNK * 9));
    for (int e = threadIdx.x; e < rows * PIECES; e += THREADS) {
      const int m = e / PIECES;
      const int pc = e - m * PIECES;
      tc::cp_async16(slot + m * (RING_ROW * 2) + pc * 16,
                     src + (m * stride + pc * 8), true);
    }
  }
  tc::cp_async_commit();
}

// run_chunks over the backward's stream (slots of p.rows rows).
template <int NT, int KK>
__device__ __forceinline__ void run_chunks_bwd(
    float (&acc)[NT][4], const BwdParams& p, int& q, int q_end, int ck,
    uint32_t ring, const unsigned short* ring_ptr, uint32_t act,
    const uint32_t (&brow)[NT / 2], int rank, int wm, int wk, int nwk) {
  const int lane = threadIdx.x % 32;
  const int lane_off = (wm * 16 + lane / 4) * RING_ROW + 2 * (lane % 4) * KK;
  for (int ch = 0; q < q_end; ++q, ch += ck) {
    cp_async_wait_ring();
    __syncthreads();
    issue_chunk_bwd(p, q + RING_SLOTS - 1, ring, rank);
    chunk_mma<NT, KK>(
        acc, ring_ptr + (q % RING_SLOTS) * p.rows * RING_ROW + lane_off,
        act + ch * 2, brow, ck, p.t.ldc * 2, wk, nwk);
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
}

// Per GN group of a block's slice, this warp's sums of a[i] and a[i] * b[i]
// over the thread's values i < ne (pass i of the block's threads lies in
// group i >> lipg), summed over the warp by shuffles, into
// wsum[(group * WARPS + warp) * 2 + {0, 1}].
template <int MAXE>
__device__ __forceinline__ void group_sums(const float (&a)[MAXE],
                                           const float (&b)[MAXE], int ne,
                                           int lipg, float* wsum) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int gr = 0; (gr << lipg) < ne; ++gr) {
    float s = 0.f;
    float sx = 0.f;
#pragma unroll
    for (int i = 0; i < MAXE; ++i) {
      if (i < ne && (i >> lipg) == gr) {
        s += a[i];
        sx = fmaf(a[i], b[i], sx);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(FULL_MASK, s, off);
      sx += __shfl_xor_sync(FULL_MASK, sx, off);
    }
    if (lane == 0) {
      wsum[(gr * WARPS + warp) * 2] = s;
      wsum[(gr * WARPS + warp) * 2 + 1] = sx;
    }
  }
}

// The block's totals of group_sums, the warps' in warp order: thread gr <
// groups writes gsum[2 * gr], gsum[2 * gr + 1].
__device__ __forceinline__ void group_totals(const float* wsum, int groups,
                                             float* gsum) {
  const int gr = threadIdx.x;
  if (gr < groups) {
    float s = 0.f;
    float sx = 0.f;
    for (int k = 0; k < WARPS; ++k) {
      s += wsum[(gr * WARPS + k) * 2];
      sx += wsum[(gr * WARPS + k) * 2 + 1];
    }
    gsum[2 * gr] = s;
    gsum[2 * gr + 1] = sx;
  }
}

// K5b's data gradients: one cluster of BWD_CLUSTER blocks per example
// (blockIdx.y); NT = HW / 8. Block r owns channels [r*mb, (r+1)*mb) of h1t,
// dd and dh1t and [r*cb, (r+1)*cb) of da1 and dx, whole GN groups. In the
// epilogues thread tid holds token tid % HW of channels tid / HW + i * TPI.
template <int NT>
__global__ void __launch_bounds__(THREADS, 2)
    fused_block_bwd_tc(const BwdParams p) {
  using M = Map<NT>;
  constexpr int HW = M::HW;
  constexpr int LDP = M::LDP;
  constexpr int TPI = THREADS / HW;      // channels of one pass of threads
  constexpr int L = HW < 32 ? HW : 32;   // lanes holding a channel's tokens
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const TcParams& s = p.t;
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int f0 = rank * p.mb;
  const int c0 = rank * p.cb;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tn = threadIdx.x % HW;
  const int tm = threadIdx.x / HW;
  // the warps' tiles of the F slice's convs and of the C slice's
  const int nwmf = p.mb / 16;
  const int nwkf = WARPS / nwmf;
  const int wmf = warp % nwmf;
  const int wkf = warp / nwmf;
  const int nwmc = p.cb / 16;
  const int nwkc = WARPS / nwmc;
  const int wmc = warp % nwmc;
  const int wkc = warp / nwmc;
  const int tilef = p.mb * LDP;
  const int tilec = p.cb * LDP;
  const int ef = p.mb / TPI;
  const int ec = p.cb / TPI;
  const int lipg = ilog2(s.gsz / TPI);  // passes per GN group
  const float ngrp = static_cast<float>(s.gsz * HW);

  const uint32_t act = tc::smem(smem);
  const uint32_t ring = act + p.off_ring;
  const unsigned short* ring_ptr =
      reinterpret_cast<const unsigned short*>(smem + p.off_ring);
  const int gmax = p.rows / s.gsz;
  float* mean1 = reinterpret_cast<float*>(smem + p.off_stats);
  float* rstd1 = mean1 + s.c / s.gsz;
  float* mean2 = rstd1 + s.c / s.gsz;
  float* rstd2 = mean2 + p.mb / s.gsz;
  float* wsum = rstd2 + p.mb / s.gsz;     // [gmax][WARPS][2]
  float* gsum = wsum + 2 * WARPS * gmax;  // [gmax][2]
  float* tds = gsum + 2 * gmax;           // [mb]: td of the F slice
  float* tdp = tds + p.mb;                // [mb * HW / L]: d_td's runs
  float* part = reinterpret_cast<float*>(smem);  // partial tiles, on act
  const int sld = p.mb + 8;
  unsigned char* stage = reinterpret_cast<unsigned char*>(
      part + nwkf * tilef);  // [HW][sld] bf16: dh1t, channel-last

  const size_t xo = static_cast<size_t>(b) * s.c * HW;
  const size_t fo = static_cast<size_t>(b) * s.f * HW;
  const bf16* x = s.x + xo;
  const bf16* g = p.g + fo;

  if (threadIdx.x == 0) {
    prefetch_l2(s.w1 + static_cast<size_t>(f0) * s.c * 9, p.mb * s.c * 18);
    prefetch_l2(p.w2t + static_cast<size_t>(f0) * s.f * 9, p.mb * s.f * 18);
    prefetch_l2(p.w1t + static_cast<size_t>(c0) * s.f * 9, p.cb * s.f * 18);
    if (p.w3t != nullptr)
      prefetch_l2(p.w3t + static_cast<size_t>(c0) * s.f, p.cb * s.f * 2);
  }
  for (int q0 = 0; q0 < RING_SLOTS - 1; ++q0)
    issue_chunk_bwd(p, q0, ring, rank);
  uint32_t brow[NT / 2];
#pragma unroll
  for (int np = 0; np < NT / 2; ++np)
    brow[np] = M::row(np * 16 + lane % 8 + (lane / 16) * 8) * s.ldc * 2 +
               ((lane / 8) % 2) * 16;
  float acc[NT][4];
  int q = 0;

  // 0. with w3: the residual w3^T . g of the C slice, in f32, into ws_res
  // (read back at the end by the thread that wrote it)
  if (p.w3t != nullptr) {
    XLoader<NT> gl(s.f);
    gl.load(smem, s.ldc, g);
    zero_acc<NT>(acc);
    run_chunks_bwd<NT, 1>(acc, p, q, q + s.f / p.ck3, p.ck3, ring, ring_ptr,
                          act, brow, rank, wmc, wkc, nwkc);
    __syncthreads();
    store_partial<NT>(acc, part + wkc * tilec, wmc);
    __syncthreads();
    float* res = p.ws_res + xo + static_cast<size_t>(c0) * HW;
#pragma unroll
    for (int i = 0; i < BWD_MAX_EC; ++i) {
      if (i < ec) {
        const int m = tm + i * TPI;
        res[m * HW + tn] = sum_partials(part, m * LDP + tn, tilec, nwkc);
      }
    }
    __syncthreads();
  }

  // 1. a1 = bf16(relu(gn(x))) of the whole example in the conv input; its C
  // slice to ws_a1
  {
    XLoader<NT> xl(s.c);
    xl.load(smem, s.ldc, x);
  }
  zero_halo<NT>(smem, s.ldc, s.c);
  if (threadIdx.x < p.mb)
    tds[threadIdx.x] = __bfloat162float(
        s.td[static_cast<size_t>(b) * s.f + f0 + threadIdx.x]);
  __syncthreads();
  gn1_stats<NT>(smem, s, mean1, rstd1);
  __syncthreads();
  gn1_apply<NT>(smem, s, mean1, rstd1);
  __syncthreads();
  {
    bf16* a1 = p.ws_a1 + xo + static_cast<size_t>(c0) * HW;
#pragma unroll
    for (int i = 0; i < BWD_MAX_EC; ++i) {
      if (i < ec) {
        const int m = tm + i * TPI;
        a1[m * HW + tn] = *reinterpret_cast<const bf16*>(
            smem + (M::row(tn) * s.ldc + c0 + m) * 2);
      }
    }
  }

  // 2. h1t = conv_1(a1) + td of the F slice, GN 2's statistics, and d =
  // bf16(dropout(relu(x-hat))) to ws_d; x-hat and the kept bits stay in
  // registers
  zero_acc<NT>(acc);
  run_chunks_bwd<NT, 9>(acc, p, q, q + s.c / CHUNK, CHUNK, ring, ring_ptr,
                        act, brow, rank, wmf, wkf, nwkf);
  __syncthreads();  // every warp done with a1: its rows take the partials
  store_partial<NT>(acc, part + wkf * tilef, wmf);
  __syncthreads();
  float xh2[BWD_MAX_EF];
#pragma unroll
  for (int i = 0; i < BWD_MAX_EF; ++i) {
    xh2[i] = 0.f;
    if (i < ef) {
      const int m = tm + i * TPI;
      xh2[i] = sum_partials(part, m * LDP + tn, tilef, nwkf) + tds[m];
    }
  }
  group_sums<BWD_MAX_EF>(xh2, xh2, ef, lipg, wsum);
  __syncthreads();
  group_totals(wsum, p.mb / s.gsz, gsum);
  __syncthreads();
  if (threadIdx.x < p.mb / s.gsz) {
    const float m = gsum[2 * threadIdx.x] / ngrp;
    mean2[threadIdx.x] = m;
    rstd2[threadIdx.x] =
        rsqrtf(fmaxf(gsum[2 * threadIdx.x + 1] / ngrp - m * m, 0.f) + s.eps);
  }
  __syncthreads();
  const uint32_t key = s.drop ? fmix32(static_cast<uint32_t>(*s.seed)) : 0u;
  uint32_t keep = 0u;
  {
    bf16* wd = p.ws_d + fo + static_cast<size_t>(f0) * HW;
#pragma unroll
    for (int i = 0; i < BWD_MAX_EF; ++i) {
      if (i < ef) {
        const int m = tm + i * TPI;
        const int gr = i >> lipg;
        const float xh = (xh2[i] - mean2[gr]) * rstd2[gr];
        xh2[i] = xh;
        float a = fmaxf(xh, 0.f);
        if (s.drop) {
          const uint32_t idx =
              static_cast<uint32_t>(f0 + m) * static_cast<uint32_t>(s.b * HW) +
              static_cast<uint32_t>(b * HW + tn);
          if (fmix32((idx * 0x9E3779B1u) ^ key) >= s.thresh) {
            keep |= 1u << i;
            a *= s.scale;
          } else {
            a = 0.f;
          }
        }
        wd[m * HW + tn] = __float2bfloat16(a);
      }
    }
  }

  // 3. dd = conv_2^T(g) of the F slice, through dropout, ReLU 2 and GN 2's
  // backward: dh1t; d_td its sum over the tokens, unrounded
  {
    XLoader<NT> gl(s.f);
    gl.load(smem, s.ldc, g);
  }
  zero_halo<NT>(smem, s.ldc, s.f);
  zero_acc<NT>(acc);
  run_chunks_bwd<NT, 9>(acc, p, q, q + s.f / CHUNK, CHUNK, ring, ring_ptr,
                        act, brow, rank, wmf, wkf, nwkf);
  __syncthreads();
  store_partial<NT>(acc, part + wkf * tilef, wmf);
  __syncthreads();
  float v[BWD_MAX_EF];
#pragma unroll
  for (int i = 0; i < BWD_MAX_EF; ++i) {
    v[i] = 0.f;
    if (i < ef) {
      const int m = tm + i * TPI;
      float dd = sum_partials(part, m * LDP + tn, tilef, nwkf);
      if (s.drop) dd = (keep >> i) & 1u ? dd * s.scale : 0.f;
      v[i] = xh2[i] > 0.f ? dd : 0.f;
    }
  }
  group_sums<BWD_MAX_EF>(v, xh2, ef, lipg, wsum);
  __syncthreads();
  group_totals(wsum, p.mb / s.gsz, gsum);
  __syncthreads();
  {
    bf16* wdh = p.ws_dh + fo + static_cast<size_t>(f0) * HW;
#pragma unroll
    for (int i = 0; i < BWD_MAX_EF; ++i) {
      if (i < ef) {
        const int m = tm + i * TPI;
        const int gr = i >> lipg;
        const float dh = (v[i] - gsum[2 * gr] / ngrp -
                          xh2[i] * (gsum[2 * gr + 1] / ngrp)) *
                         rstd2[gr];
        float t = dh;
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1)
          t += __shfl_xor_sync(FULL_MASK, t, off);
        if (lane % L == 0) tdp[(i * THREADS + threadIdx.x) / L] = t;
        const bf16 r = __float2bfloat16(dh);
        wdh[m * HW + tn] = r;
        *reinterpret_cast<bf16*>(stage + (tn * sld + m) * 2) = r;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < p.mb) {
    float sum = 0.f;
    for (int r = 0; r < HW / L; ++r) sum += tdp[threadIdx.x * (HW / L) + r];
    p.dtd[static_cast<size_t>(b) * s.f + f0 + threadIdx.x] = sum;
  }

  // 4. conv_1^T's input: this block's slice of dh1t stored into every rank's
  // conv input through distributed shared memory (16-byte pieces of 8
  // channels of one token, as K5a's d); the halo zeroed again
  const int pieces = HW * (p.mb / 8);
  int reps = pieces < THREADS ? THREADS / pieces : 1;
  reps = reps < BWD_CLUSTER ? reps : BWD_CLUSTER;
  const int ranks = BWD_CLUSTER / reps;
  const int r_lo = threadIdx.x / pieces * ranks;
  const bool pusher = threadIdx.x < pieces * reps;
  constexpr int MAXP = HW / 16;
  uint4 dv[MAXP];
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    const int e = (reps > 1 ? threadIdx.x % pieces : threadIdx.x) +
                  i * THREADS;
    dv[i] = make_uint4(0u, 0u, 0u, 0u);
    if (pusher && e < pieces)
      dv[i] = ld16(stage + ((e % HW) * sld + e / HW * 8) * 2);
  }
  cluster.sync();  // every block done with its conv input (g) and staging
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    const int e = (reps > 1 ? threadIdx.x % pieces : threadIdx.x) +
                  i * THREADS;
    if (pusher && e < pieces) {
      unsigned char* at =
          smem + (M::row(e % HW) * s.ldc + f0 + e / HW * 8) * 2;
      for (int r = r_lo; r < r_lo + ranks; ++r)
        *reinterpret_cast<uint4*>(cluster.map_shared_rank(at, r)) = dv[i];
    }
  }
  zero_halo<NT>(smem, s.ldc, s.f);
  cluster.sync();  // every slice of dh1t in place

  // 5. da1 = conv_1^T(dh1t) of the C slice, through ReLU 1 and GN 1's
  // backward, plus the residual: dx
  zero_acc<NT>(acc);
  run_chunks_bwd<NT, 9>(acc, p, q, q + s.f / CHUNK, CHUNK, ring, ring_ptr,
                        act, brow, rank, wmc, wkc, nwkc);
  __syncthreads();
  store_partial<NT>(acc, part + wkc * tilec, wmc);
  __syncthreads();
  float u[BWD_MAX_EC];
  float xh1[BWD_MAX_EC];
  const int g1 = c0 / s.gsz;  // the block's first GN 1 group
#pragma unroll
  for (int i = 0; i < BWD_MAX_EC; ++i) {
    u[i] = xh1[i] = 0.f;
    if (i < ec) {
      const int m = tm + i * TPI;
      const int gr = g1 + (i >> lipg);
      const float xh =
          (__bfloat162float(x[(c0 + m) * HW + tn]) - mean1[gr]) * rstd1[gr];
      xh1[i] = xh;
      const float da = sum_partials(part, m * LDP + tn, tilec, nwkc);
      u[i] = xh > 0.f ? da : 0.f;
    }
  }
  group_sums<BWD_MAX_EC>(u, xh1, ec, lipg, wsum);
  __syncthreads();
  group_totals(wsum, p.cb / s.gsz, gsum);
  __syncthreads();
  bf16* dx = p.dx + xo + static_cast<size_t>(c0) * HW;
#pragma unroll
  for (int i = 0; i < BWD_MAX_EC; ++i) {
    if (i < ec) {
      const int m = tm + i * TPI;
      const int gr = i >> lipg;
      const float val = (u[i] - gsum[2 * gr] / ngrp -
                         xh1[i] * (gsum[2 * gr + 1] / ngrp)) *
                        rstd1[g1 + gr];
      const float res =
          p.w3t != nullptr
              ? p.ws_res[xo + static_cast<size_t>(c0 + m) * HW + tn]
              : __bfloat162float(g[(c0 + m) * HW + tn]);
      dx[m * HW + tn] = __float2bfloat16(val + res);
    }
  }
}

int cluster_size(int b, int f) {
  const int target = b <= SMALL_BATCH ? MAX_CLUSTER : 8;
  return f / 16 < target ? f / 16 : target;
}

// The shape checks and the layout (nn/fused_block.py _tc_plan mirrors
// them): fills the plan's fields and returns the shared-memory bytes, 0 if
// the kernel does not take the shape.
size_t tc_plan(TcParams& p) {
  const auto pow2 = [](int v) { return v > 0 && (v & (v - 1)) == 0; };
  p.hw = p.h * p.w;
  if (p.h != p.w || (p.h != 8 && p.h != 4) || !pow2(p.c) || !pow2(p.f) ||
      p.c < CHUNK || p.f < CHUNK || !pow2(p.gsz) || p.gsz > p.c ||
      p.gsz > p.f || p.b <= 0 || p.b > 65535)
    return 0;
  p.nc = cluster_size(p.b, p.f);
  p.mb = p.f / p.nc;
  if (WARPS % (p.mb / 16) || p.mb > p.gsz) return 0;
  p.ck1 = p.c < 256 ? p.c : 256;
  p.ldc = (p.c > p.f ? p.c : p.f) + 8;
  const size_t act = static_cast<size_t>(p.h + 2) * (p.w + 2) * p.ldc * 2;
  const size_t scratch = static_cast<size_t>(WARPS / (p.mb / 16) + 1) *
                         p.mb * (p.hw + PART_PAD) * 4;
  const size_t region = ((act > scratch ? act : scratch) + 15) / 16 * 16;
  const size_t ring = static_cast<size_t>(RING_SLOTS) * p.mb * RING_ROW * 2;
  const size_t stats =
      (static_cast<size_t>(2 * (p.c / p.gsz) + 4 + 2 * WARPS + p.mb) * 4 +
       15) / 16 * 16;
  const size_t res = static_cast<size_t>(p.mb) * p.hw * 2;
  p.off_ring = static_cast<int>(region);
  p.off_stats = static_cast<int>(region + ring);
  p.off_res = static_cast<int>(region + ring + stats);
  const size_t bytes = region + ring + stats + res;
  return bytes <= MAX_SMEM ? bytes : 0;
}

// Raises the kernel's dynamic shared memory limit and allows clusters of
// 16, once per device (`done` has a flag per device).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev < 0 || dev >= 64) return err;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(MAX_SMEM));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done[dev] = err == cudaSuccess;
  return err;
}

bool prepared[2][64];

void launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1],
                   const TcParams& p, size_t smem, cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(p.nc, p.b, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

template <int NT>
cudaError_t launch(const TcParams& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = prepare(fused_block_fwd_tc<NT>, prepared[NT == 8]);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(cfg, attr, p, smem, stream);
  err = cudaLaunchKernelEx(&cfg, fused_block_fwd_tc<NT>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Blocks per SM and the most clusters resident at once for the plan.
template <int NT>
cudaError_t occupancy(const TcParams& p, size_t smem, int* blocks,
                      int* clusters) {
  cudaError_t err = prepare(fused_block_fwd_tc<NT>, prepared[NT == 8]);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fused_block_fwd_tc<NT>, THREADS, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(cfg, attr, p, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(clusters, fused_block_fwd_tc<NT>,
                                        &cfg);
}

TcParams shape_params(int b, int c, int f, int h, int w, int gsz) {
  TcParams p = {};
  p.b = b;
  p.c = c;
  p.f = f;
  p.h = h;
  p.w = w;
  p.gsz = gsz;
  return p;
}

// ---------------------------------------------------------------------------
// K5b's weight gradients on the tensor cores
// ---------------------------------------------------------------------------

constexpr int WG_TILE = 32;      // output rows (f) and columns (c) a block
constexpr int WG_LDB = WG_TILE + 8;  // the staged map's row (bf16)

// One product of the weight gradients:
//   dw[(f * cin + c) * taps + tap] = sum over b, t of
//       a[b][f][t] * x[b][c][t + shift(tap)]   (0 where the tap leaves the map)
// a (B, F, HW) and x (B, cin, HW) bf16; taps 9 (3x3) or 1.
struct WgradTcJob {
  const bf16* a;
  const bf16* x;
  float* dw;
  int cin, taps;
};

struct WgradTcParams {
  WgradTcJob job[3];  // dw1 (dh1t, a1), dw2 (g, d), dw3 (g, x)
  int b, f;
};

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}

// The warp's products of one staged example: rows [wm*16, wm*16 + 16) of a
// (sa, [32][HW + 8]) against channels [wn*8, wn*8 + 8) of x at each of the
// TAPS taps (sb, [(H+2)(W+2)][WG_LDB], a zero halo), K = the example's HW
// tokens in k16 steps. A: ldmatrix.x4 of a's rows; B: ldmatrix.x2.trans of
// 16 tokens' rows of the map at the tap's row offset.
template <int NT, int TAPS>
__device__ __forceinline__ void wgrad_example(float (&acc)[9][4], uint32_t sa,
                                              uint32_t sb, int wm, int wn) {
  using M = Map<NT>;
  constexpr int LDA = M::HW + 8;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < M::HW / 16; ++ks) {
    uint32_t a[4];
    tc::ldsm(a, sa + ((wm * 16 + lane % 16) * LDA + ks * 16 +
                      (lane / 16) * 8) * 2);
    const uint32_t brow =
        sb + (M::row(ks * 16 + lane % 16) * WG_LDB + wn * 8) * 2;
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      const int shift =
          TAPS == 9 ? (tap / 3 - 1) * M::WS + tap % 3 - 1 : 0;
      uint32_t bf[2];
      ldsm_x2_trans(bf, brow + shift * (WG_LDB * 2));
      tc::mma(acc[tap], a, bf[0], bf[1]);
    }
  }
}

// K5b's weight gradients: blockIdx.z picks the product, the block a tile of
// WG_TILE f x WG_TILE c; warp (wm, wn) of the 8 owns 16 f x 8 c at every
// tap. The examples are summed in order inside the block (no atomics): each
// is staged into shared memory (a's rows, and x's channels channel-last with
// a zero halo) while the next one's loads are in flight in registers.
template <int NT>
__global__ void __launch_bounds__(THREADS)
    fused_block_wgrad_tc(const WgradTcParams p) {
  using M = Map<NT>;
  constexpr int HW = M::HW;
  constexpr int LDA = HW + 8;
  constexpr int ROWS = (M::H + 2) * M::WS;
  constexpr int APIECES = WG_TILE * HW / 8;  // 16-byte pieces of a's tile
  __shared__ __align__(16) unsigned char sa_buf[WG_TILE * LDA * 2];
  __shared__ __align__(16) unsigned char sb_buf[ROWS * WG_LDB * 2];
  const WgradTcJob jb = p.job[blockIdx.z];
  const int f0 = blockIdx.x * WG_TILE;
  const int c0 = blockIdx.y * WG_TILE;
  if (c0 >= jb.cin) return;  // the whole block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp % 2;
  const int wn = warp / 2;
  zero_halo<NT>(sb_buf, WG_LDB, WG_TILE);
  float acc[9][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
    acc[tap][0] = acc[tap][1] = acc[tap][2] = acc[tap][3] = 0.f;

  const size_t astride = static_cast<size_t>(p.f) * HW;
  const size_t xstride = static_cast<size_t>(jb.cin) * HW;
  const bf16* a = jb.a + static_cast<size_t>(f0) * HW;
  const bf16* x = jb.x + static_cast<size_t>(c0) * HW;
  XLoader<NT> xl(WG_TILE);
  uint4 av = make_uint4(0u, 0u, 0u, 0u);
  const int ar = threadIdx.x / (HW / 8);        // a's row of this piece
  const int ap = threadIdx.x % (HW / 8) * 8;    // and its first token
  const bool aload = threadIdx.x < APIECES;
  if (aload) av = __ldg(reinterpret_cast<const uint4*>(a + ar * HW + ap));
  xl.fetch(x, threadIdx.x);
  for (int bb = 0; bb < p.b; ++bb) {
    __syncthreads();  // every warp done with the last example
    if (aload) st16(sa_buf + (ar * LDA + ap) * 2, av);
    xl.put(sb_buf, WG_LDB, threadIdx.x);
    __syncthreads();
    if (bb + 1 < p.b) {
      if (aload)
        av = __ldg(reinterpret_cast<const uint4*>(
            a + (bb + 1) * astride + ar * HW + ap));
      xl.fetch(x + (bb + 1) * xstride, threadIdx.x);
    }
    if (jb.taps == 9)
      wgrad_example<NT, 9>(acc, tc::smem(sa_buf), tc::smem(sb_buf), wm, wn);
    else
      wgrad_example<NT, 1>(acc, tc::smem(sa_buf), tc::smem(sb_buf), wm, wn);
  }
  // rows f (g, g + 8), columns c (2t, 2t + 1) of each tap's tile
  const int f = f0 + wm * 16 + lane / 4;
  const int c = c0 + wn * 8 + 2 * (lane % 4);
  const size_t down = static_cast<size_t>(8) * jb.cin * jb.taps;  // f + 8
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    if (tap < jb.taps) {
      float* d =
          jb.dw + (static_cast<size_t>(f) * jb.cin + c) * jb.taps + tap;
      d[0] = acc[tap][0];
      d[jb.taps] = acc[tap][1];
      d[down] = acc[tap][2];
      d[down + jb.taps] = acc[tap][3];
    }
  }
}

// K5b's tensor-core plan (nn/fused_block.py _bwd_tc_plan mirrors it): fills
// the slices, the ring and the layout and returns the shared-memory bytes, 0
// if the kernel does not take the shape.
size_t bwd_tc_plan(BwdParams& p) {
  TcParams& t = p.t;
  const auto pow2 = [](int v) { return v > 0 && (v & (v - 1)) == 0; };
  t.hw = t.h * t.w;
  if (t.h != t.w || (t.h != 8 && t.h != 4) || !pow2(t.c) || !pow2(t.f) ||
      t.c < 16 * BWD_CLUSTER || t.f < 16 * BWD_CLUSTER ||
      t.c > 128 * BWD_CLUSTER || t.f > 128 * BWD_CLUSTER || !pow2(t.gsz) ||
      t.b <= 0 || t.b > 65535)
    return 0;
  t.nc = BWD_CLUSTER;
  p.mb = t.f / BWD_CLUSTER;
  p.cb = t.c / BWD_CLUSTER;
  if (t.gsz > p.mb || t.gsz > p.cb || t.gsz * t.hw < THREADS || t.gsz < 8 ||
      p.mb * t.hw > BWD_MAX_EF * THREADS || p.cb * t.hw > BWD_MAX_EC * THREADS)
    return 0;
  p.rows = p.mb > p.cb ? p.mb : p.cb;
  p.ck3 = t.f < 256 ? t.f : 256;
  t.ldc = (t.c > t.f ? t.c : t.f) + 8;
  const size_t ldp = static_cast<size_t>(t.hw + PART_PAD);
  const size_t act = static_cast<size_t>(t.h + 2) * (t.w + 2) * t.ldc * 2;
  const size_t sf =
      static_cast<size_t>(WARPS / (p.mb / 16) + 1) * p.mb * ldp * 4;
  const size_t sc = static_cast<size_t>(WARPS / (p.cb / 16)) * p.cb * ldp * 4;
  size_t region = act > sf ? act : sf;
  region = ((region > sc ? region : sc) + 15) / 16 * 16;
  const size_t ring = static_cast<size_t>(RING_SLOTS) * p.rows * RING_ROW * 2;
  const int groups = p.rows / t.gsz;
  const int runs = p.mb * t.hw / (t.hw < 32 ? t.hw : 32);
  const size_t stats =
      (static_cast<size_t>(2 * (t.c / t.gsz) + 2 * (p.mb / t.gsz) +
                           2 * WARPS * groups + 2 * groups + p.mb + runs) *
           4 +
       15) / 16 * 16;
  p.off_ring = static_cast<int>(region);
  p.off_stats = static_cast<int>(region + ring);
  const size_t bytes = region + ring + stats;
  return bytes <= MAX_SMEM ? bytes : 0;
}

bool bwd_prepared[2][64];

template <int NT>
cudaError_t launch_bwd(const BwdParams& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = prepare(fused_block_bwd_tc<NT>, bwd_prepared[NT == 8]);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(cfg, attr, p.t, smem, stream);
  err = cudaLaunchKernelEx(&cfg, fused_block_bwd_tc<NT>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int NT>
cudaError_t occupancy_bwd(const BwdParams& p, size_t smem, int* blocks,
                          int* clusters) {
  cudaError_t err = prepare(fused_block_bwd_tc<NT>, bwd_prepared[NT == 8]);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fused_block_bwd_tc<NT>, THREADS, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(cfg, attr, p.t, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(clusters, fused_block_bwd_tc<NT>,
                                        &cfg);
}

}  // namespace

extern "C" int bla_fused_block_fwd_tc(int b, int c, int f, int h, int w,
                                      int gsz, const void* x, const void* td,
                                      const void* w1, const void* w2,
                                      const void* w3, const void* seed,
                                      void* out, int drop, uint32_t thresh,
                                      float scale, float eps, void* stream) {
  TcParams p = shape_params(b, c, f, h, w, gsz);
  const size_t smem = tc_plan(p);
  if (smem == 0) return cudaErrorInvalidValue;
  const void* ptrs[4] = {x, w1, w2, w3};
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16) return cudaErrorMisalignedAddress;
  p.x = static_cast<const bf16*>(x);
  p.td = static_cast<const bf16*>(td);
  p.w1 = static_cast<const bf16*>(w1);
  p.w2 = static_cast<const bf16*>(w2);
  p.w3 = static_cast<const bf16*>(w3);
  p.seed = static_cast<const int*>(seed);
  p.out = static_cast<bf16*>(out);
  p.drop = drop;
  p.thresh = thresh;
  p.scale = scale;
  p.eps = eps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return p.hw == 64 ? launch<8>(p, smem, st) : launch<2>(p, smem, st);
}

// The plan of a shape and its occupancy: out[0..3] = cluster size,
// shared-memory bytes, blocks per SM, most clusters resident at once.
// Returns 0, -1 where the kernel does not take the shape, else a CUDA error.
extern "C" int bla_fused_block_tc_info(int b, int c, int f, int h, int w,
                                       int gsz, int* out) {
  TcParams p = shape_params(b, c, f, h, w, gsz);
  const size_t smem = tc_plan(p);
  if (smem == 0) return -1;
  out[0] = p.nc;
  out[1] = static_cast<int>(smem);
  return p.hw == 64 ? occupancy<8>(p, smem, out + 2, out + 3)
                    : occupancy<2>(p, smem, out + 2, out + 3);
}

extern "C" int bla_fused_block_bwd_tc(
    int b, int c, int f, int h, int w, int gsz, const void* x, const void* td,
    const void* w1, const void* w2t, const void* w1t, const void* w3t,
    const void* seed, const void* g, void* dx, void* dtd, void* ws_a1,
    void* ws_d, void* ws_dh, void* ws_res, int drop, uint32_t thresh,
    float scale, float eps, void* stream) {
  BwdParams p = {};
  p.t = shape_params(b, c, f, h, w, gsz);
  const size_t smem = bwd_tc_plan(p);
  if (smem == 0 || (w3t != nullptr && ws_res == nullptr))
    return cudaErrorInvalidValue;
  const void* ptrs[6] = {x, w1, w2t, w1t, w3t, g};
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16) return cudaErrorMisalignedAddress;
  p.t.x = static_cast<const bf16*>(x);
  p.t.td = static_cast<const bf16*>(td);
  p.t.w1 = static_cast<const bf16*>(w1);
  p.t.seed = static_cast<const int*>(seed);
  p.t.drop = drop;
  p.t.thresh = thresh;
  p.t.scale = scale;
  p.t.eps = eps;
  p.g = static_cast<const bf16*>(g);
  p.w2t = static_cast<const bf16*>(w2t);
  p.w1t = static_cast<const bf16*>(w1t);
  p.w3t = static_cast<const bf16*>(w3t);
  p.dx = static_cast<bf16*>(dx);
  p.dtd = static_cast<float*>(dtd);
  p.ws_a1 = static_cast<bf16*>(ws_a1);
  p.ws_d = static_cast<bf16*>(ws_d);
  p.ws_dh = static_cast<bf16*>(ws_dh);
  p.ws_res = static_cast<float*>(ws_res);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return p.t.hw == 64 ? launch_bwd<8>(p, smem, st)
                      : launch_bwd<2>(p, smem, st);
}

// K5b's tensor-core weight gradients from the data-gradient kernel's bf16
// workspaces (a1, d, dh1t; B x channels x H*W), g and x: dw1 (F, C, 3, 3),
// dw2 (F, F, 3, 3) and, where dw3 is not null, dw3 (F, C) in f32. Takes C
// and F multiples of WG_TILE on 8x8 and 4x4 maps; every operand 16-byte
// aligned.
extern "C" int bla_fused_block_wgrad_tc(int b, int c, int f, int h, int w,
                                        const void* ws_a1, const void* ws_d,
                                        const void* ws_dh, const void* g,
                                        const void* x, void* dw1, void* dw2,
                                        void* dw3, void* stream) {
  if (h != w || (h != 8 && h != 4) || b <= 0 || b > 65535 || c <= 0 ||
      f <= 0 || c % WG_TILE || f % WG_TILE)
    return cudaErrorInvalidValue;
  const void* ptrs[5] = {ws_a1, ws_d, ws_dh, g, x};
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16) return cudaErrorMisalignedAddress;
  WgradTcParams p = {};
  p.b = b;
  p.f = f;
  p.job[0] = {static_cast<const bf16*>(ws_dh), static_cast<const bf16*>(ws_a1),
              static_cast<float*>(dw1), c, 9};
  p.job[1] = {static_cast<const bf16*>(g), static_cast<const bf16*>(ws_d),
              static_cast<float*>(dw2), f, 9};
  p.job[2] = {static_cast<const bf16*>(g), static_cast<const bf16*>(x),
              static_cast<float*>(dw3), c, 1};
  const dim3 grid(f / WG_TILE, (c > f ? c : f) / WG_TILE,
                  dw3 != nullptr ? 3 : 2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h == 8)
    fused_block_wgrad_tc<8><<<grid, THREADS, 0, st>>>(p);
  else
    fused_block_wgrad_tc<2><<<grid, THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

// Blocks per SM of the tensor-core weight-gradient kernel for an h x h map
// (out[0]); returns 0, -1 for a map it does not take, else a CUDA error.
extern "C" int bla_fused_block_wgrad_tc_info(int h, int* out) {
  if (h != 8 && h != 4) return -1;
  return h == 8 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      out, fused_block_wgrad_tc<8>, THREADS, 0)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      out, fused_block_wgrad_tc<2>, THREADS, 0);
}

// K5b's tensor-core plan and occupancy, as bla_fused_block_tc_info.
extern "C" int bla_fused_block_bwd_tc_info(int b, int c, int f, int h, int w,
                                           int gsz, int* out) {
  BwdParams p = {};
  p.t = shape_params(b, c, f, h, w, gsz);
  const size_t smem = bwd_tc_plan(p);
  if (smem == 0) return -1;
  out[0] = p.t.nc;
  out[1] = static_cast<int>(smem);
  return p.t.hw == 64 ? occupancy_bwd<8>(p, smem, out + 2, out + 3)
                      : occupancy_bwd<2>(p, smem, out + 2, out + 3);
}

#ifdef BLA_K5A_STAMPS
// The last launch's phase stamps: [first block, last block][12] clock64().
extern "C" int bla_k5a_stamps(long long* out) {
  return cudaMemcpyFromSymbol(out, k5a_stamps, sizeof(k5a_stamps));
}
#endif

extern "C" const char* bla_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K4: the implicit-GEMM "same" convolution (stride 1, odd k), for NVIDIA
// Hopper (sm_90a).
//
// Replaces both TPU kernels of big_linear_algebra_tpu/nn/conv_implicit.py:
//   _conv_kernel        (K4a, launched at :85 by _conv_fwd_pallas)
//   _conv_packed_kernel (K4b, launched at :171 by _conv_fwd_packed)
// -> conv_tc (bf16) and conv_f32 (f32). Both compute, on x (B, C, H, W) and
// kernels (F, C, k, k),
//   out[b, f, h, w] = sum_{c, i, j} kernels[f, c, i, j] * x[b, c, h + i - k/2,
//                                                         w + j - k/2]
// with zero padding ("same", symmetric at stride 1), f32 sums, cast to the
// output type: out (B, F, H, W). They read the kernels as per-tap weights,
// tap i*k + j the matrix kernels[:, :, i, j]: conv_tc as w (k^2, F, CP)
// (the JAX package's w_taps (k^2, C, F), transposed), conv_f32 as w (k^2,
// C, CP); the last axis zero-padded to CP, a multiple of 8. With flip set
// the kernel computes dx, the conv of the gradient with the flipped,
// channel-transposed kernels: it reads tap t at w[k^2 - 1 - t] of the taps
// with the channels swapped. The plain PyTorch version is _plain_conv in
// nn/conv_implicit.py (the k^2 tap sum).
//
// Design. The TPU kernels hold an example's (C, H*W) block (K4a) or the
// whole batch packed as (C, B*H*W) (K4b) in VMEM and sum k^2 tap GEMMs on
// rolled, masked copies. Here the GEMM is out (F, P) = w (F, C*k^2) .
// patches (C*k^2, P) over the P = B*H*W positions, the patches never
// stored, and one tile rule stands for both kernels.
//
// bf16 (conv_tc), on the tensor cores:
// - A block computes 64 output channels x 256 positions with 8 warps (each
//   64 x 32: 4 x 4 mma.sync.m16n8k16 tiles, f32 sums in registers; against
//   128 x 128 blocks this halves the weights each position streams through
//   L2, which all blocks of an F tile read). Its positions are whole
//   image rows of one example (8 rows at 32x32, 16 at 16x16), or several
//   whole examples where H*W is smaller (4 at 8x8, 16 at 4x4); a row wider
//   than 256 is cut into column tiles.
// - Per step (a chunk of 16 input channels), the block stages the tile's
//   rows plus the k/2 halo as (position, channel) rows of 16 channels in
//   shared memory, zero past the borders and past C. A tap (i, j) reads the
//   same staged rows at a fixed offset: each ldmatrix row is 8 channels of
//   one position (16 bytes), so every shift stays 16-byte aligned, all k^2
//   taps reuse one staged chunk, and no patch element is read from global
//   memory more than once per block. The halo never crosses an example
//   (what the packed TPU kernel had to mask). x is NCHW, so the staging
//   reads 8 positions of a channel as one 16-byte load (whole rows of a
//   width divisible by 8; else element loads) and transposes 8 channels x
//   8 positions in registers.
// - The step's weights, w[tap][f tile][16 channels] for up to 9 taps, come
//   in by cp.async 16-byte pieces; A fragments by ldmatrix, B fragments
//   (patches) by ldmatrix at the tap's offset. Two stages: the next step's
//   copies are in flight during this step's products.
// - Where the tiles are too few to fill the card (the U-Net's 8x8 and 4x4
//   maps at batch 16 give 16 and 4 tiles), the steps are split over a
//   thread-block cluster of up to 8 blocks (the rule: as many as keep the
//   grid within one block per SM). Each rank sums its steps, writes its
//   partial tile into its shared memory, and after a cluster barrier each
//   rank sums a slice of the tile over the ranks in rank order through
//   distributed shared memory and stores it. No atomics: two runs are
//   bit-equal.
//
// f32 (conv_f32): true f32 FMA on the CUDA cores (no TF32), on the same
// tiles, steps (8 input channels each) and cluster split. The step's x chunk
// (channel, staged position) and weights (tap, channel, 64 output
// channels) come in by cp.async, 4-byte pieces zero-filled past the
// borders for x, 16-byte ones for w; two stages. Each thread sums an 8 x 8
// tile (8 output channels x 8 positions) in registers, as K1 does: per
// input channel and tap, 2 16-byte weight loads and 8 staged values feed
// 64 FMAs, and where its 8 positions are neighbours in one row (k = 3,
// whole rows of a width divisible by 8), the 10 staged values of a kernel
// row serve its 3 taps (16 loads per 192 FMAs).
//
// What bounds it on the H100: 2*B*F*H*W*C*k^2 flops. At the U-Net's (16,
// 128, 32x32) in bf16 the tensor cores need 4.9 us at their peak; mma.sync
// reaches a fraction of it (wgmma is the next step), and every block reads
// all of its F tile's weights (the whole kernel's weights move through L2
// once per position tile). In f32 the FMA rate bounds it (72 us at 67
// TFLOP/s).
//
// Built with -DBLA_CONV_GENERAL_FORMS, both kernels take their general form
// (element staging; per-tap loads) at every geometry, for timing each fast
// form against it (tools/conv_form_check.py).
//
// C interface (bound with ctypes): bla_conv_implicit returns the first CUDA
// error of its launch (cudaGetLastError() after it); it launches on the
// given stream and never synchronises. bf16 operands must be 16-byte
// aligned (cudaErrorMisalignedAddress otherwise); the wrapper copies a
// view that is not. bla_conv_plan reports the tile rule.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma_sm80.cuh"

namespace cg = cooperative_groups;

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Both kernels: blocks of 8 warps, the tile rule, the cluster's sum.
using tc::bf16;
constexpr int THREADS = 256;
constexpr int BM = 64;          // output channels per block
constexpr int BN = 256;         // output positions per block
constexpr int TG = 9;           // taps per step (k = 3: all of them)
constexpr int HALO_MAX = 1024;  // staged positions per step
constexpr int MAX_SPLITS = 8;
constexpr int LDP = BN + 4;     // f32 stride of the partial tile

// bf16 on the tensor cores (conv_tc)
constexpr int CK = 16;       // input channels per step (one k16)
constexpr int LDR = CK + 8;  // bf16 stride of a staged row: 48 bytes
constexpr int ROW_BYTES = LDR * 2;
constexpr int W_SLOT = TG * BM * ROW_BYTES;

// The tile rule and the step split, fixed on the host per call.
struct Geom {
  int b, c, h, w, f, ks, cp, flip;
  int hf;          // k / 2
  int tw, tr, nb;  // a tile: nb examples x tr rows x tw columns
  int rs, ws;      // its halo: tr + 2 hf rows, tw + 2 hf columns
  int ctiles, rtiles, ptiles, ftiles;
  int groups;      // tap groups per chunk (ceil(k^2 / TG))
  int steps;       // chunks x groups
  int splits;      // cluster size
  int vec;         // whole rows of a width divisible by 8
  int halo;        // staged positions: nb * rs * ws
};

// The (example, row, column) of the block's n-th output position, or false
// past the tile.
__device__ __forceinline__ bool tile_pos(const Geom& g, int n, int& bb,
                                         int& r, int& cc) {
  cc = n % g.tw;
  r = (n / g.tw) % g.tr;
  bb = n / (g.tw * g.tr);
  return bb < g.nb;
}

// cp.async the step's weights: taps [t0, t0 + nt) x rows [f0, f0 + BM) x
// channels [c0, c0 + 16), as rows of LDR.
__device__ __forceinline__ void stage_w(const bf16* __restrict__ w,
                                        uint32_t dst, const Geom& g, int f0,
                                        int s) {
  const int c0 = (s / g.groups) * CK;
  const int t0 = (s % g.groups) * TG;
  const int k2 = g.ks * g.ks;
  const int nt = min(TG, k2 - t0);
  for (int e = threadIdx.x; e < nt * BM * 2; e += THREADS) {
    const int piece = e % 2;
    const int row = (e / 2) % BM;
    const int tl = e / (2 * BM);
    const int t = t0 + tl;
    const int src = g.flip ? k2 - 1 - t : t;
    const int f = f0 + row;
    const int c = c0 + piece * 8;
    const bool ok = f < g.f && c < g.cp;
    const size_t off =
        ok ? (static_cast<size_t>(src) * g.f + f) * g.cp + c : 0;
    tc::cp_async16(dst + ((tl * BM + row) * LDR + piece * 8) * 2, w + off,
                   ok);
  }
}

// Two bf16 of lane half `hi` of words a and b: (a.half, b.half).
__device__ __forceinline__ uint32_t pair(uint32_t a, uint32_t b, bool hi) {
  return __byte_perm(a, b, hi ? 0x7632 : 0x5410);
}

// Staging of the x chunk, vector form (conv_tc<.., true>): one unit is 8
// channels x 8 positions of one image row; the halo has at most 2 *
// HALO_MAX / 8 = 256 units, one per thread. load() reads the unit into
// registers (8 16-byte loads, 0 past C), put() transposes it and writes 8
// (position, 8 channels) rows. Positions outside the image are never
// written: the block zeroes them once.
struct VecStager {
  uint32_t v[8][4];
  int row = -1;  // the unit's first staged row; -1: no unit
  int cg = 0;

  __device__ __forceinline__ void load(const bf16* __restrict__ x,
                                       const Geom& g, int b0, int h0, int s) {
    const int c0 = (s / g.groups) * CK;
    const int wg = g.w / 8;  // 8-position groups per image row
    const int u = threadIdx.x;
    row = -1;
    if (u >= g.nb * g.rs * wg * 2) return;
    cg = u % 2;
    const int grp = (u / 2) % wg;
    const int rr = (u / (2 * wg)) % g.rs;
    const int bb = u / (2 * wg * g.rs);
    const int b = b0 + bb;
    const int hh = h0 - g.hf + rr;
    if (b >= g.b || hh < 0 || hh >= g.h) return;
    row = (bb * g.rs + rr) * g.ws + g.hf + grp * 8;
    const size_t plane = static_cast<size_t>(g.h) * g.w;
    const bf16* src = x + (static_cast<size_t>(b) * g.c + c0 + cg * 8) * plane +
                      static_cast<size_t>(hh) * g.w + grp * 8;
#pragma unroll
    for (int ci = 0; ci < 8; ++ci) {
      v[ci][0] = v[ci][1] = v[ci][2] = v[ci][3] = 0;
      // volatile: issued here, ahead of the products that hide its latency
      if (c0 + cg * 8 + ci < g.c)
        asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v[ci][0]), "=r"(v[ci][1]), "=r"(v[ci][2]),
                       "=r"(v[ci][3])
                     : "l"(src + ci * plane));
    }
  }

  __device__ __forceinline__ void put(uint32_t dst) const {
    if (row < 0) return;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const bool hi = p % 2;
      const uint32_t a = pair(v[0][p / 2], v[1][p / 2], hi);
      const uint32_t b = pair(v[2][p / 2], v[3][p / 2], hi);
      const uint32_t c = pair(v[4][p / 2], v[5][p / 2], hi);
      const uint32_t d = pair(v[6][p / 2], v[7][p / 2], hi);
      asm volatile(
          "st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
              dst + (row + p) * ROW_BYTES + cg * 16),
          "r"(a), "r"(b), "r"(c), "r"(d)
          : "memory");
    }
  }
};

// Staging of the x chunk, element form (any geometry): one unit is one
// staged position x 8 channels, loaded and written at once.
__device__ __forceinline__ void stage_x_elems(const bf16* __restrict__ x,
                                              uint32_t dst, const Geom& g,
                                              int b0, int h0, int w0, int s) {
  const int c0 = (s / g.groups) * CK;
  const int halo = g.nb * g.rs * g.ws;
  const size_t plane = static_cast<size_t>(g.h) * g.w;
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  for (int u = threadIdx.x; u < 2 * halo; u += THREADS) {
    const int hr = u % halo;
    const int cg = u / halo;
    const int cc = hr % g.ws;
    const int rr = (hr / g.ws) % g.rs;
    const int bb = hr / (g.ws * g.rs);
    const int b = b0 + bb;
    const int hh = h0 - g.hf + rr;
    const int ww = w0 - g.hf + cc;
    if (b >= g.b || hh < 0 || hh >= g.h || ww < 0 || ww >= g.w) continue;
    const size_t at = (static_cast<size_t>(b) * g.c + c0 + cg * 8) * plane +
                      static_cast<size_t>(hh) * g.w + ww;
    uint32_t e[8];
#pragma unroll
    for (int ci = 0; ci < 8; ++ci)
      e[ci] = c0 + cg * 8 + ci < g.c ? xs[at + ci * plane] : 0u;
    asm volatile(
        "st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
            dst + hr * ROW_BYTES + cg * 16),
        "r"(e[0] | e[1] << 16), "r"(e[2] | e[3] << 16),
        "r"(e[4] | e[5] << 16), "r"(e[6] | e[7] << 16)
        : "memory");
  }
}

// The cluster's sum of its ranks' partial tiles (part, [BM][LDP] f32 in
// each rank's shared memory, written before a cluster barrier), in rank
// order through distributed shared memory, stored as out's tile: rank r
// sums rows [r * BM / splits, (r + 1) * BM / splits); a thread always the
// same 4 positions (a float4 of a row), 4 rows apart.
template <typename TOut>
__device__ __forceinline__ void reduce_store(cg::cluster_group& cluster,
                                             float* part, const Geom& g,
                                             int b0, int h0, int w0, int f0,
                                             TOut* __restrict__ out) {
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t plane = static_cast<size_t>(g.h) * g.w;
  const int n = (threadIdx.x % (BN / 4)) * 4;
  long long pos[4];  // the position's offset in out, less f * plane; -1: none
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    int bb, r, cc;
    pos[e] = -1;
    if (!tile_pos(g, n + e, bb, r, cc)) continue;
    const int b = b0 + bb;
    const int hh = h0 + r;
    const int ww = w0 + cc;
    if (b < g.b && hh < g.h && ww < g.w)
      pos[e] = static_cast<long long>(b) * g.f * plane +
               static_cast<long long>(hh) * g.w + ww;
  }
  const int m_end = (rank + 1) * BM / splits;
  for (int m = rank * BM / splits + threadIdx.x / (BN / 4);
       m < m_end && f0 + m < g.f;
       m += THREADS / (BN / 4)) {
    const int off = m * LDP + n;
    float4 q[MAX_SPLITS];  // all remote loads in flight at once
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits)
        q[r] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, r) + off);
    float sum[4] = {q[0].x, q[0].y, q[0].z, q[0].w};
#pragma unroll
    for (int r = 1; r < MAX_SPLITS; ++r) {
      if (r < splits) {
        sum[0] += q[r].x;
        sum[1] += q[r].y;
        sum[2] += q[r].z;
        sum[3] += q[r].w;
      }
    }
    const long long fo = static_cast<long long>(f0 + m) * plane;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (pos[e] >= 0) store(&out[pos[e] + fo], sum[e]);
  }
  // no block leaves while another may still read its partial tile
  cluster.sync();
}

// A warp's fragments of one tap: A (weights) of its 4 m16 tiles, B
// (patches at the tap's shift) of its 2 pairs of n8 tiles.
struct Frags {
  uint32_t a[4][4];
  uint32_t b[2][4];
};

__device__ __forceinline__ void load_tap(Frags& fr, uint32_t wsl,
                                         uint32_t xsl, uint32_t a_lane,
                                         const uint32_t (&b_lane)[2],
                                         const Geom& g, int t0, int tl) {
  const int t = t0 + tl;
  const int i = t / g.ks;
  const uint32_t shift = (i * g.ws + t - i * g.ks) * ROW_BYTES;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
    tc::ldsm(fr.a[mt], wsl + a_lane + (tl * BM + mt * 16) * ROW_BYTES);
#pragma unroll
  for (int np = 0; np < 2; ++np) tc::ldsm(fr.b[np], xsl + b_lane[np] + shift);
}

__device__ __forceinline__ void mma_tap(float (&acc)[4][4][4],
                                        const Frags& fr) {
#pragma unroll
  for (int np = 0; np < 2; ++np)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      tc::mma(acc[mt][2 * np], fr.a[mt], fr.b[np][0], fr.b[np][1]);
      tc::mma(acc[mt][2 * np + 1], fr.a[mt], fr.b[np][2], fr.b[np][3]);
    }
}

// One block: output channels [f0, f0 + BM) x the positions of tile
// blockIdx.x / splits, over its cluster rank's share of the steps.
template <typename TOut, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
    conv_tc(const bf16* __restrict__ x, const bf16* __restrict__ w,
            TOut* __restrict__ out, const Geom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / splits;
  const int w0 = (tile % g.ctiles) * g.tw;
  const int h0 = ((tile / g.ctiles) % g.rtiles) * g.tr;
  const int b0 = (tile / (g.ctiles * g.rtiles)) * g.nb;
  const int f0 = blockIdx.y * BM;
  const int s_begin = rank * g.steps / splits;
  const int s_end = (rank + 1) * g.steps / splits;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wn = warp;  // 32 positions, all BM = 64 output channels

  const uint32_t base = tc::smem(smem_raw);
  const uint32_t wslot[2] = {base, base + W_SLOT};
  const uint32_t xbase = base + 2 * W_SLOT;
  const uint32_t xslot[2] = {xbase, xbase + g.halo * ROW_BYTES};

  // zero both staged chunks: positions outside the image stay 0
  for (int i = threadIdx.x; i < 2 * g.halo * ROW_BYTES / 16; i += THREADS)
    asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(
                     xbase + 16 * i),
                 "r"(0)
                 : "memory");

  // this lane's ldmatrix rows: A (weights) rows of its m16 tiles; B
  // (patches) the staged row of the position it addresses in each pair of
  // n8 tiles (the tile's first staged row where the position is past it)
  const uint32_t a_lane = ((lane % 16) * LDR + (lane / 16) * 8) * 2;
  uint32_t b_lane[2];
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    int bb, r, cc;
    const int n = wn * 32 + np * 16 + lane % 8 + (lane / 16) * 8;
    const int row = tile_pos(g, n, bb, r, cc) ? (bb * g.rs + r) * g.ws + cc
                                              : 0;
    b_lane[np] = row * ROW_BYTES + ((lane / 8) % 2) * 16;
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  VecStager vs;
  __syncthreads();  // the zeroing before any staged row
  if (s_begin < s_end) {
    stage_w(w, wslot[0], g, f0, s_begin);
    if constexpr (VEC) {
      vs.load(x, g, b0, h0, s_begin);
      vs.put(xslot[0]);
    } else {
      stage_x_elems(x, xslot[0], g, b0, h0, w0, s_begin);
    }
  }
  tc::cp_async_commit();

  const int k2 = g.ks * g.ks;
  for (int s = s_begin; s < s_end; ++s) {
    const int cur = (s - s_begin) & 1;
    const bool more = s + 1 < s_end;
    if (more) {  // in flight during the products below
      stage_w(w, wslot[cur ^ 1], g, f0, s + 1);
      if constexpr (VEC) vs.load(x, g, b0, h0, s + 1);
    }
    tc::cp_async_commit();
    tc::cp_async_wait_one();
    __syncthreads();

    // the next tap's fragments load while this tap's products issue
    const int t0 = (s % g.groups) * TG;
    const int nt = min(TG, k2 - t0);
    Frags fa, fb;
    if (nt > 0) load_tap(fa, wslot[cur], xslot[cur], a_lane, b_lane, g, t0, 0);
    for (int tl = 0; tl < nt; tl += 2) {
      if (tl + 1 < nt)
        load_tap(fb, wslot[cur], xslot[cur], a_lane, b_lane, g, t0, tl + 1);
      mma_tap(acc, fa);
      if (tl + 2 < nt)
        load_tap(fa, wslot[cur], xslot[cur], a_lane, b_lane, g, t0, tl + 2);
      if (tl + 1 < nt) mma_tap(acc, fb);
    }

    if (more) {
      if constexpr (VEC)
        vs.put(xslot[cur ^ 1]);
      else
        stage_x_elems(x, xslot[cur ^ 1], g, b0, h0, w0, s + 1);
    }
    __syncthreads();
  }

  // The partial tile into this block's shared memory (the loop ended on a
  // barrier, so the stages are free), then the cluster's sum in rank order.
  float* part = reinterpret_cast<float*>(smem_raw);  // [BM][LDP]
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + lane / 4 + 8 * h;
        const int col = wn * 32 + nt * 8 + 2 * (lane % 4);
        *reinterpret_cast<float2*>(&part[row * LDP + col]) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
  cluster.sync();

  reduce_store(cluster, part, g, b0, h0, w0, f0, out);
}

// The tile rule, both kernels: whole rows of one example, or whole
// examples, up to BN positions, whose halo fits HALO_MAX staged rows; then
// the split of the steps (ck input channels each) over a cluster, as many
// blocks as keep the grid within one block per SM (at most MAX_SPLITS, at
// least one step each). False if no tile fits.
bool plan(Geom& g, int b, int c, int h, int w, int f, int ks, int cp,
          int flip, int ck, int sms) {
  g.b = b;
  g.c = c;
  g.h = h;
  g.w = w;
  g.f = f;
  g.ks = ks;
  g.cp = cp;
  g.flip = flip;
  g.hf = ks / 2;
  g.tw = w < BN ? w : BN;
  g.tr = h < BN / g.tw ? h : BN / g.tw;
  g.nb = 1;
  if (g.tr == h && g.tw == w) {
    const int fit = BN / (h * w);
    g.nb = b < fit ? b : fit;
  }
  while (g.nb * (g.tr + 2 * g.hf) * (g.tw + 2 * g.hf) > HALO_MAX) {
    if (g.nb > 1)
      --g.nb;
    else if (g.tr > 1)
      --g.tr;
    else if (g.tw > 1)
      --g.tw;
    else
      return false;
  }
  g.rs = g.tr + 2 * g.hf;
  g.ws = g.tw + 2 * g.hf;
  g.halo = g.nb * g.rs * g.ws;
  g.ctiles = (w + g.tw - 1) / g.tw;
  g.rtiles = (h + g.tr - 1) / g.tr;
  const long long ptiles =
      static_cast<long long>((b + g.nb - 1) / g.nb) * g.rtiles * g.ctiles;
  g.ftiles = (f + BM - 1) / BM;
  g.groups = (ks * ks + TG - 1) / TG;
  g.steps = (c + ck - 1) / ck * g.groups;
  long long s = sms / (ptiles * g.ftiles);
  if (s > MAX_SPLITS) s = MAX_SPLITS;
  if (s > g.steps) s = g.steps;
  g.splits = s < 1 ? 1 : static_cast<int>(s);
  if (ptiles * g.splits > INT_MAX || g.ftiles > 65535) return false;
  g.ptiles = static_cast<int>(ptiles);
#ifdef BLA_CONV_GENERAL_FORMS  // for measuring (tools/conv_form_check.py)
  g.vec = 0;
#else
  g.vec = g.tw == w && w % 8 == 0;
#endif
  return true;
}

size_t tc_smem(const Geom& g) {
  const size_t stages =
      2 * (static_cast<size_t>(W_SLOT) + g.halo * ROW_BYTES);
  const size_t part = static_cast<size_t>(BM) * LDP * sizeof(float);
  return stages > part ? stages : part;
}

int sm_count() {
  int dev = 0;
  int sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  return sms;
}

// ---- f32 on the CUDA cores ----
constexpr int F_CK = 8;  // input channels per step
constexpr int F_W_SLOT = TG * F_CK * BM * 4;

// cp.async the step's weights: taps [t0, t0 + nt) x input channels [c0, c0
// + 8) x output channels [f0, f0 + BM), as rows of BM floats (w: (k^2, C,
// CP)).
__device__ __forceinline__ void stage_w32(const float* __restrict__ w,
                                          uint32_t dst, const Geom& g,
                                          int f0, int s) {
  const int c0 = (s / g.groups) * F_CK;
  const int t0 = (s % g.groups) * TG;
  const int k2 = g.ks * g.ks;
  const int nt = min(TG, k2 - t0);
  for (int e = threadIdx.x; e < nt * F_CK * (BM / 4); e += THREADS) {
    const int row = e / (BM / 4);  // tl * F_CK + ci
    const int fl = (e % (BM / 4)) * 4;
    const int t = t0 + row / F_CK;
    const int c = c0 + row % F_CK;
    const int src = g.flip ? k2 - 1 - t : t;
    const bool ok = c < g.c && f0 + fl < g.cp;
    const size_t off =
        ok ? (static_cast<size_t>(src) * g.c + c) * g.cp + f0 + fl : 0;
    tc::cp_async16(dst + (row * BM + fl) * 4, w + off, ok);
  }
}

// cp.async the step's x chunk, channels [c0, c0 + 8) of the tile's halo, as
// (channel, staged position) floats: 0 outside the image and past C.
__device__ __forceinline__ void stage_x32(const float* __restrict__ x,
                                          uint32_t dst, const Geom& g,
                                          int b0, int h0, int w0, int s) {
  const int c0 = (s / g.groups) * F_CK;
  for (int e = threadIdx.x; e < F_CK * g.halo; e += THREADS) {
    const int hr = e % g.halo;
    const int c = c0 + e / g.halo;
    const int cc = hr % g.ws;
    const int rr = (hr / g.ws) % g.rs;
    const int b = b0 + hr / (g.ws * g.rs);
    const int hh = h0 - g.hf + rr;
    const int ww = w0 - g.hf + cc;
    const bool ok = b < g.b && c < g.c && hh >= 0 && hh < g.h && ww >= 0 &&
                    ww < g.w;
    const size_t off =
        ok ? ((static_cast<size_t>(b) * g.c + c) * g.h + hh) * g.w + ww : 0;
    tc::cp_async4(dst + e * 4, x + off, ok);
  }
}

// One block: output channels [f0, f0 + BM) x the positions of tile
// blockIdx.x / splits (the bf16 kernel's tiles), over its cluster rank's
// share of the steps. Thread: output channels 8 * (tid % 8) + [0, 8) x
// positions 8 * (tid / 8) + [0, 8), an 8 x 8 tile of f32 sums. ROW (k = 3,
// whole rows of a width divisible by 8): a thread's positions are 8
// neighbours in one row, so per input channel and kernel row it loads 10
// staged values once for the 3 taps.
template <typename TOut, bool ROW>
__global__ void __launch_bounds__(THREADS, 1)
    conv_f32(const float* __restrict__ x, const float* __restrict__ w,
             TOut* __restrict__ out, const Geom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / splits;
  const int w0 = (tile % g.ctiles) * g.tw;
  const int h0 = ((tile / g.ctiles) % g.rtiles) * g.tr;
  const int b0 = (tile / (g.ctiles * g.rtiles)) * g.nb;
  const int f0 = blockIdx.y * BM;
  const int s_begin = rank * g.steps / splits;
  const int s_end = (rank + 1) * g.steps / splits;
  const int tf = threadIdx.x % 8;
  const int tp = threadIdx.x / 8;

  float* smem_f = reinterpret_cast<float*>(smem_raw);
  const uint32_t base = tc::smem(smem_raw);
  // [W slot 0][W slot 1][x slot 0][x slot 1]
  const int x_floats = F_CK * g.halo;

  // the staged position of each of the thread's 8 positions (0 past the
  // tile: never stored)
  int rows[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    int bb, r, cc;
    rows[e] = tile_pos(g, tp * 8 + e, bb, r, cc)
                  ? (bb * g.rs + r) * g.ws + cc
                  : 0;
  }

  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[m][e] = 0.f;

  if (s_begin < s_end) {
    stage_w32(w, base, g, f0, s_begin);
    stage_x32(x, base + 2 * F_W_SLOT, g, b0, h0, w0, s_begin);
  }
  tc::cp_async_commit();

  const int k2 = g.ks * g.ks;
  for (int s = s_begin; s < s_end; ++s) {
    const int cur = (s - s_begin) & 1;
    if (s + 1 < s_end) {  // in flight during the FMAs below
      stage_w32(w, base + (cur ^ 1) * F_W_SLOT, g, f0, s + 1);
      stage_x32(x, base + 2 * F_W_SLOT + (cur ^ 1) * x_floats * 4, g, b0,
                h0, w0, s + 1);
    }
    tc::cp_async_commit();
    tc::cp_async_wait_one();
    __syncthreads();

    const float* ws = smem_f + cur * (F_W_SLOT / 4) + tf * 8;
    const float* xs = smem_f + 2 * (F_W_SLOT / 4) + cur * x_floats;
    const int t0 = (s % g.groups) * TG;
    const int nt = min(TG, k2 - t0);
    for (int ci = 0; ci < F_CK; ++ci) {
      const float* xc = xs + ci * g.halo;
      if constexpr (ROW) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          float xr[10];
#pragma unroll
          for (int e = 0; e < 10; ++e) xr[e] = xc[rows[0] + i * g.ws + e];
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float4* wv = reinterpret_cast<const float4*>(
                ws + ((i * 3 + j) * F_CK + ci) * BM);
            const float4 wa = wv[0];
            const float4 wb = wv[1];
            const float wr[8] = {wa.x, wa.y, wa.z, wa.w,
                                 wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int m = 0; m < 8; ++m)
#pragma unroll
              for (int e = 0; e < 8; ++e)
                acc[m][e] = fmaf(wr[m], xr[e + j], acc[m][e]);
          }
        }
      } else {
        for (int tl = 0; tl < nt; ++tl) {
          const int t = t0 + tl;
          const int i = t / g.ks;
          const int shift = i * g.ws + t - i * g.ks;
          float xv[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) xv[e] = xc[rows[e] + shift];
          const float4* wv =
              reinterpret_cast<const float4*>(ws + (tl * F_CK + ci) * BM);
          const float4 wa = wv[0];
          const float4 wb = wv[1];
          const float wr[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int m = 0; m < 8; ++m)
#pragma unroll
            for (int e = 0; e < 8; ++e)
              acc[m][e] = fmaf(wr[m], xv[e], acc[m][e]);
        }
      }
    }
    __syncthreads();
  }

  // The partial tile into this block's shared memory (the loop ended on a
  // barrier, so the stages are free), then the cluster's sum in rank order.
  float* part = smem_f;  // [BM][LDP]
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    float* row = part + (tf * 8 + m) * LDP + tp * 8;
    *reinterpret_cast<float4*>(row) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    *reinterpret_cast<float4*>(row + 4) =
        make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
  }
  cluster.sync();

  reduce_store(cluster, part, g, b0, h0, w0, f0, out);
}

size_t f32_smem(const Geom& g) {
  const size_t stages =
      2 * (static_cast<size_t>(F_W_SLOT) + F_CK * g.halo * sizeof(float));
  const size_t part = static_cast<size_t>(BM) * LDP * sizeof(float);
  return stages > part ? stages : part;
}

constexpr int TC_SMEM_MAX = 2 * (W_SLOT + HALO_MAX * ROW_BYTES);
constexpr int F32_SMEM_MAX = 2 * (F_W_SLOT + F_CK * HALO_MAX * 4);

// Kernel with its dynamic shared memory limit raised to max_smem, what any
// plan can ask (once per kernel).
template <auto Kernel>
cudaError_t ready(int max_smem) {
  static const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  return err;
}

// Launch a K4 kernel on g's grid, its steps split over clusters of
// g.splits blocks (none at one split: the implicit cluster of one).
template <auto Kernel, typename TIn, typename TOut>
cudaError_t launch(const void* x, const void* w, void* out, const Geom& g,
                   size_t smem, int max_smem, cudaStream_t stream) {
  const cudaError_t err = ready<Kernel>(max_smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.ptiles * g.splits, g.ftiles, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.splits > 1 ? 1 : 0;
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, Kernel, static_cast<const TIn*>(x), static_cast<const TIn*>(w),
      static_cast<TOut*>(out), g);
  if (launched != cudaSuccess) return launched;
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t launch_for(const void* x, const void* w, void* out,
                       const Geom& g, cudaStream_t stream) {
  if constexpr (std::is_same_v<TIn, bf16>) {
    const size_t smem = tc_smem(g);
    return g.vec ? launch<conv_tc<TOut, true>, TIn, TOut>(
                       x, w, out, g, smem, TC_SMEM_MAX, stream)
                 : launch<conv_tc<TOut, false>, TIn, TOut>(
                       x, w, out, g, smem, TC_SMEM_MAX, stream);
  } else {
    const size_t smem = f32_smem(g);
    return g.vec && g.ks == 3
               ? launch<conv_f32<TOut, true>, TIn, TOut>(
                     x, w, out, g, smem, F32_SMEM_MAX, stream)
               : launch<conv_f32<TOut, false>, TIn, TOut>(
                     x, w, out, g, smem, F32_SMEM_MAX, stream);
  }
}

}  // namespace

// x (b, c, h, wd) and the taps w in the input type (0 f32, 1 bf16), out
// (b, f, h, wd) in the output type: w (ks^2, f, cp) in bf16, (ks^2, c, cp)
// in f32, tap-reversed with flip (dx). x and w 16-byte aligned.
extern "C" int bla_conv_implicit(int in_dtype, int out_dtype, const void* x,
                                 const void* w, void* out, int b, int c,
                                 int h, int wd, int f, int ks, int cp,
                                 int flip, void* stream) {
  if (b <= 0 || c <= 0 || h <= 0 || wd <= 0 || f <= 0 || ks <= 0 ||
      ks % 2 == 0 || (out_dtype != kF32 && out_dtype != kBF16))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((in_dtype != kF32 && in_dtype != kBF16) ||
      cp < (in_dtype == kBF16 ? c : f) || cp % 8 != 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return cudaErrorMisalignedAddress;
  Geom g;
  if (!plan(g, b, c, h, wd, f, ks, cp, flip, in_dtype == kBF16 ? CK : F_CK,
            sm_count()))
    return cudaErrorInvalidValue;
  if (in_dtype == kF32)
    return out_dtype == kF32 ? launch_for<float, float>(x, w, out, g, s)
                             : launch_for<float, bf16>(x, w, out, g, s);
  return out_dtype == kF32 ? launch_for<bf16, float>(x, w, out, g, s)
                           : launch_for<bf16, bf16>(x, w, out, g, s);
}

// The tile rule for a call with input type in_dtype (0 f32, 1 bf16):
// out[0..3] the tile (examples, rows, columns) and the cluster size,
// out[4..5] the grid, out[6] 1 for bf16's 16-byte staging or f32's row
// reuse, out[7] the dynamic shared memory in bytes, out[8] the blocks per
// SM (cudaOccupancy); returns 0, or -1 if no tile fits.
extern "C" int bla_conv_plan(int in_dtype, int b, int c, int h, int wd,
                             int f, int ks, int* out) {
  const bool bf = in_dtype == kBF16;
  Geom g;
  if (!plan(g, b, c, h, wd, f, ks, ((bf ? c : f) + 7) / 8 * 8, 0,
            bf ? CK : F_CK, sm_count()))
    return -1;
  const bool fast = bf ? g.vec : g.vec && ks == 3;
  const size_t smem = bf ? tc_smem(g) : f32_smem(g);
  int blocks = -1;
  auto query = [&](auto kernel, cudaError_t ready) {
    if (ready == cudaSuccess)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS,
                                                    smem);
  };
  if (bf && fast)
    query(conv_tc<bf16, true>, ready<conv_tc<bf16, true>>(TC_SMEM_MAX));
  else if (bf)
    query(conv_tc<bf16, false>, ready<conv_tc<bf16, false>>(TC_SMEM_MAX));
  else if (fast)
    query(conv_f32<float, true>, ready<conv_f32<float, true>>(F32_SMEM_MAX));
  else
    query(conv_f32<float, false>,
          ready<conv_f32<float, false>>(F32_SMEM_MAX));
  const int vals[9] = {g.nb, g.tr,  g.tw, g.splits, g.ptiles * g.splits,
                       g.ftiles, fast, static_cast<int>(smem), blocks};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

extern "C" const char* bla_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

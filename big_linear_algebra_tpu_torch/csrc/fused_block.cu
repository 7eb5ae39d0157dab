// K5a and K5b: the U-Net's whole resnet block, forward and recompute
// backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of big_linear_algebra_tpu/nn/fused_block.py:
//   _fused_fwd_kernel (K5a, launched at :396) -> fused_block_fwd_kernel
//   _fused_bwd_kernel (K5b, launched at :441) -> fused_block_bwd_kernel, then
//                                                fused_block_wgrad_kernel
// The block, per example, on x (C, HW), td (F), w1 (F, C, k, k),
// w2 (F, F, k, k) and w3 (F, C) or none (C == F):
//   a1  = round(relu(gn(x)))            gn: one-pass f32 statistics per group
//   h1t = conv(a1, w1) + td              "same" zero padding, f32 sums
//   d   = round(dropout(relu(gn(h1t))))
//   out = conv(d, w2) + (w3 ? w3 . x : x)
// where round() is the rounding to the input type T before a product (the
// Pallas kernel's casts to the compute dtype) and var = max(E[x^2] - mean^2,
// 0), rstd = rsqrt(var + eps). Dropout keeps an element iff its bits >=
// thresh and scales it by `scale` (f32); the bits of element i of the packed
// (F, B*HW) layout are fmix32(i * 0x9E3779B1 ^ fmix32(seed)), which the
// plain version (_dropout_bits in nn/fused_block.py) computes too, so the
// backward regenerates the forward's mask. The plain PyTorch versions are
// _plain_fused_fwd and _plain_fused_bwd there.
//
// Design. The TPU kernel holds the whole batch-packed block in VMEM. Here:
// - One thread-block cluster per example, of nc blocks (8 at the U-Net's
//   widths): block r owns output channels [r*F/nc, (r+1)*F/nc) and input
//   channels [r*C/nc, (r+1)*C/nc), each a whole number of GN groups, so every
//   GN statistic is one block's sum. Every block holds the example's whole
//   conv input (at most 512 x 64 f32 = 128 KB) in shared memory; the conv
//   taps stream from global memory (L2) in chunks of 16 input channels.
// - A conv's output slice needs the whole previous activation, which other
//   blocks of the cluster computed: each block writes its slice to an f32
//   workspace in global memory, the cluster synchronises, and every block
//   reads the whole activation back (through L2). One launch per forward.
// - The weight gradients sum over the batch. The data-gradient kernel writes
//   each example's rounded a1, d and dh1t to workspaces, and a second kernel
//   (fused_block_wgrad_kernel) forms dw1, dw2 and dw3 as products over the
//   batch and the tokens, one (f, c) per thread, summed in a fixed order: no
//   atomics, so the gradients are deterministic, and the batch, not B
//   clusters, spreads over the card.
// - Every product is an f32 FMA on the CUDA cores (true f32 for f32 inputs;
//   bf16 inputs widen exactly). A thread owns one token and a contiguous run
//   of up to 16 output channels: per tap it reads one input value and its
//   run of weights as 16-byte vectors (broadcast to the warp), and it sums
//   each staged chunk apart before adding it to its total.
//
// What bounds it on the H100: the block's convs (2 * B * HW * C_in * C_out *
// k^2 flops each: two forward, five backward) would take microseconds on
// the tensor cores at the U-Net's widths. This first version is bound by
// shared-memory loads and their latency on the CUDA cores, with B * nc
// blocks busy (128 at B = 16, 8 at B = 1). The forward fits two blocks on
// an SM (at most 128 registers): otherwise only 15 clusters of 8 are
// resident and B = 16 runs in two waves, as the data-gradient kernel still
// does (206 registers). wgmma for the tap products and more blocks per
// example are the next steps.
//
// C interface (bound with ctypes): each entry returns cudaGetLastError()
// (or the launch's error) after its launch; it launches on the given stream
// and never synchronises.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_HW = 64;
constexpr int MAX_K2 = 9;        // 3x3 kernels at most
constexpr int MAX_OUT = 16;      // output channels per thread
constexpr int IC = 16;           // input channels per staged weight chunk
// A staged tap row holds qn * nj + 4 floats, qn = THREADS / HW channel runs
// of nj: HW >= 16 keeps qn <= 16 and the staged chunk small.
constexpr int MIN_HW = 16;
constexpr int MAX_CLUSTER = 8;
constexpr size_t MAX_SMEM = 232448;
constexpr int WG_F = 32;                 // weight-gradient tile: f (lanes)
constexpr int WG_C = THREADS / WG_F;     // and c (warps)
constexpr unsigned FULL_MASK = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// An f32 value rounded to the input type T and widened back.
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

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The dropout bits of element i of the packed (F, B*HW) layout.
__device__ __forceinline__ uint32_t dropout_bits(uint32_t key, uint32_t i) {
  return fmix32((i * 0x9E3779B1u) ^ key);
}

struct BlockParams {
  int b, c, f, h, w, hw, k, gsz, nc, fs, cs;
  const void *x, *td, *w1, *w2, *w3, *g;  // w3 may be null; g: backward
  const int* seed;
  void* out;       // forward: (B, F, H, W); backward: dx (B, C, H, W)
  float* dtd;      // backward: (B, F)
  float* ws_a1;    // backward: (B, C, HW)
  float* ws_d;     // (B, F, HW)
  float* ws_dh;    // backward: (B, F, HW)
  int drop;
  uint32_t thresh;
  float scale, eps;
};

// Shared memory, in floats, in this order.
struct Smem {
  float* act;   // max(C, F) x HW: the conv input of the example
  float* wst;   // IC * k^2 * (qn * nj + 4): one staged chunk of taps
  float* hbuf;  // m x HW: this block's slice of an activation
  float* rbuf;  // m x HW: reduction scratch
  float *m1, *r1;  // C / gsz: GN 1 mean and rstd
  float *m2, *r2;  // F / gsz: GN 2 mean and rstd (this block's groups)
  float *sa, *sb;  // m / gsz: group sums of the GN backward
};

__host__ __device__ inline int slice_max(int fs, int cs) {
  return fs > cs ? fs : cs;
}

// Output channels per thread for a slice of os channels shared by qn runs:
// the power of two >= ceil(os / qn) (MAX_OUT + 1 when past MAX_OUT).
__host__ __device__ inline int slot_count(int os, int qn) {
  const int slots = (os + qn - 1) / qn;
  int nj = 1;
  while (nj < slots && nj <= MAX_OUT) nj *= 2;
  return nj;
}

// The row stride of the staged taps: a thread's run of nj channels is
// contiguous and 16-byte aligned; the 4 extra floats keep the staging
// stores of consecutive rows to 4-way bank conflicts.
__host__ __device__ inline int stage_row(int os, int hw) {
  const int qn = THREADS / hw;
  return qn * slot_count(os, qn) + 4;
}

__host__ __device__ inline size_t smem_floats(int c, int f, int hw, int k,
                                              int gsz, int fs, int cs) {
  const int m = slice_max(fs, cs);
  return static_cast<size_t>(c > f ? c : f) * hw +
         static_cast<size_t>(IC) * k * k * stage_row(m, hw) +
         2 * static_cast<size_t>(m) * hw + 2 * (c / gsz) + 2 * (f / gsz) +
         2 * (m / gsz);
}

__device__ Smem carve(float* base, const BlockParams& p) {
  const int m = slice_max(p.fs, p.cs);
  Smem s;
  s.act = base;
  s.wst = s.act + (p.c > p.f ? p.c : p.f) * p.hw;
  s.hbuf = s.wst + IC * p.k * p.k * stage_row(m, p.hw);
  s.rbuf = s.hbuf + m * p.hw;
  s.m1 = s.rbuf + m * p.hw;
  s.r1 = s.m1 + p.c / p.gsz;
  s.m2 = s.r1 + p.c / p.gsz;
  s.r2 = s.m2 + p.f / p.gsz;
  s.sa = s.r2 + p.f / p.gsz;
  s.sb = s.sa + m / p.gsz;
  return s;
}

// This thread's place: token t of the example and its run q of a slice's
// output channels: channels q * nj + j, j < nj = slot_count(slice, qn).
struct Geo {
  int hw, h, w, t, q, qn;
};

// The tap products of one staged chunk of icn input channels for a thread's
// NJ channels (those past the slice compute values no one stores, from tap
// rows read inside their stride), each weight run read as 16-, 8- or 4-byte
// vectors; summed per chunk and then added to acc: two levels of sums, as
// the weight gradients.
template <int NJ>
__device__ __forceinline__ void chunk_products(
    float (&acc)[MAX_OUT], const float* rin, int hw, const float* wr,
    int icn, int k2, int rs, const int (&sh)[MAX_K2], uint32_t vm) {
  float part[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) part[j] = 0.f;
  for (int ii = 0; ii < icn; ++ii, rin += hw, wr += k2 * rs) {
#pragma unroll
    for (int tp = 0; tp < MAX_K2; ++tp) {
      if (tp < k2) {
        // an address inside the map even where the tap leaves it
        const bool ok = (vm >> tp) & 1u;
        const float v0 = rin[ok ? sh[tp] : 0];
        const float v = ok ? v0 : 0.f;
        const float* wt = wr + tp * rs;
        if constexpr (NJ >= 4) {
#pragma unroll
          for (int j = 0; j < NJ; j += 4) {
            const float4 w4 = *reinterpret_cast<const float4*>(wt + j);
            part[j] = fmaf(w4.x, v, part[j]);
            part[j + 1] = fmaf(w4.y, v, part[j + 1]);
            part[j + 2] = fmaf(w4.z, v, part[j + 2]);
            part[j + 3] = fmaf(w4.w, v, part[j + 3]);
          }
        } else if constexpr (NJ == 2) {
          const float2 w2 = *reinterpret_cast<const float2*>(wt);
          part[0] = fmaf(w2.x, v, part[0]);
          part[1] = fmaf(w2.y, v, part[1]);
        } else {
          part[0] = fmaf(wt[0], v, part[0]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] += part[j];
}

__device__ __forceinline__ Geo make_geo(const BlockParams& p) {
  Geo g;
  g.hw = p.hw;
  g.h = p.h;
  g.w = p.w;
  g.t = threadIdx.x % p.hw;
  g.q = threadIdx.x / p.hw;
  g.qn = THREADS / p.hw;
  return g;
}

// s1[g] = sum of a over run g, s2[g] = sum of a * b (a * a when b is null),
// for n_groups contiguous runs of len floats; one warp per run. The caller
// synchronises before (the runs written) and after (the sums read).
__device__ void group_sums(const float* a, const float* b, int n_groups,
                           int len, float* s1, float* s2) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int g = warp; g < n_groups; g += WARPS) {
    const float* ag = a + static_cast<size_t>(g) * len;
    const float* bg = b ? b + static_cast<size_t>(g) * len : ag;
    float p1 = 0.f;
    float p2 = 0.f;
    for (int e = lane; e < len; e += 32) {
      const float v = ag[e];
      p1 += v;
      p2 = fmaf(v, bg[e], p2);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      p1 += __shfl_xor_sync(FULL_MASK, p1, off);
      p2 += __shfl_xor_sync(FULL_MASK, p2, off);
    }
    if (lane == 0) {
      s1[g] = p1;
      s2[g] = p2;
    }
  }
}

// GN statistics of n_groups runs of len floats (the buffer written and
// synchronised): mean into mean[], rstd into rstd[]; ends synchronised.
__device__ void gn_stats(const float* buf, int n_groups, int len, float* mean,
                         float* rstd, float eps) {
  group_sums(buf, nullptr, n_groups, len, mean, rstd);
  __syncthreads();
  const float n = static_cast<float>(len);
  for (int g = threadIdx.x; g < n_groups; g += THREADS) {
    const float m = mean[g] / n;
    const float var = fmaxf(rstd[g] / n - m * m, 0.f);
    mean[g] = m;
    rstd[g] = rsqrtf(var + eps);
  }
  __syncthreads();
}

// acc[j] += sum over input channels i < n_in and taps of
//   W(o, i, tap) * in[i][t + shift(tap)]    (0 where the tap leaves the map)
// for this thread's outputs o = o0 + q * nj + j < o0 + os and token t; in is
// the whole input (n_in x HW) in shared memory. W is one stored tensor:
//   !TRANS: wgt[(o * n_in + i) * k2 + tap]         a conv with (O, I, k, k)
//   TRANS:  wgt[(i * n_out + o) * k2 + k2-1-tap]   the transposed conv with
//           the (I, O, k, k) tensor, flipped: dx of a conv
// Starts by synchronising (the input written; wst free).
template <typename T, bool TRANS>
__device__ __forceinline__ void conv_slice(float (&acc)[MAX_OUT], const float* in, int n_in,
                           int n_out, const T* __restrict__ wgt, int k,
                           int o0, int os, const Geo& geo, float* wst) {
  const int k2 = k * k;
  const int half = k / 2;
  const int row = geo.t / geo.w;
  const int col = geo.t % geo.w;
  int sh[MAX_K2];
  uint32_t vm = 0;
#pragma unroll
  for (int tp = 0; tp < MAX_K2; ++tp) {
    const int di = tp / k - half;
    const int dj = tp % k - half;
    sh[tp] = di * geo.w + dj;
    const bool ok = tp < k2 && row + di >= 0 && row + di < geo.h &&
                    col + dj >= 0 && col + dj < geo.w;
    vm |= ok ? 1u << tp : 0u;
  }
  const int nj = slot_count(os, geo.qn);
  const int rs = stage_row(os, geo.hw);
  for (int i0 = 0; i0 < n_in; i0 += IC) {
    const int icn = n_in - i0 < IC ? n_in - i0 : IC;
    __syncthreads();
    const int total = os * icn * k2;
    for (int e = threadIdx.x; e < total; e += THREADS) {
      int oo, ii, tp;
      size_t src;
      if (!TRANS) {
        oo = e / (icn * k2);
        const int r = e - oo * icn * k2;
        ii = r / k2;
        tp = r - ii * k2;
        src = (static_cast<size_t>(o0 + oo) * n_in + i0 + ii) * k2 + tp;
      } else {
        ii = e / (os * k2);
        const int r = e - ii * os * k2;
        oo = r / k2;
        const int tg = r - oo * k2;
        tp = k2 - 1 - tg;
        src = (static_cast<size_t>(i0 + ii) * n_out + o0 + oo) * k2 + tg;
      }
      wst[(ii * k2 + tp) * rs + oo] = to_f32(wgt[src]);
    }
    __syncthreads();
    const float* rin = in + static_cast<size_t>(i0) * geo.hw + geo.t;
    const float* wr = wst + geo.q * nj;
    switch (nj) {
      case 1:
        chunk_products<1>(acc, rin, geo.hw, wr, icn, k2, rs, sh, vm);
        break;
      case 2:
        chunk_products<2>(acc, rin, geo.hw, wr, icn, k2, rs, sh, vm);
        break;
      case 4:
        chunk_products<4>(acc, rin, geo.hw, wr, icn, k2, rs, sh, vm);
        break;
      case 8:
        chunk_products<8>(acc, rin, geo.hw, wr, icn, k2, rs, sh, vm);
        break;
      default:
        chunk_products<16>(acc, rin, geo.hw, wr, icn, k2, rs, sh, vm);
    }
  }
}

__device__ __forceinline__ float apply_dropout(float a, const BlockParams& p,
                                               uint32_t key, int o, int b,
                                               int t) {
  const uint32_t i = static_cast<uint32_t>(o) *
                         static_cast<uint32_t>(p.b * p.hw) +
                     static_cast<uint32_t>(b * p.hw + t);
  return dropout_bits(key, i) >= p.thresh ? a * p.scale : 0.f;
}

template <typename T>
__device__ void load_map(float* dst, const T* __restrict__ src, int n) {
  for (int e = threadIdx.x; e < n; e += THREADS) dst[e] = to_f32(src[e]);
}

// Read a cluster's workspace back (written by other blocks of the cluster
// before the cluster barrier): through L2, past the SM's L1.
__device__ void load_workspace(float* dst, const float* src, int n) {
  for (int e = threadIdx.x; e < n; e += THREADS) dst[e] = __ldcg(src + e);
}

// a1 = round(relu((x - mean1) * rstd1)) over the whole example, in place.
template <typename T>
__device__ void gn_relu_in_place(float* act, const Smem& s,
                                 const BlockParams& p, float* copy_to,
                                 int copy_lo, int copy_hi) {
  for (int e = threadIdx.x; e < p.c * p.hw; e += THREADS) {
    const int g = e / p.hw / p.gsz;
    const float v = round_to<T>(fmaxf((act[e] - s.m1[g]) * s.r1[g], 0.f));
    act[e] = v;
    if (copy_to != nullptr && e >= copy_lo && e < copy_hi) copy_to[e] = v;
  }
}

// K5a: one cluster per example (blockIdx.y), block blockIdx.x of it; two
// blocks to an SM.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    fused_block_fwd_kernel(BlockParams p) {
  extern __shared__ float smem[];
  const Smem s = carve(smem, p);
  const Geo geo = make_geo(p);
  const int b = blockIdx.y;
  const int o0 = blockIdx.x * p.fs;
  const int hw = p.hw;
  const int njf = slot_count(p.fs, geo.qn);  // this thread's channels
  const T* x = static_cast<const T*>(p.x) + static_cast<size_t>(b) * p.c * hw;
  const T* td = static_cast<const T*>(p.td) + static_cast<size_t>(b) * p.f;

  load_map(s.act, x, p.c * hw);
  __syncthreads();
  gn_stats(s.act, p.c / p.gsz, p.gsz * hw, s.m1, s.r1, p.eps);

  // the residual of this block's outputs, from x
  float res[MAX_OUT];
  float acc[MAX_OUT];
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) res[j] = acc[j] = 0.f;
  if (p.w3 != nullptr) {
    conv_slice<T, false>(res, s.act, p.c, p.f, static_cast<const T*>(p.w3),
                         1, o0, p.fs, geo, s.wst);
  } else {
#pragma unroll
    for (int j = 0; j < MAX_OUT; ++j) {
      const int ol = geo.q * njf + j;
      if (j < njf && ol < p.fs) res[j] = s.act[(o0 + ol) * hw + geo.t];
    }
  }
  __syncthreads();

  gn_relu_in_place<T>(s.act, s, p, nullptr, 0, 0);
  conv_slice<T, false>(acc, s.act, p.c, p.f, static_cast<const T*>(p.w1),
                       p.k, o0, p.fs, geo, s.wst);
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) {
    const int ol = geo.q * njf + j;
    if (j < njf && ol < p.fs) s.hbuf[ol * hw + geo.t] = acc[j] + to_f32(td[o0 + ol]);
  }
  __syncthreads();
  gn_stats(s.hbuf, p.fs / p.gsz, p.gsz * hw, s.m2, s.r2, p.eps);

  const uint32_t key = p.drop ? fmix32(static_cast<uint32_t>(*p.seed)) : 0u;
  float* ws = p.ws_d + static_cast<size_t>(b) * p.f * hw;
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) {
    const int ol = geo.q * njf + j;
    if (j < njf && ol < p.fs) {
      const int gl = ol / p.gsz;
      float a = fmaxf((s.hbuf[ol * hw + geo.t] - s.m2[gl]) * s.r2[gl], 0.f);
      if (p.drop) a = apply_dropout(a, p, key, o0 + ol, b, geo.t);
      ws[(o0 + ol) * hw + geo.t] = round_to<T>(a);
    }
  }
  __threadfence();
  cg::this_cluster().sync();

  load_workspace(s.act, ws, p.f * hw);
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) acc[j] = 0.f;
  conv_slice<T, false>(acc, s.act, p.f, p.f, static_cast<const T*>(p.w2),
                       p.k, o0, p.fs, geo, s.wst);
  T* out = static_cast<T*>(p.out) + static_cast<size_t>(b) * p.f * hw;
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) {
    const int ol = geo.q * njf + j;
    if (j < njf && ol < p.fs) store(&out[(o0 + ol) * hw + geo.t], acc[j] + res[j]);
  }
}

// K5b, data gradients: one cluster per example. Recomputes a1, h1t and the
// GN 2 statistics, then dd (conv_2's dx), dh1t through dropout, ReLU and
// GN 2, d_td, da1 (conv_1's dx) and dx through ReLU and GN 1, plus the
// residual's dx. Writes the rounded a1, d and dh1t of its slices to the
// workspaces of the weight-gradient kernel.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    fused_block_bwd_kernel(BlockParams p) {
  extern __shared__ float smem[];
  const Smem s = carve(smem, p);
  const Geo geo = make_geo(p);
  const int b = blockIdx.y;
  const int o0 = blockIdx.x * p.fs;  // this block's F slice
  const int c0 = blockIdx.x * p.cs;  // and its C slice
  const int hw = p.hw;
  const int njf = slot_count(p.fs, geo.qn);  // this thread's channels
  const int njc = slot_count(p.cs, geo.qn);
  const size_t xoff = static_cast<size_t>(b) * p.c * hw;
  const size_t foff = static_cast<size_t>(b) * p.f * hw;
  const T* x = static_cast<const T*>(p.x) + xoff;
  const T* td = static_cast<const T*>(p.td) + static_cast<size_t>(b) * p.f;
  const T* g = static_cast<const T*>(p.g) + foff;

  // recompute: a1 (and its C slice out), h1t, GN 2, x^2 and d (F slice out)
  load_map(s.act, x, p.c * hw);
  __syncthreads();
  gn_stats(s.act, p.c / p.gsz, p.gsz * hw, s.m1, s.r1, p.eps);
  gn_relu_in_place<T>(s.act, s, p, p.ws_a1 + xoff, c0 * hw, (c0 + p.cs) * hw);
  float acc[MAX_OUT];
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) acc[j] = 0.f;
  conv_slice<T, false>(acc, s.act, p.c, p.f, static_cast<const T*>(p.w1),
                       p.k, o0, p.fs, geo, s.wst);
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) {
    const int ol = geo.q * njf + j;
    if (j < njf && ol < p.fs) s.hbuf[ol * hw + geo.t] = acc[j] + to_f32(td[o0 + ol]);
  }
  __syncthreads();
  gn_stats(s.hbuf, p.fs / p.gsz, p.gsz * hw, s.m2, s.r2, p.eps);
  const uint32_t key = p.drop ? fmix32(static_cast<uint32_t>(*p.seed)) : 0u;
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) {
    const int ol = geo.q * njf + j;
    if (j < njf && ol < p.fs) {
      const int gl = ol / p.gsz;
      const int idx = ol * hw + geo.t;
      const float xh = (s.hbuf[idx] - s.m2[gl]) * s.r2[gl];
      s.hbuf[idx] = xh;
      float a = fmaxf(xh, 0.f);
      if (p.drop) a = apply_dropout(a, p, key, o0 + ol, b, geo.t);
      p.ws_d[foff + (o0 + ol) * hw + geo.t] = round_to<T>(a);
    }
  }
  __syncthreads();

  // the cotangent g, whole; the residual's dx of this block's C slice
  load_map(s.act, g, p.f * hw);
  float resx[MAX_OUT];
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) resx[j] = 0.f;
  if (p.w3 != nullptr) {
    conv_slice<T, true>(resx, s.act, p.f, p.c, static_cast<const T*>(p.w3),
                        1, c0, p.cs, geo, s.wst);
  } else {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAX_OUT; ++j) {
      const int ol = geo.q * njc + j;
      if (j < njc && ol < p.cs) resx[j] = s.act[(c0 + ol) * hw + geo.t];
    }
  }

  // dd = conv_2's dx (F slice), through dropout and ReLU 2
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) acc[j] = 0.f;
  conv_slice<T, true>(acc, s.act, p.f, p.f, static_cast<const T*>(p.w2), p.k,
                      o0, p.fs, geo, s.wst);
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) {
    const int ol = geo.q * njf + j;
    if (j < njf && ol < p.fs) {
      const int idx = ol * hw + geo.t;
      float v = acc[j];
      if (p.drop) v = apply_dropout(v, p, key, o0 + ol, b, geo.t);
      v = s.hbuf[idx] > 0.f ? v : 0.f;
      s.rbuf[idx] = v;
      acc[j] = v;
    }
  }
  __syncthreads();
  group_sums(s.rbuf, s.hbuf, p.fs / p.gsz, p.gsz * hw, s.sa, s.sb);
  __syncthreads();

  // dh1t through GN 2 (F slice): to the workspace, and summed into d_td
  const float n = static_cast<float>(p.gsz * hw);
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) {
    const int ol = geo.q * njf + j;
    if (j < njf && ol < p.fs) {
      const int gl = ol / p.gsz;
      const int idx = ol * hw + geo.t;
      const float dh =
          (acc[j] - s.sa[gl] / n - s.hbuf[idx] * (s.sb[gl] / n)) * s.r2[gl];
      s.rbuf[idx] = dh;
      p.ws_dh[foff + (o0 + ol) * hw + geo.t] = round_to<T>(dh);
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < p.fs; o += THREADS) {
    float sum = 0.f;
    for (int t = 0; t < hw; ++t) sum += s.rbuf[o * hw + t];
    p.dtd[static_cast<size_t>(b) * p.f + o0 + o] = sum;
  }
  __threadfence();
  cg::this_cluster().sync();

  // da1 = conv_1's dx (C slice) from the whole dh1t, through ReLU 1, GN 1
  load_workspace(s.act, p.ws_dh + foff, p.f * hw);
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) acc[j] = 0.f;
  conv_slice<T, true>(acc, s.act, p.f, p.c, static_cast<const T*>(p.w1),
                      p.k, c0, p.cs, geo, s.wst);
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) {
    const int ol = geo.q * njc + j;
    if (j < njc && ol < p.cs) {
      const int cc = c0 + ol;
      const int g1 = cc / p.gsz;
      const int idx = ol * hw + geo.t;
      const float xh = (to_f32(x[cc * hw + geo.t]) - s.m1[g1]) * s.r1[g1];
      s.hbuf[idx] = xh;
      const float v = xh > 0.f ? acc[j] : 0.f;
      s.rbuf[idx] = v;
      acc[j] = v;
    }
  }
  __syncthreads();
  group_sums(s.rbuf, s.hbuf, p.cs / p.gsz, p.gsz * hw, s.sa, s.sb);
  __syncthreads();
  T* dx = static_cast<T*>(p.out) + xoff;
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) {
    const int ol = geo.q * njc + j;
    if (j < njc && ol < p.cs) {
      const int gl = ol / p.gsz;
      const int cc = c0 + ol;
      const int idx = ol * hw + geo.t;
      const float v =
          (acc[j] - s.sa[gl] / n - s.hbuf[idx] * (s.sb[gl] / n)) *
          s.r1[cc / p.gsz];
      store(&dx[cc * hw + geo.t], v + resx[j]);
    }
  }
}

// One product of K5b's weight gradients:
//   dw[(f * cin + c) * k2 + tap] = sum over b, t of
//       g[b][f][t] * x[b][c][t + shift(tap)]   (0 where the tap leaves the map)
// over f < F, c < cin. Operands are f32 or bf16 (x_bf16, g_bf16).
struct WgradJob {
  const void* x;
  const void* g;
  float* dw;
  int x_bf16, g_bf16, cin, k;
};

struct WgradParams {
  WgradJob job[3];
  int b, f, h, w, hw;
};

__device__ __forceinline__ float load_op(const void* p, int bf16, size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// K5b, weight gradients: blockIdx.z picks the product (dw1, dw2, dw3), the
// block a tile of 32 f x 8 c; each thread owns one (f, c) and its k^2 taps:
// per example a sum over the tokens, then the sum of those over the batch,
// in that order.
__global__ void __launch_bounds__(THREADS)
    fused_block_wgrad_kernel(WgradParams p) {
  const WgradJob jb = p.job[blockIdx.z];
  const int f0 = blockIdx.x * WG_F;
  const int c0 = blockIdx.y * WG_C;
  if (c0 >= jb.cin) return;  // the whole block
  __shared__ float gs[MAX_HW * (WG_F + 1)];
  __shared__ float xs[WG_C * MAX_HW];
  __shared__ uint32_t vmask[MAX_HW];
  const int hw = p.hw;
  const int k = jb.k;
  const int k2 = k * k;
  const int half = k / 2;
  int sh[MAX_K2];
#pragma unroll
  for (int tp = 0; tp < MAX_K2; ++tp)
    sh[tp] = (tp / k - half) * p.w + (tp % k - half);
  if (threadIdx.x < hw) {
    const int row = threadIdx.x / p.w;
    const int col = threadIdx.x % p.w;
    uint32_t vm = 0;
    for (int tp = 0; tp < k2; ++tp) {
      const int di = tp / k - half;
      const int dj = tp % k - half;
      if (row + di >= 0 && row + di < p.h && col + dj >= 0 && col + dj < p.w)
        vm |= 1u << tp;
    }
    vmask[threadIdx.x] = vm;
  }
  const int fl = threadIdx.x % WG_F;
  const int cl = threadIdx.x / WG_F;
  float acc[MAX_K2];
#pragma unroll
  for (int tp = 0; tp < MAX_K2; ++tp) acc[tp] = 0.f;
  for (int bb = 0; bb < p.b; ++bb) {
    __syncthreads();
    for (int e = threadIdx.x; e < WG_F * hw; e += THREADS) {
      const int ff = e / hw;
      const int t = e - ff * hw;
      const int fg = f0 + ff;
      gs[t * (WG_F + 1) + ff] =
          fg < p.f ? load_op(jb.g, jb.g_bf16,
                             (static_cast<size_t>(bb) * p.f + fg) * hw + t)
                   : 0.f;
    }
    for (int e = threadIdx.x; e < WG_C * hw; e += THREADS) {
      const int cc = e / hw;
      const int t = e - cc * hw;
      const int cg_ = c0 + cc;
      xs[cc * hw + t] =
          cg_ < jb.cin
              ? load_op(jb.x, jb.x_bf16,
                        (static_cast<size_t>(bb) * jb.cin + cg_) * hw + t)
              : 0.f;
    }
    __syncthreads();
    const float* xr = xs + cl * hw;
    float part[MAX_K2];
#pragma unroll
    for (int tp = 0; tp < MAX_K2; ++tp) part[tp] = 0.f;
    for (int t = 0; t < hw; ++t) {
      const float gv = gs[t * (WG_F + 1) + fl];
      const uint32_t vm = vmask[t];
#pragma unroll
      for (int tp = 0; tp < MAX_K2; ++tp) {
        if (tp < k2) {
          const bool ok = (vm >> tp) & 1u;
          const float xv = xr[ok ? t + sh[tp] : t];
          part[tp] = fmaf(gv, ok ? xv : 0.f, part[tp]);
        }
      }
    }
#pragma unroll
    for (int tp = 0; tp < MAX_K2; ++tp) acc[tp] += part[tp];
  }
  const int fg = f0 + fl;
  const int cg_ = c0 + cl;
  if (fg < p.f && cg_ < jb.cin) {
#pragma unroll
    for (int tp = 0; tp < MAX_K2; ++tp) {
      if (tp < k2)
        jb.dw[(static_cast<size_t>(fg) * jb.cin + cg_) * k2 + tp] = acc[tp];
    }
  }
}

__global__ void dropout_bits_kernel(const int* seed, uint32_t n,
                                    uint32_t* out) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = dropout_bits(fmix32(static_cast<uint32_t>(*seed)), i);
}

// The shape checks the Python wrapper makes (nn/fused_block.py _plan),
// repeated; fills the slices and returns the shared-memory bytes, 0 if the
// kernels do not take the shape.
size_t plan(BlockParams& p) {
  p.hw = p.h * p.w;
  if ((p.k != 1 && p.k != 3) || p.hw < MIN_HW || p.hw > MAX_HW ||
      THREADS % p.hw != 0 || p.gsz <= 0 || p.c % p.gsz || p.f % p.gsz ||
      p.b <= 0 || p.b > 65535 || p.nc < 1 || p.nc > MAX_CLUSTER ||
      (p.c / p.gsz) % p.nc || (p.f / p.gsz) % p.nc)
    return 0;
  p.fs = p.f / p.nc;
  p.cs = p.c / p.nc;
  const int m = slice_max(p.fs, p.cs);
  if (slot_count(m, THREADS / p.hw) > MAX_OUT) return 0;
  const size_t bytes =
      smem_floats(p.c, p.f, p.hw, p.k, p.gsz, p.fs, p.cs) * sizeof(float);
  return bytes <= MAX_SMEM ? bytes : 0;
}

// The largest dynamic shared memory allowed to `kernel`, raised to MAX_SMEM
// once per device (`done` has a flag per device).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev < 0 || dev >= 64) return err;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(MAX_SMEM));
  done[dev] = err == cudaSuccess;
  return err;
}

bool fwd_smem_set[2][64];
bool bwd_smem_set[2][64];

template <typename Kernel>
cudaError_t launch_cluster(Kernel kernel, bool (&done)[64],
                           const BlockParams& p, size_t smem,
                           cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, done);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nc, p.b, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

BlockParams block_params(int b, int c, int f, int h, int w, int k, int gsz,
                         int nc, const void* x, const void* td,
                         const void* w1, const void* w2, const void* w3,
                         const void* seed, int drop, uint32_t thresh,
                         float scale, float eps) {
  BlockParams p = {};
  p.b = b;
  p.c = c;
  p.f = f;
  p.h = h;
  p.w = w;
  p.k = k;
  p.gsz = gsz;
  p.nc = nc;
  p.x = x;
  p.td = td;
  p.w1 = w1;
  p.w2 = w2;
  p.w3 = w3;
  p.seed = static_cast<const int*>(seed);
  p.drop = drop;
  p.thresh = thresh;
  p.scale = scale;
  p.eps = eps;
  return p;
}

}  // namespace

extern "C" int bla_fused_block_fwd(int dtype, int b, int c, int f, int h,
                                   int w, int k, int gsz, int nc,
                                   const void* x, const void* td,
                                   const void* w1, const void* w2,
                                   const void* w3, const void* seed,
                                   void* out, void* ws_d, int drop,
                                   uint32_t thresh, float scale, float eps,
                                   void* stream) {
  BlockParams p = block_params(b, c, f, h, w, k, gsz, nc, x, td, w1, w2, w3,
                               seed, drop, thresh, scale, eps);
  p.out = out;
  p.ws_d = static_cast<float*>(ws_d);
  const size_t smem = plan(p);
  if (smem == 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_cluster(fused_block_fwd_kernel<float>, fwd_smem_set[0], p,
                            smem, st);
    case kBF16:
      return launch_cluster(fused_block_fwd_kernel<__nv_bfloat16>,
                            fwd_smem_set[1], p, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int bla_fused_block_bwd(int dtype, int b, int c, int f, int h,
                                   int w, int k, int gsz, int nc,
                                   const void* x, const void* td,
                                   const void* w1, const void* w2,
                                   const void* w3, const void* seed,
                                   const void* g, void* dx, void* dtd,
                                   void* ws_a1, void* ws_d, void* ws_dh,
                                   int drop, uint32_t thresh, float scale,
                                   float eps, void* stream) {
  BlockParams p = block_params(b, c, f, h, w, k, gsz, nc, x, td, w1, w2, w3,
                               seed, drop, thresh, scale, eps);
  p.g = g;
  p.out = dx;
  p.dtd = static_cast<float*>(dtd);
  p.ws_a1 = static_cast<float*>(ws_a1);
  p.ws_d = static_cast<float*>(ws_d);
  p.ws_dh = static_cast<float*>(ws_dh);
  const size_t smem = plan(p);
  if (smem == 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_cluster(fused_block_bwd_kernel<float>, bwd_smem_set[0], p,
                            smem, st);
    case kBF16:
      return launch_cluster(fused_block_bwd_kernel<__nv_bfloat16>,
                            bwd_smem_set[1], p, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int bla_fused_block_wgrad(int dtype, int b, int c, int f, int h,
                                     int w, int k, const void* x,
                                     const void* g, const void* ws_a1,
                                     const void* ws_d, const void* ws_dh,
                                     void* dw1, void* dw2, void* dw3,
                                     void* stream) {
  if ((dtype != kF32 && dtype != kBF16) || (k != 1 && k != 3) || h * w <= 0 ||
      h * w > MAX_HW || b <= 0 || c <= 0 || f <= 0)
    return cudaErrorInvalidValue;
  const int bf = dtype == kBF16;
  WgradParams p = {};
  p.b = b;
  p.f = f;
  p.h = h;
  p.w = w;
  p.hw = h * w;
  // dw1 = a1 x dh1t, dw2 = d x g, dw3 = x x g
  p.job[0] = {ws_a1, ws_dh, static_cast<float*>(dw1), 0, 0, c, k};
  p.job[1] = {ws_d, g, static_cast<float*>(dw2), 0, bf, f, k};
  p.job[2] = {x, g, static_cast<float*>(dw3), bf, bf, c, 1};
  const int cmax = c > f ? c : f;
  const dim3 grid((f + WG_F - 1) / WG_F, (cmax + WG_C - 1) / WG_C,
                  dw3 != nullptr ? 3 : 2);
  fused_block_wgrad_kernel<<<grid, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

extern "C" int bla_fused_block_bits(const void* seed, int n, void* out,
                                    void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  dropout_bits_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seed), static_cast<uint32_t>(n),
      static_cast<uint32_t*>(out));
  return cudaGetLastError();
}

extern "C" const char* bla_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

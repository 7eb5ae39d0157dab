// K1: the GEMM with a fused bias + ReLU epilogue, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of big_linear_algebra_tpu/ops/matmul.py:
//   _mm_kernel_2d (full-K 2-D grid, launched by _pallas_mm at :220)
//   _mm_kernel    (K-split 3-D grid with an f32 VMEM scratch accumulator,
//                  launched at :245)
// and their _epilogue. It computes
//   C = op(A) . op(B) (+ bias[n]) (then ReLU), cast to the output type,
// for the variants nn (A (M,K), B (K,N)), nt (A (M,K), B (N,K)) and
// tn (A (K,M), B (K,N)). A and B are read in their stored layout; no
// transpose is materialized (on the TPU the transposes lived in the block
// index maps).
//
// Types: f32 in with true f32 FMA (no TF32, no split into TF32 parts), or
// bf16 in (widened to f32 when staged: exact products, f32 sums); f32 or
// bf16 out. The bias is f32.
//
// What bounds it on the H100. True f32 has no tensor-core path, so a
// product can only use the CUDA cores' FP32 FMA rate (67 TFLOP/s dense at
// 700 W): mnist_nn's first two layers are bound there. At N = 10 (its last
// layer) the work is tiny and the bytes of A bound it. What the design does
// about each:
// - Register tiling. Each thread holds an 8x8 tile of f32 accumulators
//   (8x4 in the thin shape) and, per k, reads its A and B values from
//   shared memory as 128-bit loads: four for 64 FMAs (three for 32). The
//   operands sit k-major in shared memory (As[BK][BM], Bs[BK][BN]). A
//   thread's rows are two 4-row groups 4 * LANES_M apart (its columns
//   likewise), so each 128-bit read of a warp covers contiguous bytes: no
//   bank conflicts.
// - Double buffering. Two shared stages; while tile k is computed, tile
//   k+1 is loaded from global memory into registers, and stored to the
//   other stage after the FMAs: one barrier per 16-deep k step. One
//   mechanism for every layout: an operand whose contiguous axis is the
//   tile's inner axis (nn's and tn's B, tn's A) is stored as a float4; one
//   whose contiguous axis is K (nn's and nt's A, nt's B) is read as
//   4-element vectors along K and stored transposed. bf16 is widened in
//   the same registers, which cp.async could not do. Each 4-element piece
//   is one 16-byte (f32) or 8-byte (bf16) load when the contiguous extent
//   is a multiple of 4 and the pointer is aligned; otherwise (N = 10, the
//   ragged shapes) four element loads, each masked. The entry picks the
//   path per operand.
// - A grid that fills the card. A fixed rule in the C entry (plan) picks
//   the block shape from N: 128x64 tiles of 128 threads, or 128x16 tiles
//   of 64 threads for N <= 16 (N = 10 would waste 54 of 64 columns). K is
//   then split over a thread-block cluster of up to 8 blocks, as far as
//   the grid stays within one block per SM. At layer 1's (M, N, K) =
//   (2048, 256, 784): 64 tiles x 2 splits = 128 blocks of 4 warps. More
//   resident warps were not faster there on the H100 (the split sweep of
//   tools/gemm_flash_fwd_check.py): 4 splits put two blocks on most SMs
//   and took longer, so the rule stops at one block per SM.
// - Deterministic split-K. Each block of a cluster sums its share of the
//   K steps in registers and writes the partial tile to its own shared
//   memory: the f32 workspace is the cluster's distributed shared memory.
//   After a cluster barrier each block takes a slice of the tile and sums
//   the partials of ranks 0, 1, ... in that order, then applies the
//   epilogue once: no float atomics, no counters to reset, no second
//   launch, and two runs are bit-equal. Without a split the cluster is one
//   block and the same path runs.
// - Epilogue in f32: + bias, ReLU that keeps NaN (v < 0 ? 0 : v, like
//   jnp.maximum), cast.
// - Ragged M, N and K are masked in the kernel (out-of-range loads read 0,
//   out-of-range stores are skipped); the wrapper never pads or copies.
//
// C interface (bound with ctypes): bla_matmul returns the launch's error
// (cudaGetLastError() after it); it launches on the given stream and never
// synchronises. bla_matmul_plan, bla_matmul_blocks_per_sm and
// bla_matmul_max_clusters report the rule's choice and the occupancy of
// each kernel; bla_matmul_with_splits takes the K split as an argument,
// for measuring the rule's alternatives.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 16;
constexpr int MAX_SPLITS = 8;
// One block per SM of the H100 SXM: the split rule's target.
constexpr int TARGET_BLOCKS = 132;

enum Variant { kNN = 0, kNT = 1, kTN = 2 };
enum DType { kF32 = 0, kBF16 = 1 };

// Block shapes: each thread holds TM x TN accumulators; a warp is
// LANES_M x LANES_N threads, a block WARPS_M x WARPS_N warps.
struct Wide {  // N > 16: 128 x 64 tiles, 128 threads of 8 x 8
  static constexpr int TM = 8, TN = 8;
  static constexpr int LANES_M = 4, LANES_N = 8;
  static constexpr int WARPS_M = 4, WARPS_N = 1;
  static constexpr int MIN_BLOCKS = 3;
};
struct Thin {  // N <= 16: 128 x 16 tiles, 64 threads of 8 x 4
  static constexpr int TM = 8, TN = 4;
  static constexpr int LANES_M = 8, LANES_N = 4;
  static constexpr int WARPS_M = 2, WARPS_N = 1;
  static constexpr int MIN_BLOCKS = 4;  // 8 capped tn at 128 regs: spills
};

template <class C>
struct Tile {
  static constexpr int THREADS = 32 * C::WARPS_M * C::WARPS_N;
  static constexpr int BM = C::TM * C::LANES_M * C::WARPS_M;
  static constexpr int BN = C::TN * C::LANES_N * C::WARPS_N;
  static constexpr int LDA = BM + 4;  // shared row strides (floats)
  static constexpr int LDB = BN + 4;
  static constexpr int STAGE = 2 * BK * (LDA + LDB);  // both stages, A and B
  static constexpr int RED = BM * BN;                 // the partial tile
  static constexpr int SMEM = STAGE > RED ? STAGE : RED;  // floats, static
  static_assert(C::LANES_M * C::LANES_N == 32, "a warp is 32 lanes");
  static_assert(C::TM % 4 == 0 && C::TN % 4 == 0, "float4 fragments");
};

// Four consecutive elements along an operand's contiguous axis, widened to
// f32; `valid` of them are in range (0..4). vec: one vector load (the
// entry checked extent % 4 == 0 and the alignment, so valid is 0 or 4).
__device__ __forceinline__ void load4(const float* p, int valid, bool vec,
                                      float (&v)[4]) {
  if (vec) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid > 0) x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < valid ? p[j] : 0.f;
  }
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, int valid,
                                      bool vec, float (&v)[4]) {
  if (vec) {
    uint2 u = make_uint2(0u, 0u);
    if (valid > 0) u = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = j < valid ? __bfloat162float(p[j]) : 0.f;
  }
}

// One operand's BK x X tile, staged through registers. K_CONTIG: element
// (x, k) is p[x * ld + k] (stored transposed into shared memory); else
// p[k * ld + x]. ld is the contiguous extent (the operands are
// contiguous).
template <int THREADS, int X, int LD, bool K_CONTIG, typename T>
struct Stager {
  static constexpr int SLOTS = X * BK / 4 / THREADS;
  static_assert(SLOTS * 4 * THREADS == X * BK, "uneven staging");
  float v[SLOTS][4];

  __device__ __forceinline__ void load(const T* __restrict__ p, int ld,
                                       int xdim, int kdim, int x0, int k0,
                                       bool vec) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int e = threadIdx.x + s * THREADS;
      int gx, gk, valid;
      size_t off;
      if (K_CONTIG) {
        gx = x0 + e / (BK / 4);
        gk = k0 + (e % (BK / 4)) * 4;
        valid = gx < xdim ? min(max(kdim - gk, 0), 4) : 0;
        off = static_cast<size_t>(gx) * ld + gk;
      } else {
        gk = k0 + e / (X / 4);
        gx = x0 + (e % (X / 4)) * 4;
        valid = gk < kdim ? min(max(xdim - gx, 0), 4) : 0;
        off = static_cast<size_t>(gk) * ld + gx;
      }
      load4(p + off, valid, vec, v[s]);
    }
  }

  // Into a stage laid out [BK][LD].
  __device__ __forceinline__ void store(float* __restrict__ s_tile) const {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int e = threadIdx.x + s * THREADS;
      if (K_CONTIG) {
        const int x = e / (BK / 4);
        const int kq = (e % (BK / 4)) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) s_tile[(kq + j) * LD + x] = v[s][j];
      } else {
        const int k = e / (X / 4);
        const int xq = (e % (X / 4)) * 4;
        *reinterpret_cast<float4*>(&s_tile[k * LD + xq]) =
            make_float4(v[s][0], v[s][1], v[s][2], v[s][3]);
      }
    }
  }
};

// One block: a BM x BN output tile (blockIdx.x / splits along M,
// blockIdx.y along N) over its cluster rank's share of the K steps.
template <class C, int kVariant, typename TIn>
__global__ void __launch_bounds__(Tile<C>::THREADS, C::MIN_BLOCKS)
    mm_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
              const float* __restrict__ bias, int relu, void* __restrict__ c,
              int out_bf16, int M, int N, int K, int vec_a, int vec_b) {
  using TL = Tile<C>;
  constexpr int BM = TL::BM, BN = TL::BN, LDA = TL::LDA, LDB = TL::LDB;
  constexpr int THREADS = TL::THREADS;
  // A is stored (M, K) for nn and nt (K contiguous), (K, M) for tn;
  // B is stored (K, N) for nn and tn (N contiguous), (N, K) for nt.
  constexpr bool A_KC = kVariant != kTN;
  constexpr bool B_KC = kVariant == kNT;
  __shared__ __align__(16) float smem[TL::SMEM];
  float* As = smem;                 // [2][BK][LDA]
  float* Bs = smem + 2 * BK * LDA;  // [2][BK][LDB]

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int m0 = (blockIdx.x / splits) * BM;
  const int n0 = blockIdx.y * BN;
  const int ksteps = (K + BK - 1) / BK;
  const int t_begin = rank * ksteps / splits;
  const int t_end = (rank + 1) * ksteps / splits;
  const int lda = A_KC ? K : M;
  const int ldb = B_KC ? K : N;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // The thread's rows are 4-row groups 4 * LANES_M apart (columns
  // likewise), so each 128-bit fragment read of a warp covers contiguous
  // bytes: no bank conflicts.
  constexpr int GM = 4 * C::LANES_M;  // row distance between groups
  constexpr int GN = 4 * C::LANES_N;
  const int row0 =
      (warp / C::WARPS_N) * C::TM * C::LANES_M + (lane / C::LANES_N) * 4;
  const int col0 =
      (warp % C::WARPS_N) * C::TN * C::LANES_N + (lane % C::LANES_N) * 4;

  Stager<THREADS, BM, LDA, A_KC, TIn> sa;
  Stager<THREADS, BN, LDB, B_KC, TIn> sb;
  float acc[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.f;

  if (t_begin < t_end) {
    sa.load(a, lda, M, K, m0, t_begin * BK, vec_a);
    sb.load(b, ldb, N, K, n0, t_begin * BK, vec_b);
    sa.store(As);
    sb.store(Bs);
  }
  __syncthreads();
  for (int t = t_begin; t < t_end; ++t) {
    const int cur = (t - t_begin) & 1;
    const bool more = t + 1 < t_end;
    if (more) {  // in flight during the FMAs below
      sa.load(a, lda, M, K, m0, (t + 1) * BK, vec_a);
      sb.load(b, ldb, N, K, n0, (t + 1) * BK, vec_b);
    }
    const float* a_s = As + cur * BK * LDA + row0;
    const float* b_s = Bs + cur * BK * LDB + col0;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ra[C::TM];
      float rb[C::TN];
#pragma unroll
      for (int i = 0; i < C::TM; i += 4) {
        const float4 x =
            *reinterpret_cast<const float4*>(a_s + kk * LDA + i / 4 * GM);
        ra[i] = x.x;
        ra[i + 1] = x.y;
        ra[i + 2] = x.z;
        ra[i + 3] = x.w;
      }
#pragma unroll
      for (int j = 0; j < C::TN; j += 4) {
        const float4 x =
            *reinterpret_cast<const float4*>(b_s + kk * LDB + j / 4 * GN);
        rb[j] = x.x;
        rb[j + 1] = x.y;
        rb[j + 2] = x.z;
        rb[j + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    if (more) {
      sa.store(As + (cur ^ 1) * BK * LDA);
      sb.store(Bs + (cur ^ 1) * BK * LDB);
    }
    __syncthreads();
  }

  // The partial tile into this block's shared memory (the loop ended on a
  // barrier, so the stages are free), then the cluster's sum in rank order.
  float* red = smem;  // [BM][BN]
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; j += 4)
      *reinterpret_cast<float4*>(
          &red[(row0 + i / 4 * GM + i % 4) * BN + col0 + j / 4 * GN]) =
          make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
  cluster.sync();

  constexpr int PIECES = BM * BN / 4;  // float4 pieces of the tile
  float4* red4 = reinterpret_cast<float4*>(red);
  const int p_end = (rank + 1) * PIECES / splits;
  for (int p = rank * PIECES / splits + threadIdx.x; p < p_end;
       p += THREADS) {
    float4 part[MAX_SPLITS];  // all remote loads in flight at once
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q)
      if (q < splits) part[q] = cluster.map_shared_rank(red4, q)[p];
    float4 s = part[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLITS; ++q) {
      if (q < splits) {
        s.x += part[q].x;
        s.y += part[q].y;
        s.z += part[q].z;
        s.w += part[q].w;
      }
    }
    const int m = m0 + p / (BN / 4);
    if (m >= M) continue;
    const float sum[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + (p % (BN / 4)) * 4 + j;
      if (n >= N) continue;
      const float bn = bias != nullptr ? bias[n] : 0.f;
      float v = sum[j] + bn;
      if (relu && v < 0.f) v = 0.f;
      const size_t idx = static_cast<size_t>(m) * N + n;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(c)[idx] = __float2bfloat16(v);
      else
        static_cast<float*>(c)[idx] = v;
    }
  }
  // no block leaves while another may still read its partial tile
  cluster.sync();
}

enum Shape { kWide = 0, kThin = 1 };

struct Plan {
  int shape, mtiles, ntiles, splits;
};

// The fixed rule: the block shape from N, then a split of K over a cluster
// of `splits` blocks, as many as keep the grid within one block per SM (at
// most 8 splits, at least one K step each). At most 132 blocks, every
// cluster of either shape fits at once (the occupancy API's cluster count,
// chip_smoke.py phase 3), so the grid runs in one wave. splits >= 1
// overrides the split, for measuring the rule's alternatives.
Plan plan(int m, int n, int k, int splits = -1) {
  Plan p;
  p.shape = n <= 16 ? kThin : kWide;
  const int bm = p.shape == kThin ? Tile<Thin>::BM : Tile<Wide>::BM;
  const int bn = p.shape == kThin ? Tile<Thin>::BN : Tile<Wide>::BN;
  p.mtiles = (m + bm - 1) / bm;
  p.ntiles = (n + bn - 1) / bn;
  const long long tiles = static_cast<long long>(p.mtiles) * p.ntiles;
  const int ksteps = (k + BK - 1) / BK;
  long long s = splits >= 1 ? splits : TARGET_BLOCKS / tiles;
  if (s > MAX_SPLITS) s = MAX_SPLITS;
  if (s > ksteps) s = ksteps;
  p.splits = s < 1 ? 1 : static_cast<int>(s);
  return p;
}

template <class C, int kVariant, typename TIn>
cudaError_t launch(const Plan& p, const void* a, const void* b,
                   const float* bias, int relu, void* c, int out_bf16, int m,
                   int n, int k, cudaStream_t stream) {
  if (p.ntiles > 65535 ||
      static_cast<long long>(p.mtiles) * p.splits > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int a_extent = kVariant == kTN ? m : k;
  const int b_extent = kVariant == kNT ? k : n;
  const uintptr_t vbytes = 4 * sizeof(TIn);
  const int vec_a =
      a_extent % 4 == 0 && reinterpret_cast<uintptr_t>(a) % vbytes == 0;
  const int vec_b =
      b_extent % 4 == 0 && reinterpret_cast<uintptr_t>(b) % vbytes == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.mtiles * p.splits, p.ntiles, 1);
  cfg.blockDim = dim3(Tile<C>::THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, mm_kernel<C, kVariant, TIn>, static_cast<const TIn*>(a),
      static_cast<const TIn*>(b), bias, relu, c, out_bf16, m, n, k, vec_a,
      vec_b);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kVariant, typename TIn>
cudaError_t launch_plan(const Plan& p, const void* a, const void* b,
                        const float* bias, int relu, void* c, int out_bf16,
                        int m, int n, int k, cudaStream_t stream) {
  if (p.shape == kThin)
    return launch<Thin, kVariant, TIn>(p, a, b, bias, relu, c, out_bf16, m, n,
                                       k, stream);
  return launch<Wide, kVariant, TIn>(p, a, b, bias, relu, c, out_bf16, m, n,
                                     k, stream);
}

template <int kVariant>
cudaError_t launch_typed(const Plan& p, int in_dtype, int out_dtype,
                         const void* a, const void* b, const float* bias,
                         int relu, void* c, int m, int n, int k,
                         cudaStream_t stream) {
  if (out_dtype != kF32 && out_dtype != kBF16) return cudaErrorInvalidValue;
  const int out_bf16 = out_dtype == kBF16;
  if (in_dtype == kF32)
    return launch_plan<kVariant, float>(p, a, b, bias, relu, c, out_bf16, m,
                                        n, k, stream);
  if (in_dtype == kBF16)
    return launch_plan<kVariant, __nv_bfloat16>(p, a, b, bias, relu, c,
                                                out_bf16, m, n, k, stream);
  return cudaErrorInvalidValue;
}

// f(kernel, Tile<C>()) for the kernel of a block shape, variant and input
// type; nothing for a value out of range.
template <class C, int kVariant, class F>
void with_input(int in_dtype, F&& f) {
  if (in_dtype == kF32) f(mm_kernel<C, kVariant, float>, Tile<C>());
  if (in_dtype == kBF16) f(mm_kernel<C, kVariant, __nv_bfloat16>, Tile<C>());
}

template <class C, class F>
void with_variant(int variant, int in_dtype, F&& f) {
  if (variant == kNN) with_input<C, kNN>(in_dtype, f);
  if (variant == kNT) with_input<C, kNT>(in_dtype, f);
  if (variant == kTN) with_input<C, kTN>(in_dtype, f);
}

template <class F>
void with_kernel(int shape, int variant, int in_dtype, F&& f) {
  if (shape == kWide) with_variant<Wide>(variant, in_dtype, f);
  if (shape == kThin) with_variant<Thin>(variant, in_dtype, f);
}

}  // namespace

// The GEMM with the K split over `splits` cluster ranks (1..8); -1 takes
// the rule's choice.
extern "C" int bla_matmul_with_splits(int variant, int in_dtype,
                                      int out_dtype, const void* a,
                                      const void* b, const void* bias,
                                      int relu, void* c, int m, int n, int k,
                                      int splits, void* stream) {
  if (m <= 0 || n <= 0 || k < 0) return cudaErrorInvalidValue;
  const Plan p = plan(m, n, k, splits);
  const float* bias_f32 = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kNN:
      return launch_typed<kNN>(p, in_dtype, out_dtype, a, b, bias_f32, relu,
                               c, m, n, k, s);
    case kNT:
      return launch_typed<kNT>(p, in_dtype, out_dtype, a, b, bias_f32, relu,
                               c, m, n, k, s);
    case kTN:
      return launch_typed<kTN>(p, in_dtype, out_dtype, a, b, bias_f32, relu,
                               c, m, n, k, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int bla_matmul(int variant, int in_dtype, int out_dtype,
                          const void* a, const void* b, const void* bias,
                          int relu, void* c, int m, int n, int k,
                          void* stream) {
  return bla_matmul_with_splits(variant, in_dtype, out_dtype, a, b, bias,
                                relu, c, m, n, k, -1, stream);
}

// The rule's choice for (m, n, k): out[0] the block shape (0 wide, 1 thin),
// out[1] and out[2] the M and N tiles, out[3] the K splits
// (the cluster size); the grid is (out[1] * out[3], out[2]).
extern "C" void bla_matmul_plan(int m, int n, int k, int* out) {
  const Plan p = plan(m, n, k);
  out[0] = p.shape;
  out[1] = p.mtiles;
  out[2] = p.ntiles;
  out[3] = p.splits;
}

// Blocks per SM of the kernel of a block shape (0 wide, 1 thin), variant
// (0 nn, 1 nt, 2 tn) and input type (0 f32, 1 bf16); -1 for another value.
extern "C" int bla_matmul_blocks_per_sm(int shape, int variant,
                                        int in_dtype) {
  int blocks = -1;
  with_kernel(shape, variant, in_dtype, [&](auto kernel, auto tile) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, decltype(tile)::THREADS, 0);
  });
  return blocks;
}

// Clusters of `splits` blocks of that kernel that the card holds at once
// (cudaOccupancyMaxActiveClusters); -1 for a value out of range.
extern "C" int bla_matmul_max_clusters(int shape, int variant, int in_dtype,
                                       int splits) {
  int clusters = -1;
  with_kernel(shape, variant, in_dtype, [&](auto kernel, auto tile) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits * 64, 1, 1);
    cfg.blockDim = dim3(decltype(tile)::THREADS, 1, 1);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  });
  return clusters;
}

extern "C" const char* bla_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

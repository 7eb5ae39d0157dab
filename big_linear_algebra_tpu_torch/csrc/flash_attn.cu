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
// - P is rounded to the input type before the PV product; l sums the
//   unrounded f32 p;
// - all sums are f32; keys past N score -inf.
// The plain PyTorch version is _plain_flash in nn/attention.py. The two
// TPU kernels differ only in whether the K/V rows stay resident in VMEM
// (the TPU chose streaming past a 64 MB budget); here K/V tiles always
// stream through shared memory and nothing is sized by N, so one entry
// stands for both.
//
// What bounds it on the H100. Per score: one D-long dot product, one exp2
// and one D-long update of acc (4·D flops). At the U-Net's D = 16 that is
// 64 flops per exp2, so the exp2 rate (16 per clock per SM) bounds an ideal
// kernel, and the per-score f32 work around each exp2 (max, subtract, sum,
// pack, mask) comes next; at D = 64 the bf16 tensor-core flops do.
//
// bf16, D in {16, 32, 64, 128}: the tensor-core kernel (namespace tc).
// - Both products on mma.sync.m16n8k16 (bf16 in, f32 sums in registers).
//   A warp owns 16 q rows; its q^ = bf16(q * qscale) are A fragments loaded
//   once from global memory (tc::load_a, the rounding of _plain_flash).
//   S = q^ K^T takes K as stored as the "col" B operand (ldmatrix);
//   O += P V takes V through ldmatrix.trans. The m16n8 S accumulators pack
//   (bf16, round to nearest even) into the m16k16 A fragment of P: that
//   packing is the plain version's p.to(q.dtype), and P never touches
//   shared memory.
// - Online softmax in registers, once per staged tile: in the m16n8 C
//   layout a row's values sit in one quad of lanes (c0/c1 row lane/4,
//   c2/c3 row lane/4 + 8, each with its own max, alpha and l); the row max
//   takes shfl_xor 1 and 2. The max is subtracted before exp2, and a row
//   whose keys so far are all masked offsets by 0, so -inf - -inf never
//   occurs. exp2 is the SFU's ex2.approx.ftz, without exp2f's denormal
//   handling (a p below 2^-126 is 0): 12% faster at the train step's
//   (16, 1024, 16) on the H100. At the end the quad sums l; o = acc / l
//   is stored as bf16 and lse = (m + log2 l) / log2(e) by one lane of the
//   quad.
// - K and V are staged as bf16 through a two-slot cp.async ring
//   (tc::stage, rows padded by 16 bytes for ldmatrix), so the next tile's
//   copy overlaps this tile's work. Rows past N are zero-filled and score
//   -inf; only a tile that reaches past N pays for the mask (a second copy
//   of the tile's code). q rows past N read 0 and are not stored. No
//   padding copy.
// - A block is 4 warps x 16 rows = 64 q rows, one block per 64-row q tile:
//   256 blocks at the train step's (16, 1024, 16) and at (4, 4096, 64), 16
//   at the sampler's (1, 1024, 16). The keys are not split over blocks:
//   on the H100 the 16 blocks already beat SDPA at (1, 1024, 16).
// - __launch_bounds__(128, 2): a minimum of blocks per SM keeps ptxas from
//   capping registers and running the tile's chunks in sequence, as in
//   K2c/K2d (flash_attn_bwd.cu); chip_smoke.py phase 5 reports registers,
//   shared memory and spills.
// - Operands must be 16-byte aligned (cp.async and ldmatrix); the entry
//   returns cudaErrorMisalignedAddress otherwise, and the wrapper copies a
//   view that is not.
//
// f32, and bf16 at D in {4, 8}: the FMA kernel below. mma on f32 operands
// would be TF32, and the port keeps f32 true f32; D < 16 stays here rather
// than padding the k16 step. 16 threads of a 256-thread block share a q row:
// G of them split its D dims (a shuffle sums the partial scores) and
// S = 16/G split the keys of each tile; each keeps its own (m, l, acc),
// merged at the end with shuffles (rescaled to the common max). Tiles are
// staged in shared memory as f32 (row stride D+G: distinct banks). Bound by
// the f32 CUDA-core rate and shared memory.
//
// C interface (bound with ctypes): bla_flash_fwd returns the launch's error
// (cudaGetLastError() after it); it launches on the given stream and never
// synchronises. bla_flash_fwd_tc_blocks_per_sm reports the tensor-core
// kernel's occupancy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma_sm80.cuh"

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

// ---- The tensor-core kernel (bf16, D in {16, 32, 64, 128}) ----
namespace tc {

// 2^x on the SFU without the denormal handling of exp2f: a result below
// 2^-126 (a probability that rounds to nothing in any sum here) is 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One staged K/V tile (shared addresses kt, vt) of keys [k0, k0 + BT) for
// a warp's 16 rows: S = q^ K^T, the online-softmax update of (m, l, acc),
// then acc += P V. MASK: the tile reaches past N, so keys >= n score -inf.
template <int D, bool MASK>
__device__ __forceinline__ void fwd_tile(uint32_t kt, uint32_t vt,
                                         const uint32_t (&qa)[D / 16][4],
                                         float (&m)[2], float (&l)[2],
                                         float (&acc)[D / 8][4], int k0,
                                         int n) {
  using G = Geo<D>;
  constexpr int LD = G::LD;
  constexpr int NB = G::BT / 8;  // n8 key tiles
  const int lane = threadIdx.x % 32;
  const uint32_t on = lane_n_major<LD>();
  const uint32_t ok = lane_k_major<LD>();
  float s[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
  for (int j = 0; j < G::CHUNKS; ++j) {
#pragma unroll
    for (int kk = 0; kk < G::KT; ++kk) {
      uint32_t b[4];
      ldsm(b, kt + on + at<LD>(16 * j, 16 * kk));
      mma(s[2 * j], qa[kk], b[0], b[1]);
      mma(s[2 * j + 1], qa[kk], b[2], b[3]);
    }
  }
  if (MASK) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * nb + 2 * (lane % 4) + e % 2 >= n)
          s[nb][e] = -CUDART_INF_F;
  }
  // c0/c1 are row lane/4 (h = 0), c2/c3 row lane/4 + 8 (h = 1)
  float off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      mx = fmaxf(mx, fmaxf(s[nb][2 * h], s[nb][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
    // all keys of the row masked so far: offset by 0, so that exp2 sees
    // -inf - 0 = -inf (giving 0) and never -inf - -inf
    off[h] = mx == -CUDART_INF_F ? 0.f : mx;
    const float alpha = ex2(m[h] - off[h]);
    m[h] = mx;
    l[h] *= alpha;
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      acc[nt][2 * h] *= alpha;
      acc[nt][2 * h + 1] *= alpha;
    }
  }
#pragma unroll
  for (int j = 0; j < G::CHUNKS; ++j) {
    uint32_t pa[4];  // P (bf16) of 16 keys as the A fragment of acc += P V
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = ex2(s[2 * j + t][2 * h] - off[h]);
        const float p1 = ex2(s[2 * j + t][2 * h + 1] - off[h]);
        l[h] += p0 + p1;
        pa[2 * t + h] = pack(p0, p1);
      }
    }
#pragma unroll
    for (int np = 0; np < G::KT; ++np) {
      uint32_t b[4];
      ldsm_trans(b, vt + ok + at<LD>(16 * j, 16 * np));
      mma(acc[2 * np], pa, b[0], b[1]);
      mma(acc[2 * np + 1], pa, b[2], b[3]);
    }
  }
}

// K2 on the tensor cores: one block of 64 q rows (16 per warp) over all
// the key tiles.
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
    flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int n, float sscale) {
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
  load_a<D, true>(qa, q, base, r0, n, sscale);
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
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
      fwd_tile<D, false>(ks0 + cur, vs0 + cur, qa, m, l, acc, t * G::BT, n);
    else
      fwd_tile<D, true>(ks0 + cur, vs0 + cur, qa, m, l, acc, t * G::BT, n);
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL_MASK, l[h], 1);
    l[h] += __shfl_xor_sync(FULL_MASK, l[h], 2);
    const int r = r0 + lane / 4 + 8 * h;
    if (r >= n) continue;
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      const int col = nt * 8 + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(o + base + static_cast<size_t>(r) * D +
                                   col) =
          pack(acc[nt][2 * h] / l[h], acc[nt][2 * h + 1] / l[h]);
    }
    if (lane % 4 == 0) lse[sbase + r] = (m[h] + log2f(l[h])) / LOG2E;
  }
}

template <int D>
cudaError_t launch(int b, int n, const void* q, const void* k, const void* v,
                   void* o, float* lse, float qscale, cudaStream_t stream) {
  const void* ptrs[] = {q, k, v, o};
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;
  }
  flash_fwd_tc<D><<<dim3((n + ROWS - 1) / ROWS, b), THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, n, qscale);
  return cudaGetLastError();
}

}  // namespace tc

// bf16 at D >= 16 on the tensor cores; the rest on the FMA kernel.
template <int D, typename T>
cudaError_t launch(int b, int n, const void* q, const void* k, const void* v,
                   void* o, float* lse, float qscale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && D >= 16) {
    return tc::launch<D>(b, n, q, k, v, o, lse, qscale, stream);
  } else {
    const dim3 grid((n + BQ - 1) / BQ, b);
    flash_fwd_kernel<D, T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, n, qscale);
    return cudaGetLastError();
  }
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

// Blocks per SM of the tensor-core kernel for head dim d (16, 32, 64 or
// 128); -1 for another d.
extern "C" int bla_flash_fwd_tc_blocks_per_sm(int d) {
  int blocks = -1;
  auto query = [&](auto kernel) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                  tc::THREADS, 0);
  };
  switch (d) {
    case 16:
      query(tc::flash_fwd_tc<16>);
      break;
    case 32:
      query(tc::flash_fwd_tc<32>);
      break;
    case 64:
      query(tc::flash_fwd_tc<64>);
      break;
    case 128:
      query(tc::flash_fwd_tc<128>);
      break;
    default:
      break;
  }
  return blocks;
}

extern "C" const char* bla_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K4: the implicit-GEMM "same" convolution (stride 1, odd k), for NVIDIA
// Hopper (sm_90a).
//
// Replaces both TPU kernels of big_linear_algebra_tpu/nn/conv_implicit.py:
//   _conv_kernel        (K4a, launched at :85 by _conv_fwd_pallas)
//   _conv_packed_kernel (K4b, launched at :171 by _conv_fwd_packed)
// -> conv_implicit_kernel. Both compute, on x (B, C, H, W) and w (F, C, k, k),
//   out[b, f, h, w] = sum_{c, i, j} w[f, c, i, j] * x[b, c, h + i - k/2,
//                                                     w + j - k/2]
// with zero padding ("same", symmetric at stride 1), f32 sums, cast to the
// output type: out (B, F, H, W). The plain PyTorch version is _plain_conv
// in nn/conv_implicit.py (the k^2 tap sum); dx runs this kernel too, on the
// gradient with the flipped, channel-transposed weights.
//
// Design. The TPU kernels hold an example's (C, H*W) block (K4a) or the
// whole batch packed as (C, B*H*W) (K4b) in VMEM and sum k^2 tap GEMMs on
// rolled, masked copies; K4b packs the batch only to fill the TPU's 128
// lanes at small H*W. Here the GEMM is out (F, B*H*W) = w (F, C*k^2) .
// patches (C*k^2, B*H*W), the patches never stored:
// - One block per 64x64 output tile: 64 output channels by 64 output
//   positions of the flattened B*H*W axis. A tile over B*H*W fills a block at
//   any H*W, which is what K4b's packing was for, so one kernel stands for
//   both.
// - Each reduction step stages a 64x16 strip of w (its contiguous C*k^2
//   axis) and the matching 16x64 strip of patches in shared memory as f32.
//   A patch element is an indexed load of x with a border mask (no roll,
//   so nothing reads across examples, which the packed TPU kernel had to
//   mask); each thread stages one fixed output position, whose (b, h, w) it
//   computes once, and neighbouring threads read neighbouring pixels.
// - 256 threads, each a 4x4 tile of f32 accumulators; ragged F, B*H*W and
//   C*k^2 are masked (out-of-range loads read 0, stores are skipped).
//
// Types: f32 in with true f32 FMA (no TF32), or bf16 in (exact products in
// f32, f32 accumulation); f32 or bf16 out.
//
// What bounds it on the H100: 2*B*F*H*W*C*k^2 flops. At the U-Net's
// (16, 128, 32x32) in bf16 the tensor cores would need 4.9 us; this first
// version runs every product as an FP32 FMA on the CUDA cores (a
// shared-memory GEMM, 2 loads per 16 FMAs), and also gathers each patch
// element from L2 once per output-channel tile. wgmma on a shared-memory
// im2col tile staged with cp.async / TMA is the next step.
//
// C interface (bound with ctypes): bla_conv_implicit returns
// cudaGetLastError() after its launch; it launches on the given stream and
// never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int BM = 64;  // output channels per block
constexpr int BN = 64;  // output positions per block
constexpr int BK = 16;  // reduction steps (c, i, j) per stage
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int ROW_THREADS = BM / TM;  // 16
constexpr int COL_THREADS = BN / TN;  // 16
constexpr int THREADS = ROW_THREADS * COL_THREADS;  // 256
static_assert(THREADS % BN == 0, "a thread stages one fixed position");

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS)
    conv_implicit_kernel(const TIn* __restrict__ x, const TIn* __restrict__ w,
                         TOut* __restrict__ out, int B, int C, int H, int W,
                         int F, int ks) {
  // +1 column: spreads the column-wise staging writes over the banks
  __shared__ float As[BK][BM + 1];  // weights: (step, output channel)
  __shared__ float Bs[BK][BN + 1];  // patches: (step, output position)

  const int tid = threadIdx.x;
  const int tx = tid % COL_THREADS;
  const int ty = tid / COL_THREADS;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int hw = H * W;
  const int P = B * hw;
  const int k2 = ks * ks;
  const int K = C * k2;
  const int half = ks / 2;

  // the output position this thread stages at every step
  const int pn = tid % BN;
  const int gp = n0 + pn;
  const bool p_ok = gp < P;
  const int pb = p_ok ? gp / hw : 0;
  const int ph = p_ok ? (gp % hw) / W : 0;
  const int pw = p_ok ? gp % W : 0;
  const TIn* xb = x + static_cast<size_t>(pb) * C * hw;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int kk = idx % BK;
      const int mm = idx / BK;
      const int gf = m0 + mm;
      const int gk = k0 + kk;
      As[kk][mm] = gf < F && gk < K
                       ? to_f32(w[static_cast<size_t>(gf) * K + gk])
                       : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (BN * BK) / THREADS; ++r) {
      const int kk = tid / BN + r * (THREADS / BN);
      const int gk = k0 + kk;
      float val = 0.f;
      if (p_ok && gk < K) {
        const int c = gk / k2;
        const int tap = gk - c * k2;
        const int ti = tap / ks;
        const int ih = ph + ti - half;
        const int iw = pw + (tap - ti * ks) - half;
        if (ih >= 0 && ih < H && iw >= 0 && iw < W)
          val = to_f32(xb[(static_cast<size_t>(c) * H + ih) * W + iw]);
      }
      Bs[kk][pn] = val;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ra[TM];
      float rb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ra[i] = As[kk][ty + i * ROW_THREADS];
#pragma unroll
      for (int j = 0; j < TN; ++j) rb[j] = Bs[kk][tx + j * COL_THREADS];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int p = n0 + tx + j * COL_THREADS;
    if (p >= P) continue;
    const int b = p / hw;
    const int s = p % hw;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int f = m0 + ty + i * ROW_THREADS;
      if (f >= F) continue;
      store(&out[(static_cast<size_t>(b) * F + f) * hw + s], acc[i][j]);
    }
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* x, const void* w, void* out, int b, int c,
                   int h, int wd, int f, int ks, cudaStream_t stream) {
  const long long p = static_cast<long long>(b) * h * wd;
  const long long k = static_cast<long long>(c) * ks * ks;
  if (p > INT_MAX || k > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((p + BN - 1) / BN), (f + BM - 1) / BM);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  conv_implicit_kernel<TIn, TOut><<<grid, THREADS, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<const TIn*>(w),
      static_cast<TOut*>(out), b, c, h, wd, f, ks);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bla_conv_implicit(int in_dtype, int out_dtype, const void* x,
                                 const void* w, void* out, int b, int c,
                                 int h, int wd, int f, int ks, void* stream) {
  if (b <= 0 || c <= 0 || h <= 0 || wd <= 0 || f <= 0 || ks <= 0 ||
      ks % 2 == 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kF32 && out_dtype == kF32)
    return launch<float, float>(x, w, out, b, c, h, wd, f, ks, s);
  if (in_dtype == kF32 && out_dtype == kBF16)
    return launch<float, __nv_bfloat16>(x, w, out, b, c, h, wd, f, ks, s);
  if (in_dtype == kBF16 && out_dtype == kF32)
    return launch<__nv_bfloat16, float>(x, w, out, b, c, h, wd, f, ks, s);
  if (in_dtype == kBF16 && out_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, b, c, h, wd, f, ks,
                                                 s);
  return cudaErrorInvalidValue;
}

extern "C" const char* bla_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Warp-level tensor-core helpers for Hopper (sm_90a), shared by the
// bf16 flash-attention kernels: the forward (flash_attn.cu) and the
// two-pass backward (flash_attn_bwd.cu).
//
// - cp.async copies global -> shared (16- and 4-byte pieces, zero-filled
//   past the end) with commit, and waits for all but one group;
// - ldmatrix (.x4, and .trans) for B fragments from padded shared tiles;
// - mma.sync.m16n8k16 bf16 x bf16 -> f32, and the packing of two f32
//   values into a bf16 pair (round to nearest even);
// - load_a: a warp's m16k16 A fragments of 16 rows straight from global
//   memory, optionally as q^ = bf16(q * sscale);
// - stage: rows of two (n, D) matrices into a two-slot ring, rows padded
//   by 16 bytes so that ldmatrix's eight rows fall on distinct banks.
// Geo<D> fixes the staged tile (BT rows of stride LD) per head dim; a block
// is WARPS warps, each owning 16 rows.
//
// Everything here is internal to the translation unit that includes it
// (an anonymous namespace), so each kernel library keeps its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {
namespace tc {
using bf16 = __nv_bfloat16;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;  // output rows per block

template <int D>
struct Geo {
  static constexpr int BT = D <= 64 ? 64 : 32;  // rows per staged tile
  static constexpr int LD = D + 8;              // shared row stride (bf16)
  static constexpr int KT = D / 16;             // k16 steps over d
  static constexpr int NT = D / 8;              // n8 tiles over d
  static constexpr int CHUNKS = BT / 16;        // 16-row chunks per tile
  static constexpr int CPR = D / 8;             // 16-byte pieces per row
  static_assert(D % 16 == 0 && D <= 128, "unsupported head dim");
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (src-size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when !ok.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ldmatrix.x4 at a shared-space address: lane l gives row l % 8 of matrix
// l / 8.
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a . b on the tensor cores: a 16x16 (row), b 16x8 (col), c 16x8 f32.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// Two bf16 values scaled in f32 and rounded back: the forward's q^.
__device__ __forceinline__ uint32_t scale2(uint32_t w, float sscale) {
  return pack(__fmul_rn(__uint_as_float(w << 16), sscale),
              __fmul_rn(__uint_as_float(w & 0xffff0000u), sscale));
}

// Byte offsets of ldmatrix's lane addresses in a staged tile of row stride
// LD, for the 16x16 block at (0, 0); block (row0, col0) adds at<LD>(row0,
// col0). n-major: B fragments of two n8 tiles (rows = n) of one k16 step
// (columns = k): r[0..1] rows 0-7, r[2..3] rows 8-15. k-major, with .trans:
// B fragments of one k16 step (rows = k) for two n8 tiles (columns = n):
// r[0..1] columns 0-7, r[2..3] columns 8-15.
template <int LD>
__device__ __forceinline__ uint32_t lane_n_major() {
  const int l = threadIdx.x % 32;
  return ((l % 8 + (l / 16) * 8) * LD + ((l / 8) % 2) * 8) * 2;
}
template <int LD>
__device__ __forceinline__ uint32_t lane_k_major() {
  const int l = threadIdx.x % 32;
  return ((l % 8 + ((l / 8) % 2) * 8) * LD + (l / 16) * 8) * 2;
}
template <int LD>
__device__ __forceinline__ constexpr uint32_t at(int row0, int col0) {
  return (row0 * LD + col0) * 2;
}

// The m16k16 A fragments of rows [r0, r0 + 16) of an (n, D) matrix, from
// global memory (rows past n read 0); with SCALE, as the forward's q^.
template <int D, bool SCALE>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4],
                                       const bf16* __restrict__ x,
                                       size_t base, int r0, int n,
                                       float sscale) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kt = 0; kt < D / 16; ++kt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + lane / 4 + (i % 2) * 8;
      const int col = kt * 16 + 2 * (lane % 4) + (i / 2) * 8;
      uint32_t w = 0;
      if (r < n) {
        w = *reinterpret_cast<const uint32_t*>(
            x + base + static_cast<size_t>(r) * D + col);
        if (SCALE) w = scale2(w, sscale);
      }
      a[kt][i] = w;
    }
  }
}

// Stage rows [r0, r0 + BT) of two (n, D) matrices into a ring slot at
// shared addresses as, bs.
template <int D>
__device__ __forceinline__ void stage(const bf16* __restrict__ a,
                                      const bf16* __restrict__ b, uint32_t as,
                                      uint32_t bs, size_t base, int r0,
                                      int n) {
  using G = Geo<D>;
  static_assert(G::BT * G::CPR % THREADS == 0, "uneven staging");
#pragma unroll
  for (int i = 0; i < G::BT * G::CPR / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / G::CPR;
    const int c = (e % G::CPR) * 8;
    const bool ok = r0 + r < n;
    const size_t off = ok ? base + static_cast<size_t>(r0 + r) * D + c : 0;
    cp_async16(as + at<G::LD>(r, c), a + off, ok);
    cp_async16(bs + at<G::LD>(r, c), b + off, ok);
  }
}

}  // namespace tc
}  // namespace

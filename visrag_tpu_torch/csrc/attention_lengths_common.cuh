// Shared pieces of the valid-length attention kernels (attention_lengths.cu,
// the forward, and attention_lengths_bwd.cu, its backward): tile geometry,
// the mma.sync m16n8k16 product, fragment loads from shared memory and the
// cp.async tile copy.
//
// Fragment layouts of mma.sync.m16n8k16 (bf16 in, fp32 accumulate), for
// lane = 4 * g + t:
//   A (16 x 16, row-major):  a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                            a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, column):      b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C (16 x 8, fp32):        c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace visrag {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NWARPS = 4;     // each warp owns 16 rows of the block's tile
constexpr int NTHREADS = NWARPS * 32;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// log-sum-exp of a row with no valid key: the JAX kernel's +LARGE sentinel
// (-DEFAULT_MASK_VALUE), so that exp(s - lse) underflows to exactly 0
constexpr float LSE_PAD = 0.7f * 3.4028234663852886e38f;

template <int D>
struct Tile {
  static constexpr int DP = (D + 15) / 16 * 16;  // head dim padded to k16
  static constexpr int KSTEPS = DP / 16;          // k steps over the head dim
  static constexpr int NT = DP / 8;               // n8 tiles over the head dim
  static constexpr int CH = D / 8;                // 16-byte chunks per row
  static constexpr int LDH = DP + 8;              // bf16 row pitch (no bank
                                                  // conflicts on fragments)
  static constexpr size_t TILE_BYTES = size_t(64) * LDH * 2;
};

__device__ __forceinline__ uint4 zero4() { return make_uint4(0, 0, 0, 0); }

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b for one m16n8k16 tile: a row-major 16x16, b column-major 16x8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane L gives the
// address of row L%8 of matrix L/8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a row-major
// shared tile with pitch ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* base, int ld,
                                       int r0, int c0, int g, int t) {
  const __nv_bfloat16* p = base + (r0 + g) * ld + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment (k16 x n8) read from a shared tile stored [n][k] row-major (the
// K tile of Q K^T): n in [n0, n0 + 8), k in [k0, k0 + 16).
__device__ __forceinline__ void load_b_nk(uint32_t& b0, uint32_t& b1,
                                          const __nv_bfloat16* base, int ld,
                                          int n0, int k0, int g, int t) {
  const __nv_bfloat16* p = base + (n0 + g) * ld + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B fragments of two n8 tiles (n in [n0, n0 + 16), k in [k0, k0 + 16)) read
// from a shared tile stored [k][n] row-major (the V tile of P V), through
// ldmatrix.trans: b[0], b[1] for n0, b[2], b[3] for n0 + 8.
__device__ __forceinline__ void load_b_kn_x2(uint32_t (&b)[4],
                                             const __nv_bfloat16* base, int ld,
                                             int k0, int n0, int lane) {
  const int mat = lane >> 3;
  ldmatrix_x4_trans(
      b, base + (k0 + (mat & 1) * 8 + (lane & 7)) * ld + n0 + (mat >> 1) * 8);
}

// 16-byte global -> shared copy that does not hold the thread; with
// valid == false it reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Starts copying rows [r0, r0 + 64) of one head into a shared tile; rows at
// or past `limit` become zeros. Pad columns [D, DP) are zeroed once up front
// by the caller.
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long row_stride, int r0,
                                                int limit) {
  using T = Tile<D>;
  for (int idx = threadIdx.x; idx < 64 * T::CH; idx += NTHREADS) {
    const int r = idx / T::CH, c = idx % T::CH;
    const int row = r0 + r;
    const bool valid = row < limit;
    cp_async16(dst + r * T::LDH + c * 8,
               valid ? src + row * row_stride + c * 8 : src, valid);
  }
}

// Zeroes `bytes` (a multiple of 16) of shared memory from `smem`.
__device__ __forceinline__ void zero_smem(unsigned char* smem, size_t bytes) {
  for (size_t i = threadIdx.x; i < bytes / 16; i += NTHREADS)
    reinterpret_cast<uint4*>(smem)[i] = zero4();
}

// Writes zeros to rows [r0, min(r0 + 64, seq)) of one head (D columns).
template <int D>
__device__ __forceinline__ void store_zero_rows(__nv_bfloat16* dst,
                                                long long row_stride, int r0,
                                                int seq) {
  using T = Tile<D>;
  for (int idx = threadIdx.x; idx < 64 * T::CH; idx += NTHREADS) {
    const int r = idx / T::CH, c = idx % T::CH;
    if (r0 + r < seq)
      *reinterpret_cast<uint4*>(dst + (r0 + r) * row_stride + c * 8) = zero4();
  }
}

}  // namespace visrag

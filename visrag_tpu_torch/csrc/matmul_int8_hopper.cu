// w8a8 GEMM with a fused dequantizing epilogue for Hopper (sm_90a), K6 on
// wgmma s8 and TMA.
//
// Replaces the TPU kernel `_kernel` in visrag_tpu/ops/matmul_int8.py
// (launched by int8_matmul_fused), which the encode towers' int8
// configuration (SiglipViTConfig.quant / MiniCPMConfig.quant = "int8")
// runs for the ViT's fused qkv and fc1 and the LM's q/k/v/o and gate/up:
//
//   out[m, n] = float(sum_k xq[m, k] * wq[n, k]) * xs[m] * ws[n] + bias[n]
//
// as bf16 or fp32. xq (M, K) int8 row-major, wq (N, K) int8 row-major
// (torch's (out, in) weight), xs (M,) and ws (N,) fp32, bias (N,) fp32 or
// null. The int32 sum is exact and the epilogue runs in fp32 in the order
// written with no fused multiply-add (__fmul_rn, __fadd_rn), so every output
// is bit-equal to the plain version (ops/matmul_int8.py
// int8_matmul_reference). Any M and N; K is the row pitch in bytes, a
// multiple of 16 (TMA's stride unit; the wrapper zero-pads it, and zero
// codes add nothing).
//
// What bounds it on the H100: operations. The ViT's qkv GEMM (126,208 x
// 1152 -> 3456) is 1.0e12 int8 operations, 0.51 ms at the 1979 TOP/s dense
// int8 peak, against 0.30 ms for its bytes at 3.35 TB/s; the LM's GEMMs
// (K = 2304) lean further to operations. The full int8 rate is reached only
// through wgmma fed from shared memory. The design (the Hopper core of
// hopper.cuh, as the attention kernels use it):
//
//   * A block owns a 128 x 256 output tile: two consumer warpgroups of 64 x
//     256 each (wgmma m64n256k32 s8 x s8 -> s32, both operands K-major in
//     shared memory: xq's rows and wq's rows, the layouts K6 already has),
//     128 s32 accumulators a thread, and a producer warpgroup of which one
//     thread issues the TMA loads (setmaxnreg 40 / 232).
//   * K streams through a 4-stage ring of 128-byte K slices (a 16 KB A tile
//     and a 32 KB B tile a stage, the 128-byte swizzle), full / empty
//     mbarriers; a consumer keeps one stage's four k32 products in flight
//     and releases the stage before it. A 128 x 256 tile with a 128-byte K
//     stage does 8.4 M operations per 48 KB read from L2.
//   * One block a tile, the column tile fastest, so that the blocks of a
//     wave share their A rows in L2. A persistent grid (min(tiles, SMs)
//     blocks walking the tiles, the producer loading the next tile while
//     the consumers store the last) measured slower at the ViT's shapes and
//     faster at the LM's, no gain over the encode, and was not kept.
//   * The epilogue stores through shared memory: a warpgroup writes its
//     dequantized outputs, 256 bytes of each of its 64 rows a pass, into a
//     16 KB staging tile (16-byte chunks XOR-swizzled by row, so the
//     fragment stores do not conflict), then copies it out in whole
//     16-byte chunks, each warp two 256-byte row pieces an instruction.
//     Stored straight from the fragments (16 bytes of each of 8 rows a warp
//     instruction) the outputs made the ViT qkv GEMM half again as slow on
//     the H100 (PERF.md).
//   * TMA zero-fills the loads past M, N and K; the epilogue reads xs, ws and
//     bias from device memory and masks the M and N tails at the store
//     (single outputs where a row's pitch is not a multiple of 16 bytes).
//
// A tensor map cuTensorMapEncodeTiled refuses is an error code (-1), never
// another path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace visrag::hopper;

constexpr int BM = 128;                  // output rows a block
constexpr int BN = 256;                  // output columns a block (m64n256)
constexpr int BK = 128;                  // K bytes a stage
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;             // consumer warpgroups, 64 rows each
constexpr int PRODUCER = 128 * CONSUMERS;
constexpr int THREADS = PRODUCER + 128;
// registers a thread: 40 x 128 + 2 x 232 x 128 = 64,512 of the 65,536
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int TMA_ENCODE_FAILED = -1;
constexpr int SA = BM * BK;              // bytes of an A stage
constexpr int SB = BN * BK;              // bytes of a B stage
constexpr int PASS = 256;                // bytes of an output row a pass
constexpr int SOUT = 64 * PASS;          // a warpgroup's staging tile
constexpr size_t SMEM_BYTES =
    1024 + STAGES * (SA + SB) + CONSUMERS * SOUT + 2 * STAGES * 8;

// One output of the epilogue: float(acc) * x * w (+ b), rounded as written.
__device__ __forceinline__ float dequant(int acc, float x, float w,
                                         const float* bias, float b) {
  const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), x), w);
  return bias ? __fadd_rn(y, b) : y;
}

// Byte offset of 16-byte chunk c of staging row r: the chunk index XORed
// with r % 8, so that the 8 rows a warp's fragment store touches land on
// distinct banks.
__device__ __forceinline__ int stage_at(int r, int c) {
  return r * PASS + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void wg_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
}

template <bool F32>
__global__ void __launch_bounds__(THREADS, 1)
int8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_b,
                       const float* __restrict__ xs,
                       const float* __restrict__ ws,
                       const float* __restrict__ bias, void* __restrict__ out,
                       int M, int N, int K, int tiles_n) {
  using T = typename std::conditional<F32, float, __nv_bfloat16>::type;
  constexpr int ES = sizeof(T);
  constexpr int COLS = PASS / ES;        // output columns a pass
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sA = smem;                          // STAGES A tiles
  unsigned char* sB = sA + STAGES * SA;              // STAGES B tiles
  unsigned char* sOut = sB + STAGES * SB;            // a staging tile a WG
  uint64_t* full = reinterpret_cast<uint64_t*>(sOut + CONSUMERS * SOUT);
  uint64_t* empty = full + STAGES;
  const int kt = (K + BK - 1) / BK;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= PRODUCER) {
    // ---- producer: one thread issues every load
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != PRODUCER) return;
    tma_prefetch(&tm_a);
    tma_prefetch(&tm_b);
    Ring<STAGES> ring;
    for (int k = 0; k < kt; ++k) {
      mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
      mbar_arrive_expect_tx(&full[ring.stage], SA + SB);
      tma_load_2d(sA + ring.stage * SA, &tm_a, &full[ring.stage], k * BK, m0);
      tma_load_2d(sB + ring.stage * SB, &tm_b, &full[ring.stage], k * BK, n0);
      ring.advance();
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows [64 cw, 64 cw + 64) of the tile
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  unsigned char* stage_out = sOut + cw * SOUT;
  // rows 16 warp + g and + 8 of the warpgroup's 64 hold columns
  // 8 j + 2 t4 + {0, 1} of the accumulator (the wgmma C layout)
  const int r_lo = 16 * warp + g, r_hi = r_lo + 8;
  const bool vec = (static_cast<long long>(N) * ES) % 16 == 0;
  Ring<STAGES> ring;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int prev = -1;
  for (int k = 0; k < kt; ++k) {
    mbar_wait(&full[ring.stage], ring.phase);
    // this warpgroup's 64 rows of A and the tile's BN rows of B, K-major:
    // 8-row groups 1024 bytes apart, a k32 step +32 bytes
    const uint64_t a_desc = make_desc(
        opaque(smem_u32(sA) + ring.stage * SA + cw * 64 * BK), 16, 1024);
    const uint64_t b_desc =
        make_desc(opaque(smem_u32(sB) + ring.stage * SB), 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_m64n256k32_s8_ss(acc, desc_add(a_desc, 32 * kk),
                             desc_add(b_desc, 32 * kk), 1);
    wgmma_commit();
    // the previous stage's products are done once one group is left in
    // flight: release its stage to the producer
    wgmma_wait<1>();
    if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
    prev = ring.stage;
    ring.advance();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);

  // epilogue, PASS bytes of each row at a time: the dequantized outputs
  // into the warpgroup's staging tile, then out in whole 16-byte chunks,
  // a warp two 256-byte row pieces an instruction
  const int row0 = m0 + 64 * cw;
  const float x_lo = row0 + r_lo < M ? xs[row0 + r_lo] : 0.f;
  const float x_hi = row0 + r_hi < M ? xs[row0 + r_hi] : 0.f;
#pragma unroll
  for (int p = 0; p < BN / COLS; ++p) {
    if (p > 0) wg_sync(cw);            // the last pass is copied out
#pragma unroll
    for (int jj = 0; jj < COLS / 8; ++jj) {
      const int j = p * (COLS / 8) + jj;
      const int col = n0 + 8 * j + 2 * t4;
      const float w0 = col < N ? ws[col] : 0.f;
      const float w1 = col + 1 < N ? ws[col + 1] : 0.f;
      const float b0 = bias && col < N ? bias[col] : 0.f;
      const float b1 = bias && col + 1 < N ? bias[col + 1] : 0.f;
      const float y00 = dequant(acc[4 * j], x_lo, w0, bias, b0);
      const float y01 = dequant(acc[4 * j + 1], x_lo, w1, bias, b1);
      const float y10 = dequant(acc[4 * j + 2], x_hi, w0, bias, b0);
      const float y11 = dequant(acc[4 * j + 3], x_hi, w1, bias, b1);
      if constexpr (F32) {
        // 32 bytes of a row a j: chunks 2 jj and 2 jj + 1
        const int c = 2 * jj + (t4 >> 1), off = (t4 & 1) * 8;
        *reinterpret_cast<float2*>(stage_out + stage_at(r_lo, c) + off) =
            make_float2(y00, y01);
        *reinterpret_cast<float2*>(stage_out + stage_at(r_hi, c) + off) =
            make_float2(y10, y11);
      } else {
        // 16 bytes of a row a j: chunk jj
        *reinterpret_cast<__nv_bfloat162*>(stage_out + stage_at(r_lo, jj) +
                                           4 * t4) =
            __floats2bfloat162_rn(y00, y01);
        *reinterpret_cast<__nv_bfloat162*>(stage_out + stage_at(r_hi, jj) +
                                           4 * t4) =
            __floats2bfloat162_rn(y10, y11);
      }
    }
    wg_sync(cw);                       // the staging tile is written
    constexpr int E = 16 / ES;         // outputs a chunk
#pragma unroll
    for (int i = 0; i < 64 * (PASS / 16) / 128; ++i) {
      const int idx = tid + 128 * i;
      const int r = idx / (PASS / 16), c = idx % (PASS / 16);
      const int row = row0 + r, col = n0 + p * COLS + c * E;
      if (row >= M || col >= N) continue;
      const uint4 v =
          *reinterpret_cast<const uint4*>(stage_out + stage_at(r, c));
      T* dst = static_cast<T*>(out) + static_cast<long long>(row) * N + col;
      if (vec && col + E <= N) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const T* e = reinterpret_cast<const T*>(&v);
        for (int q = 0; q < E && col + q < N; ++q) dst[q] = e[q];
      }
    }
  }
}

template <bool F32>
int launch(const void* xq, const void* wq, const float* xs, const float* ws,
           const float* bias, void* out, int M, int N, int K,
           cudaStream_t stream) {
  CUtensorMap ta, tb;
  if (!encode_u8_2d(&ta, xq, M, K, K, BM) ||
      !encode_u8_2d(&tb, wq, N, K, K, BN))
    return TMA_ENCODE_FAILED;
  const int tiles_n = (N + BN - 1) / BN;
  const long long tiles = static_cast<long long>((M + BM - 1) / BM) * tiles_n;
  if (tiles > 0x7fffffff) return int(cudaErrorInvalidValue);
  auto kernel = int8_gemm_wgmma_kernel<F32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  kernel<<<static_cast<int>(tiles), THREADS, SMEM_BYTES, stream>>>(
      ta, tb, xs, ws, bias, out, M, N, K, tiles_n);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. xq (M, K) and wq (N, K) int8 row-major
// with K a multiple of 16 and 16-byte-aligned bases; xs (M,), ws (N,) and
// bias (N,) fp32 (bias may be null); out (M, N) bf16, or fp32 when out_f32
// is 1, 16-byte aligned. Returns a cudaError_t (0 = launched), or -1 when
// cuTensorMapEncodeTiled refused a tensor map.
extern "C" int visrag_int8_gemm_hopper(const void* xq, const void* wq,
                                       const void* xs, const void* ws,
                                       const void* bias, void* out, int M,
                                       int N, int K, int out_f32,
                                       void* stream) {
  if (M < 0 || N < 0 || K <= 0 || K % 16) return int(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return int(cudaSuccess);
  const float* x = static_cast<const float*>(xs);
  const float* w = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch<true>(xq, wq, x, w, b, out, M, N, K, s)
                 : launch<false>(xq, wq, x, w, b, out, M, N, K, s);
}

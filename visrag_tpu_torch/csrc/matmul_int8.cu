// w8a8 GEMM with a fused dequantizing epilogue for Hopper (sm_90a), K6.
//
// Replaces the TPU kernel `_kernel` in visrag_tpu/ops/matmul_int8.py
// (launched by int8_matmul_fused), which the encode towers' int8
// configuration (SiglipViTConfig.quant / MiniCPMConfig.quant = "int8")
// runs for the ViT's fused qkv and fc1 and the LM's q/k/v/o and gate/up:
//
//   out[m, n] = bf16( float(sum_k xq[m, k] * wq[n, k]) * xs[m] * ws[n]
//                     + bias[n] )
//
// xq (M, K) int8 row-major, wq (N, K) int8 row-major (torch's (out, in)
// weight: the K-major B operand of the tensor-core product, so no
// transpose), xs (M,) and ws (N,) fp32 scales, bias (N,) fp32 or null; the
// int32 sum is exact and the epilogue runs in fp32 in the order written
// (no fused multiply-add, so it rounds as the plain version does). K is a
// multiple of 64 (the wrapper zero-pads it); M and N tails are predicated;
// N is even.
//
// What bounds it: operations. The ViT's qkv GEMM (126,208 x 1152 -> 3456)
// does 1.0e12 operations on 1.0 GB of inputs and output: 0.51 ms at the
// H100's 1979 dense int8 TOP/s against 0.30 ms at 3.35 TB/s; the LM's
// GEMMs (K = 2304) lean further to operations. Each block re-reads its A
// and B panels from L2, not HBM. Design: one block of 8 warps per 128 x 128
// output tile, each warp a 64 x 32 sub-tile of int32 accumulators in
// registers (64 per thread); the 128 x 64-byte A and B tiles stream through
// two cp.async stages in shared memory (rows padded to 80 bytes, so that
// ldmatrix reads them without bank conflicts); fragments come in through
// ldmatrix.x4 (an 8 x 16-byte matrix of int8 is the same bytes as an 8 x 8
// b16 matrix) and feed mma.sync.m16n8k32 s8 x s8 -> s32. The epilogue
// scales each accumulator pair and writes it as one bf16x2. A first,
// simple kernel: wgmma and TMA, which Hopper needs for its full int8 rate,
// are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // output rows per block
constexpr int BN = 128;          // output columns per block
constexpr int BK = 64;           // K bytes per stage
constexpr int LDS = BK + 16;     // shared row pitch in bytes
constexpr int NTHREADS = 256;    // 8 warps: 2 along M x 4 along N
constexpr int WM = 64;           // warp tile rows
constexpr int WN = 32;           // warp tile columns
constexpr int MT = WM / 16;      // m16 tiles per warp
constexpr int NT = WN / 8;       // n8 tiles per warp

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const int8_t* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a * b for one m16n8k32 tile: a 16 x 32 s8 row-major, b 32 x 8 s8
// column-major (stored [n][k]), c 16 x 8 s32.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Starts copying rows [r0, r0 + 128) x bytes [k0, k0 + 64) of a (rows, K)
// int8 matrix into a shared tile; rows at or past `rows` become zeros.
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src,
                                          int r0, int rows, int K, int k0) {
  for (int idx = threadIdx.x; idx < 128 * (BK / 16); idx += NTHREADS) {
    const int r = idx / (BK / 16), c = idx % (BK / 16);
    const bool valid = r0 + r < rows;
    const int8_t* g = valid
        ? src + static_cast<long long>(r0 + r) * K + k0 + c * 16 : src;
    cp_async16(dst + r * LDS + c * 16, g, valid);
  }
}

__global__ void __launch_bounds__(NTHREADS)
int8_gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                 const float* __restrict__ xs, const float* __restrict__ ws,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                 int M, int N, int K) {
  __shared__ __align__(128) int8_t sA[2][BM * LDS];
  __shared__ __align__(128) int8_t sB[2][BN * LDS];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * WM, wn = (warp % 4) * WN;
  const int g = lane >> 2, t = lane & 3;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int ktiles = K / BK;
  load_tile(sA[0], xq, m0, M, K, 0);
  load_tile(sB[0], wq, n0, N, K, 0);
  asm volatile("cp.async.commit_group;\n" ::);

  // ldmatrix row addresses: lane L names row L % 8 of matrix L / 8
  const int mat = lane >> 3, r8 = lane & 7;
  // A: matrices (rows 0-7, k 0-15), (rows 8-15, k 0-15), (rows 0-7, k
  // 16-31), (rows 8-15, k 16-31) = a0..a3 of one m16 tile
  const int a_row = (mat & 1) * 8 + r8, a_col = (mat >> 1) * 16;
  // B: (n 0-7, k 0-15), (n 0-7, k 16-31), (n 8-15, k 0-15), (n 8-15, k
  // 16-31) = b0, b1 of two n8 tiles
  const int b_row = (mat >> 1) * 8 + r8, b_col = (mat & 1) * 16;

  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < ktiles) {
      load_tile(sA[st ^ 1], xq, m0, M, K, (kt + 1) * BK);
      load_tile(sB[st ^ 1], wq, n0, N, K, (kt + 1) * BK);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], sA[st] + (wm + i * 16 + a_row) * LDS + ks * 32 +
                               a_col);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, sB[st] + (wn + j * 8 + b_row) * LDS + ks * 32 + b_col);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    __syncthreads();  // every warp is done with this stage
  }

  // epilogue: (float(acc) * xs) * ws + bias in fp32, one bf16x2 per pair
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn + j * 8 + 2 * t;
    if (col >= N) continue;        // N is even: col + 1 < N here
    const float w0 = ws[col], w1 = ws[col + 1];
    const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + i * 16 + g + half * 8;
        if (row >= M) continue;
        const float x = xs[row];
        float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * half]), x),
                             w0);
        float y1 = __fmul_rn(
            __fmul_rn(__int2float_rn(acc[i][j][2 * half + 1]), x), w1);
        if (bias) {
          y0 = __fadd_rn(y0, b0);
          y1 = __fadd_rn(y1, b1);
        }
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<long long>(row) * N + col) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

}  // namespace

// Plain C entry point for ctypes: K a multiple of 64, N even, every pointer
// on the device and the int8 rows 16-byte aligned (K % 64 == 0 makes them
// so for an aligned base). bias may be null. Returns a cudaError_t (0 =
// launched).
extern "C" int visrag_int8_gemm(const void* xq, const void* wq,
                                const void* xs, const void* ws,
                                const void* bias, void* out, int M, int N,
                                int K, void* stream) {
  if (M < 0 || N < 0 || K <= 0 || K % BK || N % 2)
    return int(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return int(cudaSuccess);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), M,
      N, K);
  return int(cudaGetLastError());
}

// Fused row norms for Hopper (sm_90a), K7: RMSNorm and LayerNorm forward.
//
// Replaces the TPU kernels `_rms_kernel` and `_ln_kernel` in
// visrag_tpu/ops/norms.py (launched by `_run_rows_kernel`), which every
// RMSNorm / LayerNorm of the models runs:
//
//   RMSNorm:   y = x * rsqrt(mean(x^2) + eps) * w
//   LayerNorm: y = (x - mu) * rsqrt(mean((x - mu)^2) + eps) * w + b
//
// row-wise over the last dimension D, in fp32, cast back to x's type; x and
// y bf16 or fp32, w (and b) bf16 or fp32 in their own type. LayerNorm is
// two-pass over the row held in registers (the mean, then the centred
// variance), not E[x^2] - mu^2. The output's products and sum run in the
// order written and round one at a time (no fused multiply-add), as the
// plain PyTorch version's separate elementwise ops do.
//
// What bounds it: bytes. One read of x and one write of y, a few operations
// per element: the ViT's 126,208 x 1152 bf16 rows are 0.58 GB, 0.17 ms at
// 3.35 TB/s. Design: one block per row, a grid-stride loop over rows (the
// grid fills the SMs and no more); each thread holds NCHUNK vectors of VEC
// elements of its row in registers, read with one 16-byte load each, so
// the row is read from memory once; the sum (and for LayerNorm the second,
// centred sum) is a warp-shuffle reduction, then one across the block's
// warps through shared memory. A block has at most 512 threads and a
// thread at most 4 vectors on the bf16 vector variant, 1024 threads and 2
// vectors on the fp32 one, 1024 threads and 8 elements on the scalar one:
// D up to 16,384 bf16 or 8,192 fp32 elements, or 8,192 on the scalar
// variant. Where D is not a multiple of the vector
// width, or a pointer is not aligned for it, the wrapper picks the scalar
// variant (VEC = 1) of the same kernel.
//
// RMSNorm at D <= 4096, D a multiple of 8 (every RMSNorm of the models:
// 1280, 2048, 2304, 3584), over enough rows to fill the card (the wrapper's
// rms_route) runs a warp per row instead (rms_warp_kernel):
// the block kernel pays two __syncthreads reductions a row and has one row
// of a block in flight, its next row's loads waiting on this row's store.
// Here 8 warps a block, no shared memory, no block barrier: each lane holds
// its NV 16-byte vectors of the row (D / 256 at bf16: 5 at 1280, 8 at 2048,
// 9 at 2304, 14 at 3584; tail vectors predicated off), the weight is loaded
// once per warp into registers (packed, in its own type) where they hold it,
// each warp walks rows grid-stride (two rows a warp: the grid below) and
// issues the next row's loads before it reduces and stores this one (two
// rows in flight where the registers hold both), the sum of squares is a
// warp-shuffle reduction and y leaves through streaming 16-byte stores.
// At the paths' widths it runs at the speed of a plain copy of the same
// bytes, as the block kernel does (PERF.md). Same arithmetic as the block
// kernel:
// fp32 sum, rsqrt(mean + eps), then x * r, then * w, each rounded as
// written (no fused multiply-add).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Threads per block and chunks per thread at most: 512 x 4 for the bf16
// vector variant (4 x 8 floats of the row in registers, up to 128 registers
// a thread), 1024 x 2 for the fp32 one (2 x 4 floats, up to 64 registers:
// at 512 x 4 its RMSNorm spilled) and 1024 x 8 for the scalar one (8
// floats, up to 64 registers).
#define NORM_MAX_THREADS(VEC) ((VEC) == 8 ? 512 : 1024)
#define NORM_MAX_CHUNKS(VEC) ((VEC) == 1 ? 8 : (VEC) == 4 ? 2 : 4)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float* out) {
  const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = to_f(pk.v[k]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float* in) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int k = 0; k < VEC; ++k) pk.v[k] = from_f<T>(in[k]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

// Sum of v over the block (blockDim.x a multiple of 32), returned to every
// thread. red holds 33 floats; the leading barrier lets a previous call's
// readers finish before it is written again.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

template <typename TX, typename TW, int VEC, int NCHUNK, bool LN>
__global__ void __launch_bounds__(NORM_MAX_THREADS(VEC))
row_norm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                const TW* __restrict__ b, TX* __restrict__ y, int rows, int d,
                float eps) {
  __shared__ float red[33];
  const float fd = static_cast<float>(d);
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const TX* xr = x + static_cast<size_t>(row) * d;
    TX* yr = y + static_cast<size_t>(row) * d;
    float v[NCHUNK][VEC];
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
      const int i = (c * nt + tid) * VEC;
      if (i < d) {
        load<TX, VEC>(xr + i, v[c]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[c][k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) s += LN ? v[c][k] : v[c][k] * v[c][k];
    }
    float rstd;
    if (LN) {
      const float mu = block_sum(s, red) / fd;
      float s2 = 0.f;
#pragma unroll
      for (int c = 0; c < NCHUNK; ++c) {
        if ((c * nt + tid) * VEC < d) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            v[c][k] -= mu;
            s2 += v[c][k] * v[c][k];
          }
        }
      }
      rstd = rsqrtf(block_sum(s2, red) / fd + eps);
    } else {
      rstd = rsqrtf(block_sum(s, red) / fd + eps);
    }
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
      const int i = (c * nt + tid) * VEC;
      if (i >= d) continue;
      float wv[VEC], out[VEC];
      load<TW, VEC>(w + i, wv);
      if (LN) {
        float bv[VEC];
        load<TW, VEC>(b + i, bv);
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          out[k] = __fadd_rn(__fmul_rn(__fmul_rn(v[c][k], rstd), wv[k]),
                             bv[k]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          out[k] = __fmul_rn(__fmul_rn(v[c][k], rstd), wv[k]);
      }
      store<TX, VEC>(yr + i, out);
    }
  }
}

// ---- RMSNorm, a warp per row -------------------------------------------------

constexpr int WARP_THREADS = 256;        // 8 warps a block, a row each
constexpr int WARP_MAX_D = 4096;

// x's 16-byte vector as floats, and back (round to nearest)
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ uint4 pack16(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 pack16(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// Registers of one row (x) and of the weight a lane holds: two rows in
// flight where both fit beside the weight, the weight in registers where it
// fits beside the rows, else read again from L1 where it is used. (Capping
// the registers to fit two blocks an SM measured no faster: every variant
// tried was within 7 % of a plain copy of the same bytes, PERF.md.)
template <typename TX, typename TW, int NV>
struct WarpPlan {
  static constexpr int VEC = 16 / sizeof(TX);   // x elements a vector
  static constexpr int X_REGS = 4 * NV;
  static constexpr int W_REGS = NV * VEC * int(sizeof(TW)) / 4;
  static constexpr bool AHEAD = 2 * X_REGS + W_REGS <= 176;
  static constexpr bool W_IN_REGS = (AHEAD ? 2 : 1) * X_REGS + W_REGS <= 160;
};

template <typename TX, typename TW, int NV>
__global__ void __launch_bounds__(WARP_THREADS)
rms_warp_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                TX* __restrict__ y, int rows, int d, float eps) {
  using P = WarpPlan<TX, TW, NV>;
  constexpr int VEC = P::VEC;
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (WARP_THREADS / 32);
  const int nvec = d / VEC;                 // vectors a row
  const float fd = static_cast<float>(d);
  int row = blockIdx.x * (WARP_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;

  Pack<TW, VEC> wv[P::W_IN_REGS ? NV : 1];
  if constexpr (P::W_IN_REGS) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int i = lane + 32 * c;
      if (i < nvec) wv[c] = reinterpret_cast<const Pack<TW, VEC>*>(w)[i];
    }
  }
  auto load_row = [&](uint4 (&dst)[NV], int r) {
    const uint4* xr =
        reinterpret_cast<const uint4*>(x + static_cast<size_t>(r) * d);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int i = lane + 32 * c;
      dst[c] = i < nvec ? __ldcs(xr + i) : make_uint4(0, 0, 0, 0);
    }
  };

  uint4 cur[NV];
  uint4 nxt[P::AHEAD ? NV : 1];
  load_row(cur, row);
  for (; row < rows; row += warps) {
    const int next = row + warps;
    if constexpr (P::AHEAD) {
      if (next < rows) load_row(nxt, next);
    }
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      float v[VEC];
      unpack16(cur[c], v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) s = __fadd_rn(s, __fmul_rn(v[k], v[k]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float rstd = rsqrtf(s / fd + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + static_cast<size_t>(row) * d);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int i = lane + 32 * c;
      if (i >= nvec) continue;
      float v[VEC], out[VEC];
      unpack16(cur[c], v);
      Pack<TW, VEC> wp;
      if constexpr (P::W_IN_REGS) wp = wv[c];
      else wp = reinterpret_cast<const Pack<TW, VEC>*>(w)[i];
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        out[k] = __fmul_rn(__fmul_rn(v[k], rstd), to_f(wp.v[k]));
      __stcs(yr + i, pack16(out));
    }
    if constexpr (P::AHEAD) {
#pragma unroll
      for (int c = 0; c < NV; ++c) cur[c] = nxt[c];
    } else if (next < rows) {
      load_row(cur, next);
    }
  }
}

// Grid: two rows a warp, the pair that the warp has in flight at once; the
// block scheduler keeps the SMs full. (Sizing the grid to the resident
// blocks instead, so that each warp walks ~16 rows, measured up to 3 %
// slower: PERF.md.)
constexpr int WARP_ROWS = 2;

template <typename TX, typename TW, int NV>
int launch_warp(const void* x, const void* w, void* y, int rows, int d,
                float eps, cudaStream_t stream) {
  constexpr int ROWS_A_BLOCK = WARP_THREADS / 32 * WARP_ROWS;
  const int grid = static_cast<int>(
      (static_cast<long long>(rows) + ROWS_A_BLOCK - 1) / ROWS_A_BLOCK);
  rms_warp_kernel<TX, TW, NV><<<grid, WARP_THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(y), rows, d, eps);
  return int(cudaGetLastError());
}

// NV, the vectors a lane holds, from the instantiated set: the least one
// that covers the row (bf16 rows of up to 4096 take up to 16, fp32 32).
template <typename TX, typename TW>
int dispatch_warp(const void* x, const void* w, void* y, int rows, int d,
                  float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(TX);
  const int need = (d / VEC + 31) / 32;
#define VISRAG_RMS_NV(N)                                                  \
  if (need <= N) return launch_warp<TX, TW, N>(x, w, y, rows, d, eps, stream);
  VISRAG_RMS_NV(1) VISRAG_RMS_NV(2) VISRAG_RMS_NV(3) VISRAG_RMS_NV(4)
  VISRAG_RMS_NV(5) VISRAG_RMS_NV(6) VISRAG_RMS_NV(8) VISRAG_RMS_NV(9)
  VISRAG_RMS_NV(10) VISRAG_RMS_NV(12) VISRAG_RMS_NV(14) VISRAG_RMS_NV(16)
  if constexpr (VEC == 4) {
    VISRAG_RMS_NV(18) VISRAG_RMS_NV(20) VISRAG_RMS_NV(24)
    VISRAG_RMS_NV(28) VISRAG_RMS_NV(32)
  }
#undef VISRAG_RMS_NV
  return int(cudaErrorInvalidValue);
}

template <typename TX, typename TW, int VEC, bool LN>
int launch_vec(const void* x, const void* w, const void* b, void* y, int rows,
               int d, float eps, cudaStream_t stream) {
  constexpr int MAXT = NORM_MAX_THREADS(VEC);
  const int n = (d + VEC - 1) / VEC;   // vectors per row
  const int threads = n >= MAXT ? MAXT : ((n + 31) / 32) * 32;
  const int chunks = (n + threads - 1) / threads;
  if (chunks > NORM_MAX_CHUNKS(VEC)) return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  const long long resident = static_cast<long long>(sms) *
                             (threads >= 2048 ? 1 : 2048 / threads);
  const int grid = static_cast<int>(rows < resident ? rows : resident);
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  const TW* bp = static_cast<const TW*>(b);
  TX* yp = static_cast<TX*>(y);
  if (chunks == 1)
    row_norm_kernel<TX, TW, VEC, 1, LN>
        <<<grid, threads, 0, stream>>>(xp, wp, bp, yp, rows, d, eps);
  else if (chunks == 2)
    row_norm_kernel<TX, TW, VEC, 2, LN>
        <<<grid, threads, 0, stream>>>(xp, wp, bp, yp, rows, d, eps);
  else if constexpr (NORM_MAX_CHUNKS(VEC) >= 4) {
    if (chunks <= 4)
      row_norm_kernel<TX, TW, VEC, 4, LN>
          <<<grid, threads, 0, stream>>>(xp, wp, bp, yp, rows, d, eps);
    else if constexpr (VEC == 1)
      row_norm_kernel<TX, TW, VEC, 8, LN>
          <<<grid, threads, 0, stream>>>(xp, wp, bp, yp, rows, d, eps);
  }
  return int(cudaGetLastError());
}

template <typename TX, typename TW, bool LN>
int launch(const void* x, const void* w, const void* b, void* y, int rows,
           int d, float eps, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int V = 16 / sizeof(TX);
  return vec ? launch_vec<TX, TW, V, LN>(x, w, b, y, rows, d, eps, st)
             : launch_vec<TX, TW, 1, LN>(x, w, b, y, rows, d, eps, st);
}

template <bool LN>
int dispatch(const void* x, const void* w, const void* b, void* y, int rows,
             int d, float eps, int x_fp32, int w_fp32, int vec,
             void* stream) {
  if (rows < 0 || d <= 0) return int(cudaErrorInvalidValue);
  if (rows == 0) return int(cudaSuccess);
  if (x_fp32)
    return w_fp32
        ? launch<float, float, LN>(x, w, b, y, rows, d, eps, vec, stream)
        : launch<float, __nv_bfloat16, LN>(x, w, b, y, rows, d, eps, vec,
                                           stream);
  return w_fp32
      ? launch<__nv_bfloat16, float, LN>(x, w, b, y, rows, d, eps, vec,
                                         stream)
      : launch<__nv_bfloat16, __nv_bfloat16, LN>(x, w, b, y, rows, d, eps,
                                                 vec, stream);
}

}  // namespace

// x, y (rows, d) contiguous; w (d,). x_fp32 / w_fp32: 1 for fp32, 0 for
// bf16. vec: 1 when d is a multiple of the 16-byte vector and every pointer
// is aligned to it, else 0. Returns the CUDA error of the launch (0: none).
extern "C" int visrag_rmsnorm(const void* x, const void* w, void* y, int rows,
                              int d, float eps, int x_fp32, int w_fp32,
                              int vec, void* stream) {
  return dispatch<false>(x, w, nullptr, y, rows, d, eps, x_fp32, w_fp32, vec,
                         stream);
}

// RMSNorm, a warp per row: as visrag_rmsnorm for d <= 4096 and a multiple
// of 8, every pointer 16-byte aligned (8-byte for a bf16 w beside fp32 x);
// any other d is an error, not another kernel.
extern "C" int visrag_rmsnorm_warp(const void* x, const void* w, void* y,
                                   int rows, int d, float eps, int x_fp32,
                                   int w_fp32, void* stream) {
  if (rows < 0 || d <= 0 || d % 8 || d > WARP_MAX_D)
    return int(cudaErrorInvalidValue);
  if (rows == 0) return int(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_fp32)
    return w_fp32 ? dispatch_warp<float, float>(x, w, y, rows, d, eps, st)
                  : dispatch_warp<float, __nv_bfloat16>(x, w, y, rows, d,
                                                        eps, st);
  return w_fp32
      ? dispatch_warp<__nv_bfloat16, float>(x, w, y, rows, d, eps, st)
      : dispatch_warp<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d, eps,
                                                    st);
}

// As visrag_rmsnorm, with the bias b (d,) in w's type.
extern "C" int visrag_layernorm(const void* x, const void* w, const void* b,
                                void* y, int rows, int d, float eps,
                                int x_fp32, int w_fp32, int vec,
                                void* stream) {
  return dispatch<true>(x, w, b, y, rows, d, eps, x_fp32, w_fp32, vec,
                        stream);
}

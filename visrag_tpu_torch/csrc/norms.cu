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
// thread at most 4 vectors (1024 threads and 8 elements on the scalar
// variant): D up to 16,384 bf16 or 8,192 fp32 elements, or 8,192 on the
// scalar variant. Where D is not a multiple of the vector
// width, or a pointer is not aligned for it, the wrapper picks the scalar
// variant (VEC = 1) of the same kernel. A first, simple kernel: a warp per
// row for narrow D is left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Threads per block and chunks per thread at most: 512 x 4 for the vector
// variant (4 x 8 floats of the row in registers, up to 128 registers a
// thread), 1024 x 8 for the scalar one (8 floats, up to 64 registers).
#define NORM_MAX_THREADS(VEC) ((VEC) == 1 ? 1024 : 512)
#define NORM_MAX_CHUNKS(VEC) ((VEC) == 1 ? 8 : 4)

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
  else if (chunks <= 4)
    row_norm_kernel<TX, TW, VEC, 4, LN>
        <<<grid, threads, 0, stream>>>(xp, wp, bp, yp, rows, d, eps);
  else if constexpr (VEC == 1)
    row_norm_kernel<TX, TW, VEC, 8, LN>
        <<<grid, threads, 0, stream>>>(xp, wp, bp, yp, rows, d, eps);
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

// As visrag_rmsnorm, with the bias b (d,) in w's type.
extern "C" int visrag_layernorm(const void* x, const void* w, const void* b,
                                void* y, int rows, int d, float eps,
                                int x_fp32, int w_fp32, int vec,
                                void* stream) {
  return dispatch<true>(x, w, b, y, rows, d, eps, x_fp32, w_fp32, vec,
                        stream);
}

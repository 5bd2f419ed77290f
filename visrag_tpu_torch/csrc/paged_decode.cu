// Paged decode attention for Hopper (sm_90a), K5.
//
// Replaces the TPU kernel `_paged_kernel` in visrag_tpu/serving/paged_kv.py
// (launched by paged_decode_attention; its bf16 variant). One query token
// per engine slot attends the slot's cached keys, which live in a pool of
// head-major blocks (n_blocks, kv_heads, BS, D) reached through a block
// table (slots, max_blk):
//
//   o[s, h] = softmax_t(q[s, h] . k[t] * scale : t < len[s]) . v
//
// with k/v of kv head h / REP, token t in pool block table[s, t / BS], row
// t % BS. Only the ceil(len / BS) blocks that hold tokens are read; table
// entries past them (the null block, or another request's stale rows) are
// never touched. The arithmetic follows the TPU kernel: q * scale in fp32,
// rounded to bf16 for the dot; fp32 scores and online softmax (natural exp);
// probabilities rounded to bf16 for P.V; fp32 accumulation.
//
// What bounds it: the bytes of K and V read at the slots' real lengths; a
// decode step does ~2 flops per byte. With 4 slots x 4 kv heads there are
// only 16 (slot, kv head) pairs for 132 SMs, so the table is split across
// blocks (flash-decoding): block (split, kv head, slot) walks
// `blocks_per_split` table entries and writes its partial (acc, max, sum)
// in fp32; a second kernel combines the splits of each (slot, head). A
// partial block stages one pool block of K (row-padded, so that each thread
// reads its own key row without bank conflicts) and V in shared memory with
// cp.async; thread t scores token t for all REP query heads of the group,
// the block reduces max and sum, and thread t then accumulates output
// column t over the BS tokens. REP = heads / kv_heads is a template
// parameter (7 for Qwen2.5-VL-7B, 8 for 3B: not a power of two).
//
// The int8 variant (template flag QUANT; the TPU kernel's `quantized=True`
// branch, the pools of Engine(cache_dtype="int8")) reads int8 K/V blocks,
// half the bytes of bf16, with one fp32 scale per (token, kv head) beside
// them: k_scale / v_scale (n_blocks, kvh, BS), the JAX package's row-form
// scales (n_blocks, 1, kvh * BS) in the same order. Its arithmetic is the
// TPU kernel's: q * scale rounded to bf16 as above; int8 converted exactly
// (int8 -> bf16 is exact, so straight to fp32 here); each score multiplied
// by its key's k scale after the dot; the running sum l taken from the
// unscaled probabilities; the probabilities multiplied by their token's v
// scale before the bf16 rounding for P.V. The smaller K row (144 bytes with
// its pad) keeps each thread's 16-byte reads bank-conflict free as the bf16
// row does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;         // head dim
constexpr int BS = 128;        // tokens per pool block
constexpr int NT = 128;        // threads: one per token, then one per column
constexpr int NWARP = NT / 32;

struct Params {
  const __nv_bfloat16* q;        // (slots, H, D)
  const void* k_pool;            // (n_blocks, kvh, BS, D) bf16 or int8
  const void* v_pool;
  const float* k_scale;          // (n_blocks, kvh, BS), int8 pools only
  const float* v_scale;
  const int* table;              // (slots, max_blk)
  const int* lengths;            // (slots,)
  float* part_o;                 // (slots, kvh, splits, REP, D)
  float* part_ml;                // (slots, kvh, splits, REP, 2)
  __nv_bfloat16* o;              // (slots, H, D)
  int kvh, max_blk, splits, blocks_per_split;
  float scale;
};

// bytes of one K/V element, and of a K row padded against bank conflicts
template <bool QUANT>
__host__ __device__ constexpr int kv_bytes() { return QUANT ? 1 : 2; }
template <bool QUANT>
__host__ __device__ constexpr int k_pitch() {
  return D * kv_bytes<QUANT>() + 16;
}

template <int REP, bool QUANT>
constexpr size_t partial_smem_bytes() {
  return size_t(BS) * k_pitch<QUANT>()                    // K
         + size_t(BS) * D * kv_bytes<QUANT>()             // V
         + size_t(REP) * D * 4 + size_t(REP) * BS * 4    // q, P
         + 2 * size_t(NWARP) * REP * 4;                  // reductions
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(addr), "l"(src));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int REP, bool QUANT>
__global__ void __launch_bounds__(NT) paged_partial_kernel(const Params p) {
  constexpr int E = kv_bytes<QUANT>(), LDK = k_pitch<QUANT>();
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sK = smem;                              // (BS, LDK) bytes
  unsigned char* sV = sK + BS * LDK;                     // (BS, D) elements
  float* sQ = reinterpret_cast<float*>(sV + BS * D * E); // (REP, D)
  float* sP = sQ + REP * D;                              // (REP, BS)
  float* sMax = sP + REP * BS;                           // (NWARP, REP)
  float* sSum = sMax + NWARP * REP;

  const int split = blockIdx.x, g = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int len = p.lengths[s];
  const int nvalid = len > 0 ? (len + BS - 1) / BS : 0;
  const int jb = split * p.blocks_per_split;
  const int je = min(jb + p.blocks_per_split, nvalid);
  const int H = p.kvh * REP;

#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float x = __bfloat162float(p.q[(static_cast<long long>(s) * H +
                                          g * REP + r) * D + tid]);
    sQ[r * D + tid] = bf16_round(x * p.scale);
  }

  float m[REP], l[REP], acc[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    acc[r] = 0.f;
  }

  for (int j = jb; j < je; ++j) {
    const long long blk = p.table[static_cast<long long>(s) * p.max_blk + j];
    const long long row0 = (blk * p.kvh + g) * BS;       // token 0's row
    const unsigned char* kg =
        static_cast<const unsigned char*>(p.k_pool) + row0 * D * E;
    const unsigned char* vg =
        static_cast<const unsigned char*>(p.v_pool) + row0 * D * E;
    constexpr int CH = D * E / 16;                       // 16-byte chunks
    for (int idx = tid; idx < BS * CH; idx += NT) {
      const int row = idx / CH, c = idx % CH;
      cp_async16(sK + row * LDK + c * 16, kg + (row * CH + c) * 16);
      cp_async16(sV + (row * CH + c) * 16, vg + (row * CH + c) * 16);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    // this token's dequantization scales, read while the copy is in flight
    const float ksc = QUANT ? p.k_scale[row0 + tid] : 1.f;
    const float vsc = QUANT ? p.v_scale[row0 + tid] : 1.f;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();   // K, V (and, on the first pass, q) are in place

    // scores of token tid for the group's REP query heads, one 16-byte
    // piece of its K row (16 / E columns, converted to fp32) at a time
    constexpr int CW = 16 / E;
    float sc[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) sc[r] = 0.f;
    const unsigned char* krow = sK + tid * LDK;
#pragma unroll 4
    for (int c = 0; c < D / CW; ++c) {
      const uint4 raw = *reinterpret_cast<const uint4*>(krow + c * 16);
      float kf[CW];
      if constexpr (QUANT) {
        const int8_t* k8 = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int e = 0; e < CW; ++e) kf[e] = static_cast<float>(k8[e]);
      } else {
        const __nv_bfloat162* k2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < CW / 2; ++e) {
          const float2 f = __bfloat1622float2(k2[e]);
          kf[2 * e] = f.x;
          kf[2 * e + 1] = f.y;
        }
      }
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float* qr = sQ + r * D + c * CW;
#pragma unroll
        for (int e = 0; e < CW; ++e) sc[r] = fmaf(qr[e], kf[e], sc[r]);
      }
    }
    if (QUANT) {
#pragma unroll
      for (int r = 0; r < REP; ++r) sc[r] *= ksc;   // after the dot
    }
    const bool valid = j * BS + tid < len;

    // block max and sum per query head (warp shuffles, then across warps)
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (!valid) sc[r] = -INFINITY;
      float x = sc[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
      if (lane == 0) sMax[warp * REP + r] = x;
    }
    __syncthreads();
    float corr[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float bm = sMax[r];
#pragma unroll
      for (int w = 1; w < NWARP; ++w) bm = fmaxf(bm, sMax[w * REP + r]);
      const float mn = fmaxf(m[r], bm);
      const float ref = mn == -INFINITY ? 0.f : mn;
      corr[r] = expf(m[r] - ref);
      m[r] = mn;
      const float pr = expf(sc[r] - ref);     // 0 for masked tokens
      // P.V's operand carries the v scale; the sum l does not
      sP[r * BS + tid] = bf16_round(QUANT ? pr * vsc : pr);
      float x = pr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0) sSum[warp * REP + r] = x;
    }
    __syncthreads();   // P and the partial sums are in place
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float bsum = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) bsum += sSum[w * REP + r];
      l[r] = l[r] * corr[r] + bsum;
      acc[r] *= corr[r];
    }

    // output column tid over this block's tokens
    for (int tok = 0; tok < BS; ++tok) {
      float vv;
      if constexpr (QUANT)
        vv = static_cast<float>(reinterpret_cast<const int8_t*>(sV)[tok * D + tid]);
      else
        vv = __bfloat162float(
            reinterpret_cast<const __nv_bfloat16*>(sV)[tok * D + tid]);
#pragma unroll
      for (int r = 0; r < REP; ++r) acc[r] = fmaf(sP[r * BS + tok], vv, acc[r]);
    }
    __syncthreads();   // K, V, P are free for the next block
  }

  const long long base = (static_cast<long long>(s) * p.kvh + g) * p.splits + split;
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    p.part_o[(base * REP + r) * D + tid] = acc[r];
    if (tid == 0) {
      p.part_ml[(base * REP + r) * 2] = m[r];
      p.part_ml[(base * REP + r) * 2 + 1] = l[r];
    }
  }
}

// One block per (head, slot): o = sum_j e^(m_j - M) acc_j / sum_j e^(m_j - M) l_j.
template <int REP>
__global__ void __launch_bounds__(NT) paged_combine_kernel(const Params p) {
  const int h = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const int g = h / REP, r = h % REP;
  const long long base = (static_cast<long long>(s) * p.kvh + g) * p.splits;
  float mx = -INFINITY;
  for (int j = 0; j < p.splits; ++j)
    mx = fmaxf(mx, p.part_ml[((base + j) * REP + r) * 2]);
  float num = 0.f, den = 0.f;
  if (mx != -INFINITY) {
    for (int j = 0; j < p.splits; ++j) {
      const float mj = p.part_ml[((base + j) * REP + r) * 2];
      if (mj == -INFINITY) continue;
      const float w = expf(mj - mx);
      den += w * p.part_ml[((base + j) * REP + r) * 2 + 1];
      num += w * p.part_o[((base + j) * REP + r) * D + tid];
    }
  }
  p.o[(static_cast<long long>(s) * p.kvh * REP + h) * D + tid] =
      __float2bfloat16_rn(num / fmaxf(den, 1e-30f));
}

template <int REP, bool QUANT>
cudaError_t launch(const Params& p, int slots, cudaStream_t stream) {
  auto partial = paged_partial_kernel<REP, QUANT>;
  const size_t bytes = partial_smem_bytes<REP, QUANT>();
  cudaError_t err = cudaFuncSetAttribute(
      partial, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  partial<<<dim3(p.splits, p.kvh, slots), NT, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<REP><<<dim3(p.kvh * REP, slots), NT, 0, stream>>>(p);
  return cudaGetLastError();
}

template <bool QUANT>
cudaError_t dispatch(const Params& p, int rep, int slots, cudaStream_t st) {
  switch (rep) {
    case 1: return launch<1, QUANT>(p, slots, st);
    case 2: return launch<2, QUANT>(p, slots, st);
    case 3: return launch<3, QUANT>(p, slots, st);
    case 4: return launch<4, QUANT>(p, slots, st);
    case 5: return launch<5, QUANT>(p, slots, st);
    case 6: return launch<6, QUANT>(p, slots, st);
    case 7: return launch<7, QUANT>(p, slots, st);
    case 8: return launch<8, QUANT>(p, slots, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. head_dim and block_size must be 128;
// heads / kv_heads in 1..8. k_pool/v_pool are bf16, or int8 when k_scale
// and v_scale (fp32 (n_blocks, kv_heads, 128)) are given (null for bf16).
// part_o: fp32 (slots, kv_heads, splits, rep, 128) and part_ml: fp32
// (slots, kv_heads, splits, rep, 2) scratch. Returns a cudaError_t (0 =
// both kernels launched).
extern "C" int visrag_paged_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const int* table,
    const int* lengths, void* part_o, void* part_ml, void* o, int slots,
    int heads, int kv_heads, int head_dim, int block_size, int max_blk,
    int splits, int blocks_per_split, float scale, void* stream) {
  if (head_dim != D || block_size != BS || kv_heads <= 0 || heads % kv_heads
      || (k_scale == nullptr) != (v_scale == nullptr))
    return int(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.table = table;
  p.lengths = lengths;
  p.part_o = static_cast<float*>(part_o);
  p.part_ml = static_cast<float*>(part_ml);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.kvh = kv_heads;
  p.max_blk = max_blk;
  p.splits = splits;
  p.blocks_per_split = blocks_per_split;
  p.scale = scale;
  if (slots <= 0) return int(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rep = heads / kv_heads;
  return int(k_scale ? dispatch<true>(p, rep, slots, st)
                     : dispatch<false>(p, rep, slots, st));
}

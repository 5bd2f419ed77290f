// Valid-length flash attention forward for Hopper (sm_90a): the first
// design, on mma.sync. Every K1 launch of the port now goes to
// attention_lengths_hopper.cu (wgmma, TMA); this kernel is reached only with
// `legacy=True` in ops/attention_lengths.py, to time the two in turns.
//
// Replaces the TPU kernel `_fwd_kernel_grid` in
// visrag_tpu/ops/attention_lengths.py (launched by flash_fwd_lengths and
// flash_fwd_lengths_flat). For each batch row b, head h and query row i:
//
//   o[i] = softmax_j(scale * q[i].k[j] : j < len[b] and (!causal or j <= i)) . v
//
// bf16 in and out; scores, running max/sum and the accumulator in fp32; the
// online softmax runs in base 2 with scale*log2(e) folded into the q tile.
// Query rows at or past len[b] are not part of the contract (callers mask
// them); this kernel writes attention over the valid keys there, and zeros
// when len[b] == 0.
//
// With the LSE template flag (training: the backward in
// attention_lengths_bwd.cu reads it) it also writes the natural-log
// log-sum-exp of each row's scores, fp32 (B, H, S) contiguous; rows at or
// past len[b], and rows with no valid key, get the +LARGE sentinel LSE_PAD
// so that the backward's exp(s - lse) is exactly 0 there. Without the flag
// (inference) the LSE is neither computed nor written.
//
// Layout: q/k/v/o are base pointers plus element strides (batch, row, head)
// with a contiguous head dim. The ViT's flat fused-qkv tensor (n*S, 3*H*D)
// and the LM's stacked (B, S, H, D) tensors are the same kernel with other
// strides, so neither caller relayouts anything. Grouped-query attention:
// k/v may carry H / kv_group heads, and query head h reads kv head
// h / kv_group (Qwen2.5-VL-7B: 28 query heads over 4 kv heads), so K/V are
// never repeated in memory.
//
// What bounds it: at the slice's shapes (S = 576..1152, d = 64/72) each
// block reuses its q tile across every K/V tile, so HBM traffic is small
// next to the work on the (64 x 64) score tile: two tensor-core products
// plus the per-element mask, exp2 and rescale. So that work stays in
// registers: each warp owns 16 query rows, runs S = Q K^T and O += P V as
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), and keeps S, P, the running
// max/sum and O in the accumulator fragments; the S fragment is re-packed
// in place as the A operand of P V. Only the q tile and two stages of k/v
// tiles live in shared memory (56 KB at d=72, 87 KB at d=128, both above
// the 48 KB default and so opted into at launch), and cp.async fills the next
// K/V stage while the current one is used. The K/V loop stops at
// ceil(len/64) tiles and, when causal, at the diagonal, so padded keys cost
// nothing. d is padded to a multiple of 16 in shared memory only.

#include "attention_lengths_common.cuh"

namespace {

using namespace visrag;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;            // (B, H, S) or null
  const int* lengths;
  int seq, heads, kv_group;   // query heads per kv head
  long long q_sb, q_sr, q_sh;
  long long k_sb, k_sr, k_sh;
  long long v_sb, v_sr, v_sh;
  long long o_sb, o_sr, o_sh;
  float scale_log2;
};

template <int D>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return 5 * Tile<D>::TILE_BYTES;  // q, 2 x (k, v)
}

template <int D, bool CAUSAL, bool LSE>
__global__ void __launch_bounds__(NTHREADS)
lengths_attention_fwd_kernel(const Params p) {
  using T = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  // q, then two stages of (k, v): the next K/V tile loads while this one
  // is used
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK0 = sQ + 64 * T::LDH;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;       // fragment row group
  const int t = lane & 3;        // thread in group
  const int seq = p.seq;
  const int kv_end = min(max(p.lengths[b], 0), seq);

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const int hk = h / p.kv_group;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;

  // zero the tiles so pad columns stay zero
  zero_smem(smem, fwd_smem_bytes<D>());
  __syncthreads();

  // q tile, pre-scaled by scale*log2(e) in fp32 and rounded back to bf16
  for (int idx = tid; idx < BQ * T::CH; idx += NTHREADS) {
    const int r = idx / T::CH, c = idx % T::CH;
    const int row = q0 + r;
    uint4 val = zero4();
    if (row < seq) {
      val = *reinterpret_cast<const uint4*>(qb + row * p.q_sr + c * 8);
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float2 f = __bfloat1622float2(h2[e]);
        h2[e] = __floats2bfloat162_rn(f.x * p.scale_log2, f.y * p.scale_log2);
      }
    }
    *reinterpret_cast<uint4*>(sQ + r * T::LDH + c * 8) = val;
  }
  __syncthreads();

  // this warp's q rows as A fragments, kept in registers
  const int wrow = warp * 16;
  uint32_t qf[T::KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < T::KSTEPS; ++kk)
    load_a(qf[kk], sQ, T::LDH, wrow, kk * 16, g, t);

  float o[T::NT][4];
#pragma unroll
  for (int n = 0; n < T::NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // rows r_lo = wrow + g and r_hi = r_lo + 8: running max and this
  // thread's share of the running sum (the quad's shares add up at the end)
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  const int qrow_lo = q0 + wrow + g, qrow_hi = qrow_lo + 8;

  int hi = kv_end;
  if (CAUSAL) hi = min(hi, q0 + BQ);
  const int ntiles = (hi + BK - 1) / BK;

  auto stage_k = [&](int st) { return sK0 + st * 2 * 64 * T::LDH; };
  auto stage_v = [&](int st) { return stage_k(st) + 64 * T::LDH; };
  if (ntiles > 0) {
    load_tile_async<D>(stage_k(0), kb, p.k_sr, 0, kv_end);
    load_tile_async<D>(stage_v(0), vb, p.v_sr, 0, kv_end);
    cp_async_commit();
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * BK;
    const __nv_bfloat16* sK = stage_k(tile & 1);
    const __nv_bfloat16* sV = stage_v(tile & 1);
    if (tile + 1 < ntiles) {
      // the other stage was released by the barrier that ended tile - 1
      load_tile_async<D>(stage_k((tile + 1) & 1), kb, p.k_sr, k0 + BK, kv_end);
      load_tile_async<D>(stage_v((tile + 1) & 1), vb, p.v_sr, k0 + BK, kv_end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile has landed for every thread

    // S = Q K^T: 16 rows x 64 keys as eight n8 tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk) {
        uint32_t b0, b1;
        load_b_nk(b0, b1, sK, T::LDH, 8 * j, kk * 16, g, t);
        mma_bf16(s[j], qf[kk], b0, b1);
      }
    }

    // mask (keys past the length; above the diagonal when causal)
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + 2 * t + e;
        const bool ok_lo = col < kv_end && (!CAUSAL || col <= qrow_lo);
        const bool ok_hi = col < kv_end && (!CAUSAL || col <= qrow_hi);
        s[j][e] = ok_lo ? s[j][e] : -INFINITY;
        s[j][2 + e] = ok_hi ? s[j][2 + e] : -INFINITY;
        mx_lo = fmaxf(mx_lo, s[j][e]);
        mx_hi = fmaxf(mx_hi, s[j][2 + e]);
      }
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));

    // online softmax, base 2; a row with no valid key yet keeps max -inf
    // and uses 0 as its reference so every exp2 stays finite (0 or 1)
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float ref_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float ref_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float corr_lo = exp2f(m_lo - ref_lo);
    const float corr_hi = exp2f(m_hi - ref_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = exp2f(s[j][0] - ref_lo);
      s[j][1] = exp2f(s[j][1] - ref_lo);
      s[j][2] = exp2f(s[j][2] - ref_hi);
      s[j][3] = exp2f(s[j][3] - ref_hi);
      sum_lo += s[j][0] + s[j][1];
      sum_hi += s[j][2] + s[j][3];
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < T::NT; ++n) {
      o[n][0] *= corr_lo;
      o[n][1] *= corr_lo;
      o[n][2] *= corr_hi;
      o[n][3] *= corr_hi;
    }

    // O += P V: P re-packed from the S fragments as A, V through
    // ldmatrix.trans as B (two n8 tiles of d per load)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < T::NT / 2; ++np) {
        uint32_t vb4[4];
        load_b_kn_x2(vb4, sV, T::LDH, kk * 16, np * 16, lane);
        mma_bf16(o[2 * np], pa, vb4[0], vb4[1]);
        mma_bf16(o[2 * np + 1], pa, vb4[2], vb4[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  // epilogue: o / l over the quad's summed l (l == 0 gives zeros)
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (qrow_lo < seq)
      *reinterpret_cast<uint32_t*>(ob + qrow_lo * p.o_sr + col) =
          pack_bf16(o[n][0] * inv_lo, o[n][1] * inv_lo);
    if (qrow_hi < seq)
      *reinterpret_cast<uint32_t*>(ob + qrow_hi * p.o_sr + col) =
          pack_bf16(o[n][2] * inv_hi, o[n][3] * inv_hi);
  }
  if (LSE && t == 0) {
    // natural log: m is the base-2 max of the scaled scores
    float* lb = p.lse + (static_cast<long long>(b) * p.heads + h) * seq;
    if (qrow_lo < seq)
      lb[qrow_lo] = (qrow_lo < kv_end && l_lo > 0.f)
                        ? (m_lo + log2f(l_lo)) * LN2 : LSE_PAD;
    if (qrow_hi < seq)
      lb[qrow_hi] = (qrow_hi < kv_end && l_hi > 0.f)
                        ? (m_hi + log2f(l_hi)) * LN2 : LSE_PAD;
  }
}

template <int D, bool CAUSAL, bool LSE>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  auto kernel = lengths_attention_fwd_kernel<D, CAUSAL, LSE>;
  const size_t bytes = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + BQ - 1) / BQ, p.heads, batch);
  kernel<<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const Params& p, int batch, int causal,
                     cudaStream_t stream) {
  if (p.lse)
    return causal ? launch<D, true, true>(p, batch, stream)
                  : launch<D, false, true>(p, batch, stream);
  return causal ? launch<D, true, false>(p, batch, stream)
                : launch<D, false, false>(p, batch, stream);
}

}  // namespace

// Plain C entry point for ctypes. lse: fp32 (batch, heads, seq) contiguous,
// or null for no LSE. kv_heads divides heads (k/v strides are over kv
// heads). Returns a cudaError_t (0 = launched).
extern "C" int visrag_lengths_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const int* lengths, int batch, int seq, int heads, int kv_heads,
    int head_dim,
    long long q_sb, long long q_sr, long long q_sh,
    long long k_sb, long long k_sr, long long k_sh,
    long long v_sb, long long v_sr, long long v_sh,
    long long o_sb, long long o_sr, long long o_sh,
    int causal, float scale_log2, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.lengths = lengths;
  p.seq = seq;
  p.heads = heads;
  if (kv_heads <= 0 || heads % kv_heads) return int(cudaErrorInvalidValue);
  p.kv_group = heads / kv_heads;
  p.q_sb = q_sb; p.q_sr = q_sr; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sr = k_sr; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sr = v_sr; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sr = o_sr; p.o_sh = o_sh;
  p.scale_log2 = scale_log2;
  if (batch <= 0 || seq <= 0 || heads <= 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return int(dispatch<64>(p, batch, causal, s));
    case 72: return int(dispatch<72>(p, batch, causal, s));
    case 128: return int(dispatch<128>(p, batch, causal, s));
    default: return int(cudaErrorInvalidValue);
  }
}

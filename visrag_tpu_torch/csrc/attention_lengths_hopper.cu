// Valid-length flash attention forward for Hopper (sm_90a), K1 at head dims
// 64, 72 and 128: the forward body of hopper_attention_fwd.cuh (wgmma, TMA,
// one producer warp and two consumer warpgroups) with a valid-length mask.
//
// Replaces the TPU kernel `_fwd_kernel_grid` in
// visrag_tpu/ops/attention_lengths.py (launched by flash_fwd_lengths and
// flash_fwd_lengths_flat). For each batch row b, head h and query row i:
//
//   o[i] = softmax_j(scale * q[i].k[j] : j < len[b] and (!causal or j <= i)) . v
//
// bf16 in and out; scores, running max / sum and the accumulator in fp32.
// Rows at or past len[b] are written as zeros and, with the LSE template
// flag (training: the backward, attention_lengths_bwd_hopper.cu, reads it),
// get the log-sum-exp LSE_PAD, the plain version's values
// (ops/attention_lengths.py lengths_attention_reference /
// lengths_lse_reference); no caller reads them. Without the flag the LSE is
// neither computed nor written.
//
// Layout: q / k / v / o are base pointers plus element strides (batch, row,
// head) with a contiguous head dim: the ViT's flat fused-qkv tensor (n S,
// 3 H D) and the LM's stacked (B, S, H, D) tensors are the same kernel with
// other strides. Grouped-query attention: k / v carry H / kv_group heads and
// query head h reads kv head h / kv_group (the 7B: 28 over 4). TMA reads
// every operand, so bases and strides must be 16-byte aligned (the wrapper
// raises otherwise; at d = 72 a head is 144 bytes); a tensor map that
// cuTensorMapEncodeTiled refuses is an error code, never another path.
//
// What bounds it on the H100: the operations (2 products on the valid
// pairs; q, k, v read once take 3-8x less time at the paths' shapes). The
// design is K4's Hopper forward (see hopper_attention_fwd.cuh): 128-row
// query tiles, 128-key K/V tiles through a TMA ring, SS and RS wgmma. The
// valid-length mask needs no pre-pass: each (query tile, key tile) pair is
// classed in closed form from len (LengthsMask below; the plain version is
// `lengths_pair_classes_reference` in ops/attention_lengths.py):
//   skip      when k0 >= len, or (causal) k0 > q0 + BQ - 1;
//   unmasked  when k0 + BK <= len and (causal) k0 + BK - 1 <= q0;
//   masked    otherwise, per element on key < len && (!causal || key <= query).
// A query tile with q0 >= len loads nothing: its block writes zeros and
// LSE_PAD with 16-byte stores and exits before it sets up the pipeline, and
// the grid runs such tiles after the live ones (a 586-token prompt in a
// 4096-row bucket: 5 live query tiles, 27 dead ones). d = 72 is split into a 64-column piece and a 16-column piece
// (the column plan in hopper_attention_fwd.cuh); the wrapper passes its plan
// (`column_plan` in ops/attention_lengths.py), which must equal the one
// compiled here.

#include "hopper_attention_fwd.cuh"

namespace {

using namespace visrag;
using namespace visrag::hopper;

// Closed-form classes from len[b], read once per block; nothing staged.
template <bool C>
struct LengthsMask {
  static constexpr bool CAUSAL = C;
  static constexpr int IDS = 0;
  struct Params {
    const int* lengths;      // (B,)
  };
  struct Rows {};
  int len, qt, q0, nk;

  __device__ __forceinline__ LengthsMask(const Params& mp, int b, int qt_,
                                         int q0_, int, int nk_, int, int sk)
      : len(min(max(mp.lengths[b], 0), sk)), qt(qt_), q0(q0_), nk(nk_) {}

  // the live query tiles (q0 < len) first, causal ones heaviest first;
  // the dead ones, which only store zeros, after them
  static __device__ __forceinline__ int qtile(const Params& mp, int b, int z,
                                              int nq, int sk) {
    const int live =
        min(nq, (min(max(mp.lengths[b], 0), sk) + FWD_BQ - 1) / FWD_BQ);
    return CAUSAL && z < live ? live - 1 - z : z;
  }
  __device__ __forceinline__ bool q_live() const { return q0 < len; }
  __device__ __forceinline__ int ntiles() const {
    const int n = min(nk, (len + FWD_BK - 1) / FWD_BK);
    return CAUSAL ? min(n, qt + 1) : n;
  }
  __device__ __forceinline__ int pair(int t) const {
    const int k0 = t * FWD_BK;
    if (k0 >= len || (CAUSAL && k0 > q0 + FWD_BQ - 1)) return SKIP;
    if (k0 + FWD_BK <= len && (!CAUSAL || k0 + FWD_BK - 1 <= q0))
      return UNMASKED;
    return MASKED;
  }
  __device__ __forceinline__ void stage(int*, int, int) const {}
  __device__ __forceinline__ Rows rows(int, int) const { return {}; }
  __device__ __forceinline__ void apply(float (&s)[64], const Rows&,
                                        const int*, int k0, int row_lo,
                                        int row_hi, int t4) const {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t4 + e;
        if (!(key < len && (!CAUSAL || key <= row_lo)))
          s[4 * j + e] = -INFINITY;
        if (!(key < len && (!CAUSAL || key <= row_hi)))
          s[4 * j + 2 + e] = -INFINITY;
      }
    }
  }
  __device__ __forceinline__ bool row_live(int row) const {
    return row < len;
  }
};

template <int D, bool CAUSAL>
int dispatch(const FwdParams& p, const int* lengths, int batch, int kv_heads,
             const View& q, const View& k, const View& v, const int* plan,
             int plan_len, cudaStream_t stream) {
  if (!plan_matches<D>(plan, plan_len)) return int(cudaErrorInvalidValue);
  FwdMaps maps;
  if (!encode_fwd_maps<D>(&maps, batch, p.sq, p.sk, p.heads, kv_heads, q, k,
                          v))
    return TMA_ENCODE_FAILED;
  const typename LengthsMask<CAUSAL>::Params mp{lengths};
  return p.lse ? launch_fwd<D, true, LengthsMask<CAUSAL>>(maps, p, mp, batch,
                                                          stream)
               : launch_fwd<D, false, LengthsMask<CAUSAL>>(maps, p, mp, batch,
                                                           stream);
}

// ---- the descriptor probe -------------------------------------------------
//
// The 32-byte-swizzle pieces on their own, on x and y (64, 72) bf16
// contiguous: one warpgroup loads x's columns 0-63 (128-byte swizzle) and
// the columns 64-79 of x and y (32-byte swizzle, 72-79 zero-filled) and
// writes
//   s  (64, 64) fp32 = x[:, 64:80] y[:, 64:80]^T   (SS m64n64k16, both
//                                                   K-major 32B)
//   o  (64, 16) fp32 = bf16(s) y[:, 64:80]         (RS m64n16k16, y's piece
//                                                   MN-major 32B, 4 k-steps)
//   o2 (64, 16) fp32 = x[:, :64] y[:, 64:80]       (SS m64n16k16, x K-major
//                                                   128B, y MN-major 32B)
// so that each new descriptor and product shape is checked before the
// kernel relies on it (tools/torch_check_lengths.py).
__global__ void __launch_bounds__(128, 1)
desc_probe_kernel(const __grid_constant__ CUtensorMap tm_x_main,
                  const __grid_constant__ CUtensorMap tm_x_tail,
                  const __grid_constant__ CUtensorMap tm_y_tail, float* s_out,
                  float* o_out, float* o2_out) {
  __shared__ __align__(1024) unsigned char sXm[64 * HALF_ROW];
  __shared__ __align__(1024) unsigned char sXt[64 * TAIL_ROW];
  __shared__ __align__(1024) unsigned char sYt[64 * TAIL_ROW];
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  if (tid == 0) {
    mbar_init(&bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(&bar, 64 * HALF_ROW + 2 * 64 * TAIL_ROW);
    tma_load_4d(sXm, &tm_x_main, &bar, 0, 0, 0, 0);
    tma_load_4d(sXt, &tm_x_tail, &bar, 64, 0, 0, 0);
    tma_load_4d(sYt, &tm_y_tail, &bar, 64, 0, 0, 0);
  }
  mbar_wait(&bar, 0);

  float s[32], o[8], o2[8];
  wgmma_fence();
  wgmma_ss<64, 0>(s, make_desc<32>(smem_u32(sXt), 16, 256),
                  make_desc<32>(smem_u32(sYt), 16, 256), 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  uint32_t pa[4][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[j / 2][2 * (j % 2)] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
  const uint64_t y_mn = make_desc<32>(smem_u32(sYt), 256, 256);
  const uint64_t x_k = make_desc(smem_u32(sXm), 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<16, 1>(o, pa[kk], desc_add(y_mn, kk * 16 * TAIL_ROW), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<16, 1>(o2, desc_add(x_k, kk * 32),
                    desc_add(y_mn, kk * 16 * TAIL_ROW), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(o2);

  const int r = 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s_out[r * 64 + 8 * j + 2 * t4 + e] = s[4 * j + e];
      s_out[(r + 8) * 64 + 8 * j + 2 * t4 + e] = s[4 * j + 2 + e];
    }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      o_out[r * 16 + 8 * j + 2 * t4 + e] = o[4 * j + e];
      o_out[(r + 8) * 16 + 8 * j + 2 * t4 + e] = o[4 * j + 2 + e];
      o2_out[r * 16 + 8 * j + 2 * t4 + e] = o2[4 * j + e];
      o2_out[(r + 8) * 16 + 8 * j + 2 * t4 + e] = o2[4 * j + 2 + e];
    }
}

}  // namespace

// Plain C entry point for ctypes, in the style of attention_lengths.cu's
// visrag_lengths_attention_fwd. lse: fp32 (batch, heads, seq) contiguous, or
// null for no LSE. kv_heads divides heads (k / v strides are over kv heads).
// plan: plan_len (first column, width, swizzle bytes) triples, the
// wrapper's column plan for head_dim. Returns a cudaError_t (0 = launched),
// or -1 when cuTensorMapEncodeTiled refused a tensor map.
extern "C" int visrag_lengths_hopper_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const int* lengths, int batch, int seq, int heads, int kv_heads,
    int head_dim,
    long long q_sb, long long q_sr, long long q_sh,
    long long k_sb, long long k_sr, long long k_sh,
    long long v_sb, long long v_sr, long long v_sh,
    long long o_sb, long long o_sr, long long o_sh,
    int causal, float scale_log2, const int* plan, int plan_len,
    void* stream) {
  if (kv_heads <= 0 || heads % kv_heads) return int(cudaErrorInvalidValue);
  if (batch <= 0 || seq <= 0 || heads <= 0) return int(cudaSuccess);
  FwdParams p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb, p.o_sr = o_sr, p.o_sh = o_sh;
  p.sq = seq, p.sk = seq, p.heads = heads, p.kv_group = heads / kv_heads;
  p.sl2 = scale_log2;
  const View qv{q, q_sb, q_sr, q_sh}, kv{k, k_sb, k_sr, k_sh},
      vv{v, v_sb, v_sr, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
#define VISRAG_K1_CASE(D)                                                    \
  case D:                                                                    \
    return causal ? dispatch<D, true>(p, lengths, batch, kv_heads, qv, kv, vv, \
                                      plan, plan_len, s)                     \
                  : dispatch<D, false>(p, lengths, batch, kv_heads, qv, kv,  \
                                       vv, plan, plan_len, s);
    VISRAG_K1_CASE(64)
    VISRAG_K1_CASE(72)
    VISRAG_K1_CASE(128)
#undef VISRAG_K1_CASE
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The descriptor probe (desc_probe_kernel above) on x, y (64, 72) bf16
// contiguous into s (64, 64), o and o2 (64, 16) fp32. Returns a
// cudaError_t, or -1 when cuTensorMapEncodeTiled refused a tensor map.
extern "C" int visrag_hopper_desc_probe(const void* x, const void* y,
                                        void* s, void* o, void* o2,
                                        void* stream) {
  CUtensorMap xm, xt, yt;
  if (!encode_bshd(&xm, x, 1, 64, 1, 72, 64 * 72, 72, 72, 64, 64, 128) ||
      !encode_bshd(&xt, x, 1, 64, 1, 72, 64 * 72, 72, 72, 64, 16, 32) ||
      !encode_bshd(&yt, y, 1, 64, 1, 72, 64 * 72, 72, 72, 64, 16, 32))
    return TMA_ENCODE_FAILED;
  desc_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      xm, xt, yt, static_cast<float*>(s), static_cast<float*>(o),
      static_cast<float*>(o2));
  return int(cudaGetLastError());
}

// Valid-length flash attention backward for Hopper (sm_90a), K2 at head dims
// 64, 72 and 128 with grouped kv heads: the dq kernel (which also writes
// delta) and the dk/dv kernel of hopper_attention_bwd.cuh (wgmma, TMA, one
// producer warp and two consumer warpgroups) with a valid-length mask.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` in
// visrag_tpu/ops/attention_lengths.py (launched by flash_bwd_lengths), the
// backward of K1 (attention_lengths_hopper.cu, whose LSE it reads). The
// formulas are in hopper_attention_bwd.cuh. Query rows at or past len[b] are
// outside the forward's contract: the caller's `do` there is garbage, so
// they are masked out of P, dS (and P^T, dS^T) explicitly, their dq and
// delta are zeros; key rows at or past len get zero dk and dv; a length-0
// row is all zeros. Grouped kv heads: k / v carry H / kv_group heads read
// through strides (query head h reads kv head h / kv_group), and dk / dv sum
// over the group inside one block, with no atomics. The strides are the
// forward's, so the ViT's flat layout writes dq, dk and dv straight into one
// (n S, 3 H D) buffer, the gradient of the fused qkv GEMM's output.
//
// What bounds it on the H100: the operations (dq 3 products, dk/dv 4, on
// the valid pairs); q, k, v, o, do read once take 3-8x less time at the
// paths' shapes. The design is in hopper_attention_bwd.cuh; the valid-length
// mask (LengthsMask below) needs no pre-pass: each (64-row query tile at
// q0, 64-key tile at k0) pair is classed in closed form from len (the plain
// version is `lengths_bwd_pair_classes_reference` in
// ops/attention_lengths.py):
//   skip      when q0 >= len, k0 >= len, or (causal) k0 > q0 + 63;
//   unmasked  when q0 + 64 <= len, k0 + 64 <= len and (causal) k0 + 63 <= q0;
//   masked    otherwise, per element on query < len && key < len &&
//             (!causal || key <= query).
// The dq kernel classes each consumer warpgroup's 64 rows this way against
// each 64-key tile; a 128-row query tile at or past len writes zeros and
// exits before the pipeline, and the grid runs such tiles after the live
// ones, causal live tiles heaviest first. dk/dv at d 64 / 72 runs the
// kernel with a warpgroup a 64-key tile (128 keys a block), at d 128 the
// split body K4 shares (64 keys a block, warpgroup 0 dV, 1 dK); a block
// whose keys are all at or past len writes zeros and exits. d = 72 is read
// as a 64-column and a 16-column piece (the column plan of
// hopper_attention_fwd.cuh); the wrapper passes its plan (`column_plan` in
// ops/attention_lengths.py), which must equal the one compiled here. The
// grids run a (head, batch row) pair's tiles side by side when the pairs
// fill a wave (hopper_attention_bwd.cuh `tile_fastest`). TMA reads q, k, v
// and do, so bases and strides must be 16-byte aligned (the wrapper raises
// otherwise); a tensor map that cuTensorMapEncodeTiled refuses is an error
// code, never another path.

#include "hopper_attention_bwd.cuh"

namespace {

using namespace visrag;
using namespace visrag::hopper;

// The class of the pair (64-row query tile at qa, 64-key tile at ka).
template <bool CAUSAL>
__device__ __forceinline__ int lengths_pair(int len, int qa, int ka) {
  if (qa >= len || ka >= len || (CAUSAL && ka > qa + 63)) return SKIP;
  if (qa + 64 <= len && ka + 64 <= len && (!CAUSAL || ka + 63 <= qa))
    return UNMASKED;
  return MASKED;
}

// Closed-form classes from len[b], read once per block; nothing staged but
// lse and delta.
template <bool C>
struct LengthsMask {
  static constexpr bool CAUSAL = C;
  static_assert(DKV_BQ == 64 && DKV_BK == 64 && DQ_BQ == 128 && DQ_BK == 64,
                "lengths_pair classes 64-row tiles");
  struct Params {
    const int* lengths;      // (B,)
  };

  // dk/dv: the block's 64 keys from k0
  struct KeyBlock {
    struct Keys {};
    int len, k0, nq;

    __device__ __forceinline__ KeyBlock(const Params& mp, int b, int, int k0_,
                                        int nq_, int, int, int sk)
        : len(min(max(mp.lengths[b], 0), sk)), k0(k0_), nq(nq_) {}

    __device__ __forceinline__ bool k_live() const { return k0 < len; }
    __device__ __forceinline__ void locate(int) {}
    __device__ __forceinline__ int q_begin() const {
      return CAUSAL ? min(k0 / DKV_BQ, nq) : 0;
    }
    __device__ __forceinline__ int q_end() const {
      return min(nq, (len + DKV_BQ - 1) / DKV_BQ);
    }
    __device__ __forceinline__ int pair(int qt) const {
      return lengths_pair<CAUSAL>(len, qt * DKV_BQ, k0);
    }
    // lse * log2(e) and delta of each row of query tile qt; rows at or past
    // len stage zeros (and are masked)
    __device__ __forceinline__ void stage(float* rows, const float* lse,
                                          const float* delta, int qt,
                                          int lane) const {
#pragma unroll
      for (int r = lane; r < DKV_BQ; r += 32) {
        const int row = qt * DKV_BQ + r;
        const bool in = row < len;
        const float l = in ? lse[row] : 0.f;
        const float dl = in ? delta[row] : 0.f;
        rows[r] = l * LOG2E;
        rows[DKV_BQ + r] = dl;
      }
    }
    __device__ __forceinline__ Keys keys(int, int) const { return {}; }
    // query < len, key < len, key <= query when causal; pr: (query r0,
    // key_lo), (r0 + 1, key_lo), (r0, key_hi), (r0 + 1, key_hi)
    __device__ __forceinline__ void apply(float (&pr)[4], const Keys&,
                                          const float*, int, int r0,
                                          int key_lo, int key_hi) const {
      const bool q_lo = r0 < len, q_hi = r0 + 1 < len;
      const bool k_lo = key_lo < len, k_hi = key_hi < len;
      if (!(q_lo && k_lo && (!CAUSAL || r0 >= key_lo))) pr[0] = 0.f;
      if (!(q_hi && k_lo && (!CAUSAL || r0 + 1 >= key_lo))) pr[1] = 0.f;
      if (!(q_lo && k_hi && (!CAUSAL || r0 >= key_hi))) pr[2] = 0.f;
      if (!(q_hi && k_hi && (!CAUSAL || r0 + 1 >= key_hi))) pr[3] = 0.f;
    }
    __device__ __forceinline__ bool key_live(int key) const {
      return key < len;
    }
  };

  // dq: the block's 128 query rows from q0, 64 per consumer warpgroup
  struct QueryBlock {
    static constexpr int IDS = 0;      // nothing staged beside K and V
    struct Rows {};
    int len, q0, nk;

    __device__ __forceinline__ QueryBlock(const Params& mp, int b, int,
                                          int q0_, int, int nk_, int, int sk)
        : len(min(max(mp.lengths[b], 0), sk)), q0(q0_), nk(nk_) {}

    // the live query tiles (q0 < len) first, causal ones heaviest first;
    // the dead ones, which only store zeros, after them
    static __device__ __forceinline__ int qtile(const Params& mp, int b, int z,
                                                int nq, int sk) {
      const int live =
          min(nq, (min(max(mp.lengths[b], 0), sk) + DQ_BQ - 1) / DQ_BQ);
      return CAUSAL && z < live ? live - 1 - z : z;
    }
    __device__ __forceinline__ bool q_live() const { return q0 < len; }
    __device__ __forceinline__ void locate(int) {}
    __device__ __forceinline__ int first() const { return 0; }
    // the key tiles below len (causal: up to the tile's last live row)
    __device__ __forceinline__ int ntiles() const {
      const int end = CAUSAL ? min(len, q0 + DQ_BQ) : len;
      return min(nk, (end + DQ_BK - 1) / DQ_BK);
    }
    __device__ __forceinline__ int pair(int t, int cw) const {
      return lengths_pair<CAUSAL>(len, q0 + 64 * cw, t * DQ_BK);
    }
    __device__ __forceinline__ void stage(int*, int, int) const {}
    __device__ __forceinline__ Rows rows(int, int) const { return {}; }
    // pr: (row_lo, key), (row_lo, key + 1), (row_hi, key), (row_hi, key + 1)
    // with key = key0 + c
    __device__ __forceinline__ void apply(float (&pr)[4], const Rows&,
                                          const int*, int row_lo, int row_hi,
                                          int key0, int c) const {
      const int key = key0 + c;
      const bool q_lo = row_lo < len, q_hi = row_hi < len;
      const bool k0 = key < len, k1 = key + 1 < len;
      if (!(q_lo && k0 && (!CAUSAL || key <= row_lo))) pr[0] = 0.f;
      if (!(q_lo && k1 && (!CAUSAL || key + 1 <= row_lo))) pr[1] = 0.f;
      if (!(q_hi && k0 && (!CAUSAL || key <= row_hi))) pr[2] = 0.f;
      if (!(q_hi && k1 && (!CAUSAL || key + 1 <= row_hi))) pr[3] = 0.f;
    }
    __device__ __forceinline__ bool row_live(int row) const {
      return row < len;
    }
  };
};

enum Which { DQ = 0, DKV = 1 };

template <int D, bool CAUSAL>
int dispatch(int which, const BwdParams& p, const int* lengths, int batch,
             const View& q, const View& k, const View& v, const View& dO,
             const int* plan, int plan_len, cudaStream_t stream) {
  if (!plan_matches<D>(plan, plan_len)) return int(cudaErrorInvalidValue);
  const typename LengthsMask<CAUSAL>::Params mp{lengths};
  if (which == DQ)
    return launch_dq<D, LengthsMask<CAUSAL>>(p, mp, batch, q, k, v, dO,
                                             stream);
  // d <= 72: a warpgroup a key tile; d 128: the split body K4 shares
  if constexpr (D <= 72)
    return launch_dkv_pair<D, LengthsMask<CAUSAL>>(p, mp, batch, q, k, v, dO,
                                                    stream);
  else
    return launch_dkv<D, LengthsMask<CAUSAL>>(p, mp, batch, q, k, v, dO,
                                              stream);
}

int run(int which, const void* q, const void* k, const void* v, const void* o,
        const void* dO, void* dq, void* dk, void* dv, const void* lse,
        void* delta, const int* lengths, int batch, int seq, int heads,
        int kv_heads, int head_dim, const long long* st, int causal,
        float scale, const int* plan, int plan_len, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads) return int(cudaErrorInvalidValue);
  if (batch <= 0 || seq <= 0 || heads <= 0) return int(cudaSuccess);
  BwdParams p{};
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dO = static_cast<const __nv_bfloat16*>(dO);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.o_sb = st[9], p.o_sr = st[10], p.o_sh = st[11];
  p.do_sb = st[12], p.do_sr = st[13], p.do_sh = st[14];
  p.dq_sb = st[15], p.dq_sr = st[16], p.dq_sh = st[17];
  p.dk_sb = st[18], p.dk_sr = st[19], p.dk_sh = st[20];
  p.dv_sb = st[21], p.dv_sr = st[22], p.dv_sh = st[23];
  p.sq = seq, p.sk = seq, p.heads = heads, p.kv_group = heads / kv_heads;
  p.scale = scale;
  const View qv{q, st[0], st[1], st[2]}, kv{k, st[3], st[4], st[5]},
      vv{v, st[6], st[7], st[8]}, dov{dO, st[12], st[13], st[14]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
#define VISRAG_K2_CASE(D)                                                    \
  case D:                                                                    \
    return causal ? dispatch<D, true>(which, p, lengths, batch, qv, kv, vv,  \
                                      dov, plan, plan_len, s)                \
                  : dispatch<D, false>(which, p, lengths, batch, qv, kv, vv, \
                                       dov, plan, plan_len, s);
    VISRAG_K2_CASE(64)
    VISRAG_K2_CASE(72)
    VISRAG_K2_CASE(128)
#undef VISRAG_K2_CASE
    default:
      return int(cudaErrorInvalidValue);
  }
}

// ---- the backward's descriptor probe ----------------------------------------
//
// The 16-column (32-byte-swizzle) pieces as the backward reads them, on x
// and y (64, 72) bf16 contiguous: one warpgroup loads the columns 0-63 of x
// and y (128-byte swizzle) and the columns 64-79 of x and y (32-byte
// swizzle, 72-79 zero-filled), then writes
//   s  (64, 64) fp32 = x[:, :64] y[:, :64]^T        (SS m64n64k16)
//   o  (64, 16) fp32 = bf16(s) y[:, 64:80]          (RS m64n16k16, y's piece
//                                                    MN-major, 4 k-steps: dV
//                                                    += P^T dO, dQ += dS K)
//   oh (64, 16) fp32 = bf16(s[:, 32:]) y[32:, 64:80] (the same from the
//                                                    piece's row 32, 2
//                                                    k-steps: dK += dS^T Q
//                                                    on the second half)
//   sh (64, 32) fp32 = x[:, 64:80] y[32:, 64:80]^T  (SS m64n32k16, both
//                                                    pieces K-major, y's
//                                                    from row 32: S^T, dP^T
//                                                    of the second half)
// so that each descriptor the backward adds is checked before the kernels
// rely on it (tools/torch_check_lengths.py).
__global__ void __launch_bounds__(128, 1)
bwd_desc_probe_kernel(const __grid_constant__ CUtensorMap tm_x_main,
                      const __grid_constant__ CUtensorMap tm_y_main,
                      const __grid_constant__ CUtensorMap tm_x_tail,
                      const __grid_constant__ CUtensorMap tm_y_tail,
                      float* s_out, float* o_out, float* oh_out,
                      float* sh_out) {
  __shared__ __align__(1024) unsigned char sXm[64 * HALF_ROW];
  __shared__ __align__(1024) unsigned char sYm[64 * HALF_ROW];
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
    mbar_arrive_expect_tx(&bar, 2 * 64 * HALF_ROW + 2 * 64 * TAIL_ROW);
    tma_load_4d(sXm, &tm_x_main, &bar, 0, 0, 0, 0);
    tma_load_4d(sYm, &tm_y_main, &bar, 0, 0, 0, 0);
    tma_load_4d(sXt, &tm_x_tail, &bar, 64, 0, 0, 0);
    tma_load_4d(sYt, &tm_y_tail, &bar, 64, 0, 0, 0);
  }
  mbar_wait(&bar, 0);

  float s[32], o[8], oh[8], sh[16];
  const uint64_t x_k = make_desc(smem_u32(sXm), 16, 1024);
  const uint64_t y_k = make_desc(smem_u32(sYm), 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<64, 0>(s, desc_add(x_k, kk * 32), desc_add(y_k, kk * 32), kk > 0);
  wgmma_ss<32, 0>(sh, make_desc<32>(smem_u32(sXt), 16, 256),
                  make_desc<32>(smem_u32(sYt) + 32 * TAIL_ROW, 16, 256), 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(sh);
  uint32_t pa[4][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[j / 2][2 * (j % 2)] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
  const uint64_t y_mn = make_desc<32>(smem_u32(sYt), 256, 256);
  const uint64_t yh_mn = make_desc<32>(smem_u32(sYt) + 32 * TAIL_ROW, 256, 256);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<16, 1>(o, pa[kk], desc_add(y_mn, kk * 16 * TAIL_ROW), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    wgmma_rs<16, 1>(oh, pa[2 + kk], desc_add(yh_mn, kk * 16 * TAIL_ROW),
                    kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(oh);

  const int r = 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s_out[r * 64 + 8 * j + 2 * t4 + e] = s[4 * j + e];
      s_out[(r + 8) * 64 + 8 * j + 2 * t4 + e] = s[4 * j + 2 + e];
    }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sh_out[r * 32 + 8 * j + 2 * t4 + e] = sh[4 * j + e];
      sh_out[(r + 8) * 32 + 8 * j + 2 * t4 + e] = sh[4 * j + 2 + e];
    }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      o_out[r * 16 + 8 * j + 2 * t4 + e] = o[4 * j + e];
      o_out[(r + 8) * 16 + 8 * j + 2 * t4 + e] = o[4 * j + 2 + e];
      oh_out[r * 16 + 8 * j + 2 * t4 + e] = oh[4 * j + e];
      oh_out[(r + 8) * 16 + 8 * j + 2 * t4 + e] = oh[4 * j + 2 + e];
    }
}

}  // namespace

// Plain C entry points for ctypes, one per kernel, in the style of
// attention_lengths_bwd.cu's: strides are 24 element strides, (batch, row,
// head) for q, k, v, o, do, dq, dk, dv in that order; k, v, dk and dv carry
// kv_heads heads, which must divide heads. lse and delta: fp32 (batch,
// heads, seq) contiguous; the dq kernel writes delta and the dk/dv kernel
// reads it, so launch dq first on one stream. plan: plan_len (first column,
// width, swizzle bytes) triples, the wrapper's column plan for head_dim.
// Each returns a cudaError_t (0 = launched), or -1 when
// cuTensorMapEncodeTiled refused a tensor map.
extern "C" int visrag_lengths_hopper_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, void* dq, void* dk, void* dv, const void* lse,
    void* delta, const int* lengths, int batch, int seq, int heads,
    int kv_heads, int head_dim, const long long* strides, int causal,
    float scale, const int* plan, int plan_len, void* stream) {
  return run(DQ, q, k, v, o, dO, dq, dk, dv, lse, delta, lengths, batch, seq,
             heads, kv_heads, head_dim, strides, causal, scale, plan, plan_len,
             stream);
}

extern "C" int visrag_lengths_hopper_bwd_dkv(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, void* dq, void* dk, void* dv, const void* lse,
    void* delta, const int* lengths, int batch, int seq, int heads,
    int kv_heads, int head_dim, const long long* strides, int causal,
    float scale, const int* plan, int plan_len, void* stream) {
  return run(DKV, q, k, v, o, dO, dq, dk, dv, lse, delta, lengths, batch, seq,
             heads, kv_heads, head_dim, strides, causal, scale, plan, plan_len,
             stream);
}

// The backward's descriptor probe (bwd_desc_probe_kernel above) on x, y
// (64, 72) bf16 contiguous into s (64, 64), o and oh (64, 16), sh (64, 32)
// fp32. Returns a cudaError_t, or -1 when cuTensorMapEncodeTiled refused a
// tensor map.
extern "C" int visrag_hopper_bwd_desc_probe(const void* x, const void* y,
                                            void* s, void* o, void* oh,
                                            void* sh, void* stream) {
  CUtensorMap xm, ym, xt, yt;
  if (!encode_bshd(&xm, x, 1, 64, 1, 72, 64 * 72, 72, 72, 64, 64, 128) ||
      !encode_bshd(&ym, y, 1, 64, 1, 72, 64 * 72, 72, 72, 64, 64, 128) ||
      !encode_bshd(&xt, x, 1, 64, 1, 72, 64 * 72, 72, 72, 64, 16, 32) ||
      !encode_bshd(&yt, y, 1, 64, 1, 72, 64 * 72, 72, 72, 64, 16, 32))
    return TMA_ENCODE_FAILED;
  bwd_desc_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      xm, ym, xt, yt, static_cast<float*>(s), static_cast<float*>(o),
      static_cast<float*>(oh), static_cast<float*>(sh));
  return int(cudaGetLastError());
}

// Segment-id flash attention for Hopper (sm_90a), K4: forward with the
// log-sum-exp, and its backward (dq, and dk/dv), on the mma.sync core.
//
// Which d goes where: at every head dim the port runs (64, 80, 128) the
// forward, dq and dk/dv are the wgmma + TMA kernels of
// attention_segment_hopper.cu; the ones here stay compiled so that they can
// be timed against those (ops/attention.py `_route`, its `legacy` switch),
// and the port's callers never select them.
//
// Replaces the TPU kernels `_fwd_kernel`, `_dq_kernel` and `_dkv_kernel` in
// visrag_tpu/ops/attention.py (launched by `_flash_fwd` / `_flash_bwd` under
// `_flash_core`), and the library detour `_flash_library_segment` that the
// JAX package takes for rows longer than its kernel can stage. For batch row
// b, query head h, query row i and key row j, the pair (i, j) is visible iff
//
//   q_seg[b][i] == kv_seg[b][j] > 0   and   (!causal or j <= i)
//
// and then, with p[i][j] = exp(scale * q[i].k[j] - lse[i]) on the visible
// pairs and 0 elsewhere:
//
//   o[i]     = sum_j p[i][j] v[j]            lse[i] = log sum_j exp(scale q.k)
//   delta[i] = sum_d o[i][d] * do[i][d]
//   ds[i][j] = p[i][j] * (do[i].v[j] - delta[i])
//   dq[i] = scale * sum_j ds[i][j] k[j]
//   dk[j] = scale * sum_{h in group} sum_i ds[i][j] q[i]
//   dv[j] = sum_{h in group} sum_i p[i][j] do[i]
//
// Ids are arbitrary ints: packed rows carry contiguous runs that are NOT
// ascending (first-fit packing), so nothing is searched or assumed sorted;
// every score is masked by equality. Ids <= 0 mark padding on either side
// and match nothing. A query row that sees no key has o = 0, lse = LSE_PAD
// and dq = 0 whatever `do` holds; a key that no query sees has dk = dv = 0.
//
// Tile skipping. A small kernel first reduces each 64-row tile of q_seg and
// kv_seg to the [min, max] of its positive ids. A (query tile, key tile)
// pair is skipped when the two ranges cannot meet, and when causal puts the
// key tile wholly after the query tile. Both tests only ever skip pairs with
// no visible element, for any ids, so they are exact; in a packed row of
// several sequences they leave roughly the block diagonal.
//
// Any length runs: K/V (forward, dq) or Q/dO (dk/dv) stream through two
// cp.async stages of 64 rows, with the 64 ids of the streamed side beside
// them. Sq may differ from Sk (causal compares indices from 0).
//
// Grouped kv heads: k/v carry H / kv_group heads and are read through
// strides, never repeated. In the backward a dk/dv block owns one 64-key
// tile of one KV head and loops over the group's query heads and the query
// tiles, so each dk/dv element is written by exactly one block: no atomics,
// deterministic gradients. The dq kernel computes delta from o and do and
// stores it, fp32 (B, H, Sq); the dk/dv kernel, launched after it on the
// same stream, reads it.
//
// What bounds it: the work on the 64 x 64 score tile (two tensor-core
// products forward, five backward, plus the mask and exp2 per element), not
// HBM: every block re-reads the streamed side from L2. So scores, P, dS and
// all accumulators stay in mma.sync m16n8k16 fragments (bf16 in, fp32
// accumulate), the softmax runs in base 2 with scale*log2(e) folded into the
// forward's q tile, and P and dS are rounded to bf16 only as operands of the
// second products. At d = 128 the dk/dv kernel holds two 16 x 128 fp32
// accumulators per warp (128 registers), so it walks each 64-query tile as
// two 32-query halves to keep the score fragments at 32 registers, and no
// kernel caches its resident tile's fragments in registers.
//
// Layout: base pointers plus element strides (batch, row, head) with a
// contiguous head dim, so the model's (B, S, H, D) projections are read in
// place. d in {64, 80, 128}; d is padded to a multiple of 16 in shared
// memory only.

#include <limits.h>

#include "attention_lengths_common.cuh"

namespace {

using namespace visrag;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;          // written by the forward, read by dq
  const __nv_bfloat16* dO;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* lse;                // (B, H, Sq), natural log; forward writes it
  float* delta;              // (B, H, Sq): written by dq, read by dk/dv
  const int* q_seg;          // (B, Sq)
  const int* kv_seg;         // (B, Sk)
  const int2* q_rng;         // (B, ceil(Sq/64)): [min, max] positive id
  const int2* k_rng;         // (B, ceil(Sk/64))
  int sq, sk, heads, kv_group;
  long long q_sb, q_sr, q_sh;
  long long k_sb, k_sr, k_sh;
  long long v_sb, v_sr, v_sh;
  long long o_sb, o_sr, o_sh;
  long long do_sb, do_sr, do_sh;
  long long dq_sb, dq_sr, dq_sh;
  long long dk_sb, dk_sr, dk_sh;
  long long dv_sb, dv_sr, dv_sh;
  float scale;
};

// [min, max] of the positive ids of each 64-row tile; an all-pad tile gets
// (INT_MAX, 0), which meets no range. One warp per tile.
__global__ void segment_tile_ranges_kernel(const int* seg, int seq, int ntiles,
                                           int2* out) {
  const int tile = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const int* row = seg + static_cast<long long>(b) * seq;
  int lo = INT_MAX, hi = 0;
  for (int r = lane; r < 64; r += 32) {
    const int i = tile * 64 + r;
    const int id = i < seq ? row[i] : 0;
    if (id > 0) {
      lo = min(lo, id);
      hi = max(hi, id);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, d));
  }
  if (lane == 0) out[static_cast<long long>(b) * ntiles + tile] = make_int2(lo, hi);
}

__device__ __forceinline__ bool ranges_meet(int2 a, int2 b) {
  return a.x <= b.y && b.x <= a.y;
}

template <int D>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  // q, 2 x (k, v), then 2 x 64 key ids
  return 5 * Tile<D>::TILE_BYTES + 2 * BK * sizeof(int);
}

template <int D>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  // q, do, 2 x (k, v), lse*log2(e) and delta of the 64 rows, 2 x 64 key ids
  return 6 * Tile<D>::TILE_BYTES + 2 * 64 * sizeof(float) +
         2 * BK * sizeof(int);
}

template <int D>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  // k, v, 2 x (q, do), then per stage lse*log2(e), delta and the query ids
  return 6 * Tile<D>::TILE_BYTES + 2 * (2 * 64 * sizeof(float) +
                                        BQ * sizeof(int));
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
segment_attention_fwd_kernel(const Params p) {
  using T = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK0 = sQ + 64 * T::LDH;
  int* sSeg = reinterpret_cast<int*>(smem + 5 * T::TILE_BYTES);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int sq = p.sq, sk = p.sk;
  const int nq = (sq + BQ - 1) / BQ, nk = (sk + BK - 1) / BK;
  const int2 qr = p.q_rng[static_cast<long long>(b) * nq + blockIdx.x];
  const int2* kr = p.k_rng + static_cast<long long>(b) * nk;
  const int* qsegb = p.q_seg + static_cast<long long>(b) * sq;
  const int* ksegb = p.kv_seg + static_cast<long long>(b) * sk;

  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
  float* lb = p.lse
      ? p.lse + (static_cast<long long>(b) * p.heads + h) * sq : nullptr;
  const int ntiles = CAUSAL ? min(nk, q0 / BK + 1) : nk;
  auto next_active = [&](int tile) {
    while (tile < ntiles && !ranges_meet(qr, kr[tile])) ++tile;
    return tile;
  };
  int cur = next_active(0);
  if (cur >= ntiles) {       // no row of this tile sees any key
    store_zero_rows<D>(ob, p.o_sr, q0, sq);
    if (lb && tid < BQ && q0 + tid < sq) lb[q0 + tid] = LSE_PAD;
    return;
  }

  const int hk = h / p.kv_group;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;

  zero_smem(smem, 5 * T::TILE_BYTES);   // pad columns stay zero
  __syncthreads();

  // q tile, pre-scaled by scale*log2(e) in fp32 and rounded back to bf16
  const float scale_log2 = p.scale * LOG2E;
  for (int idx = tid; idx < BQ * T::CH; idx += NTHREADS) {
    const int r = idx / T::CH, c = idx % T::CH;
    const int row = q0 + r;
    uint4 val = zero4();
    if (row < sq) {
      val = *reinterpret_cast<const uint4*>(qb + row * p.q_sr + c * 8);
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float2 f = __bfloat1622float2(h2[e]);
        h2[e] = __floats2bfloat162_rn(f.x * scale_log2, f.y * scale_log2);
      }
    }
    *reinterpret_cast<uint4*>(sQ + r * T::LDH + c * 8) = val;
  }

  auto stage_k = [&](int st) { return sK0 + st * 2 * 64 * T::LDH; };
  auto stage_v = [&](int st) { return stage_k(st) + 64 * T::LDH; };
  auto load_stage = [&](int st, int r0) {
    load_tile_async<D>(stage_k(st), kb, p.k_sr, r0, sk);
    load_tile_async<D>(stage_v(st), vb, p.v_sr, r0, sk);
    if (tid < BK) sSeg[st * BK + tid] = r0 + tid < sk ? ksegb[r0 + tid] : 0;
    cp_async_commit();
  };
  load_stage(0, cur * BK);

  const int wrow = warp * 16;
  float o[T::NT][4];
#pragma unroll
  for (int n = 0; n < T::NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  const int qrow_lo = q0 + wrow + g, qrow_hi = qrow_lo + 8;
  const int qseg_lo = qrow_lo < sq ? qsegb[qrow_lo] : 0;
  const int qseg_hi = qrow_hi < sq ? qsegb[qrow_hi] : 0;

  int st = 0;
  while (cur < ntiles) {
    const int k0 = cur * BK;
    const int nxt = next_active(cur + 1);
    const __nv_bfloat16* sK = stage_k(st);
    const __nv_bfloat16* sV = stage_v(st);
    if (nxt < ntiles) {
      // the other stage was released by the barrier that ended the last tile
      load_stage(st ^ 1, nxt * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (tiles, ids; first time also q) is visible
    const int* kseg = sSeg + st * BK;

    // S = Q K^T: 16 rows x 64 keys as eight n8 tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < T::KSTEPS; ++kk) {
      uint32_t qa[4];
      load_a(qa, sQ, T::LDH, wrow, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        load_b_nk(b0, b1, sK, T::LDH, 8 * j, kk * 16, g, t);
        mma_bf16(s[j], qa, b0, b1);
      }
    }

    // mask: same positive id (keys past Sk carry id 0), key <= query
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const int ks = kseg[c];
        const bool ok_lo = qseg_lo > 0 && ks == qseg_lo &&
                           (!CAUSAL || k0 + c <= qrow_lo);
        const bool ok_hi = qseg_hi > 0 && ks == qseg_hi &&
                           (!CAUSAL || k0 + c <= qrow_hi);
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

    // online softmax, base 2; a row with no key yet keeps max -inf and uses
    // 0 as its reference so every exp2 stays finite (0 or 1)
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
    cur = nxt;
    st ^= 1;
  }

  // epilogue: o / l over the quad's summed l (l == 0 gives exact zeros)
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (qrow_lo < sq)
      *reinterpret_cast<uint32_t*>(ob + qrow_lo * p.o_sr + col) =
          pack_bf16(o[n][0] * inv_lo, o[n][1] * inv_lo);
    if (qrow_hi < sq)
      *reinterpret_cast<uint32_t*>(ob + qrow_hi * p.o_sr + col) =
          pack_bf16(o[n][2] * inv_hi, o[n][3] * inv_hi);
  }
  if (lb && t == 0) {
    // natural log: m is the base-2 max of the scaled scores
    if (qrow_lo < sq)
      lb[qrow_lo] = l_lo > 0.f ? (m_lo + log2f(l_lo)) * LN2 : LSE_PAD;
    if (qrow_hi < sq)
      lb[qrow_hi] = l_hi > 0.f ? (m_hi + log2f(l_hi)) * LN2 : LSE_PAD;
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
segment_attention_dq_kernel(const Params p) {
  using T = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + 64 * T::LDH;
  __nv_bfloat16* sKV0 = sdO + 64 * T::LDH;
  float* sLse = reinterpret_cast<float*>(smem + 6 * T::TILE_BYTES);
  float* sDelta = sLse + 64;
  int* sSeg = reinterpret_cast<int*>(sDelta + 64);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int sq = p.sq, sk = p.sk;
  const int nq = (sq + BQ - 1) / BQ, nk = (sk + BK - 1) / BK;
  const int2 qr = p.q_rng[static_cast<long long>(b) * nq + blockIdx.x];
  const int2* kr = p.k_rng + static_cast<long long>(b) * nk;
  const int* qsegb = p.q_seg + static_cast<long long>(b) * sq;
  const int* ksegb = p.kv_seg + static_cast<long long>(b) * sk;
  const long long row_base = (static_cast<long long>(b) * p.heads + h) * sq;

  const __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
  const __nv_bfloat16* dob = p.dO + b * p.do_sb + h * p.do_sh;
  __nv_bfloat16* dqb = p.dq + b * p.dq_sb + h * p.dq_sh;

  const int ntiles = CAUSAL ? min(nk, q0 / BK + 1) : nk;
  auto next_active = [&](int tile) {
    while (tile < ntiles && !ranges_meet(qr, kr[tile])) ++tile;
    return tile;
  };
  int cur = next_active(0);

  // delta = rowsum(o * do) in fp32, two threads per row, straight from
  // global; 0 on pad rows. Stored for the dk/dv kernel.
  {
    const int r = tid >> 1, half = tid & 1;
    const int row = q0 + r;
    const bool real = row < sq && qsegb[row] > 0;
    float acc = 0.f;
    if (real) {
      const __nv_bfloat162* o2 =
          reinterpret_cast<const __nv_bfloat162*>(ob + row * p.o_sr);
      const __nv_bfloat162* d2 =
          reinterpret_cast<const __nv_bfloat162*>(dob + row * p.do_sr);
      for (int c = half; c < D / 2; c += 2) {
        const float2 a = __bfloat1622float2(o2[c]);
        const float2 d = __bfloat1622float2(d2[c]);
        acc += a.x * d.x + a.y * d.y;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sDelta[r] = acc;
      sLse[r] = real ? p.lse[row_base + row] * LOG2E : 0.f;
      if (row < sq) p.delta[row_base + row] = acc;
    }
  }
  if (cur >= ntiles) {       // no row of this tile sees any key
    store_zero_rows<D>(dqb, p.dq_sr, q0, sq);
    return;
  }

  const int hk = h / p.kv_group;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;

  zero_smem(smem, 6 * T::TILE_BYTES);
  __syncthreads();

  auto stage_k = [&](int st) { return sKV0 + st * 2 * 64 * T::LDH; };
  auto stage_v = [&](int st) { return stage_k(st) + 64 * T::LDH; };
  auto load_stage = [&](int st, int r0) {
    load_tile_async<D>(stage_k(st), kb, p.k_sr, r0, sk);
    load_tile_async<D>(stage_v(st), vb, p.v_sr, r0, sk);
    if (tid < BK) sSeg[st * BK + tid] = r0 + tid < sk ? ksegb[r0 + tid] : 0;
    cp_async_commit();
  };
  load_tile_async<D>(sQ, qb, p.q_sr, q0, sq);
  load_tile_async<D>(sdO, dob, p.do_sr, q0, sq);
  load_stage(0, cur * BK);   // one group with q and do

  const int wrow = warp * 16;
  const int qrow_lo = q0 + wrow + g, qrow_hi = qrow_lo + 8;
  const int qseg_lo = qrow_lo < sq ? qsegb[qrow_lo] : 0;
  const int qseg_hi = qrow_hi < sq ? qsegb[qrow_hi] : 0;
  const float scale_log2 = p.scale * LOG2E;
  float dq[T::NT][4];
#pragma unroll
  for (int n = 0; n < T::NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  int st = 0;
  while (cur < ntiles) {
    const int k0 = cur * BK;
    const int nxt = next_active(cur + 1);
    const __nv_bfloat16* sK = stage_k(st);
    const __nv_bfloat16* sV = stage_v(st);
    if (nxt < ntiles) {
      load_stage(st ^ 1, nxt * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int* kseg = sSeg + st * BK;
    const float lse_lo = sLse[wrow + g], lse_hi = sLse[wrow + g + 8];
    const float dl_lo = sDelta[wrow + g], dl_hi = sDelta[wrow + g + 8];

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys each
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < T::KSTEPS; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, sQ, T::LDH, wrow, kk * 16, g, t);
      load_a(da, sdO, T::LDH, wrow, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        load_b_nk(b0, b1, sK, T::LDH, 8 * j, kk * 16, g, t);
        mma_bf16(s[j], qa, b0, b1);
        load_b_nk(b0, b1, sV, T::LDH, 8 * j, kk * 16, g, t);
        mma_bf16(dp[j], da, b0, b1);
      }
    }

    // dS = P * (dP - delta), P = exp(scale*s - lse) on the visible pairs
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const int ks = kseg[c];
        const bool ok_lo = qseg_lo > 0 && ks == qseg_lo &&
                           (!CAUSAL || k0 + c <= qrow_lo);
        const bool ok_hi = qseg_hi > 0 && ks == qseg_hi &&
                           (!CAUSAL || k0 + c <= qrow_hi);
        const float p_lo = ok_lo ? exp2f(s[j][e] * scale_log2 - lse_lo) : 0.f;
        const float p_hi =
            ok_hi ? exp2f(s[j][2 + e] * scale_log2 - lse_hi) : 0.f;
        s[j][e] = p_lo * (dp[j][e] - dl_lo);
        s[j][2 + e] = p_hi * (dp[j][2 + e] - dl_hi);
      }
    }

    // dQ += dS K: dS re-packed as A, K ([key][d]) through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < T::NT / 2; ++np) {
        uint32_t kb4[4];
        load_b_kn_x2(kb4, sK, T::LDH, kk * 16, np * 16, lane);
        mma_bf16(dq[2 * np], da, kb4[0], kb4[1]);
        mma_bf16(dq[2 * np + 1], da, kb4[2], kb4[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
    cur = nxt;
    st ^= 1;
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (qrow_lo < sq)
      *reinterpret_cast<uint32_t*>(dqb + qrow_lo * p.dq_sr + col) =
          pack_bf16(dq[n][0] * p.scale, dq[n][1] * p.scale);
    if (qrow_hi < sq)
      *reinterpret_cast<uint32_t*>(dqb + qrow_hi * p.dq_sr + col) =
          pack_bf16(dq[n][2] * p.scale, dq[n][3] * p.scale);
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
segment_attention_dkv_kernel(const Params p) {
  using T = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + 64 * T::LDH;
  __nv_bfloat16* sQD0 = sV + 64 * T::LDH;
  float* sRow0 = reinterpret_cast<float*>(smem + 6 * T::TILE_BYTES);
  int* sQSeg0 = reinterpret_cast<int*>(sRow0 + 2 * 2 * 64);

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;          // kv head
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int sq = p.sq, sk = p.sk;
  const int nq = (sq + BQ - 1) / BQ, nk = (sk + BK - 1) / BK;
  const int2 kr = p.k_rng[static_cast<long long>(b) * nk + blockIdx.x];
  const int2* qr = p.q_rng + static_cast<long long>(b) * nq;
  const int* qsegb = p.q_seg + static_cast<long long>(b) * sq;
  const int* ksegb = p.kv_seg + static_cast<long long>(b) * sk;

  __nv_bfloat16* dkb = p.dk + b * p.dk_sb + hk * p.dk_sh;
  __nv_bfloat16* dvb = p.dv + b * p.dv_sb + hk * p.dv_sh;

  // the work list: (query head of the group, query tile) pairs, heads outer
  const int i_begin = CAUSAL ? k0 / BQ : 0;
  const int cnt = max(nq - i_begin, 0);
  const int total = p.kv_group * cnt;
  auto next_active = [&](int idx) {
    while (idx < total && !ranges_meet(kr, qr[i_begin + idx % cnt])) ++idx;
    return idx;
  };
  int cur = next_active(0);
  if (cur >= total) {        // no query sees any key of this tile
    store_zero_rows<D>(dkb, p.dk_sr, k0, sk);
    store_zero_rows<D>(dvb, p.dv_sr, k0, sk);
    return;
  }
  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;

  zero_smem(smem, 6 * T::TILE_BYTES);
  __syncthreads();

  auto stage_q = [&](int st) { return sQD0 + st * 2 * 64 * T::LDH; };
  auto stage_do = [&](int st) { return stage_q(st) + 64 * T::LDH; };
  auto stage_row = [&](int st) { return sRow0 + st * 2 * 64; };
  auto stage_seg = [&](int st) { return sQSeg0 + st * BQ; };
  // q and do tiles of work item idx, with lse*log2(e), delta and the ids of
  // its 64 query rows (plain stores; the barrier at the top of the
  // iteration that reads them orders them)
  auto load_stage = [&](int st, int idx) {
    const int h = hk * p.kv_group + idx / cnt;
    const int q0 = (i_begin + idx % cnt) * BQ;
    load_tile_async<D>(stage_q(st), p.q + b * p.q_sb + h * p.q_sh, p.q_sr, q0,
                       sq);
    load_tile_async<D>(stage_do(st), p.dO + b * p.do_sb + h * p.do_sh,
                       p.do_sr, q0, sq);
    if (tid < BQ) {
      const int row = q0 + tid;
      const int id = row < sq ? qsegb[row] : 0;
      const long long at = (static_cast<long long>(b) * p.heads + h) * sq + row;
      stage_seg(st)[tid] = id;
      stage_row(st)[tid] = id > 0 ? p.lse[at] * LOG2E : 0.f;
      stage_row(st)[64 + tid] = id > 0 ? p.delta[at] : 0.f;
    }
    cp_async_commit();
  };
  load_tile_async<D>(sK, kb, p.k_sr, k0, sk);
  load_tile_async<D>(sV, vb, p.v_sr, k0, sk);
  load_stage(0, cur);        // one group with k and v

  const int wk = warp * 16;
  const int key_lo = k0 + wk + g, key_hi = key_lo + 8;
  const int kseg_lo = key_lo < sk ? ksegb[key_lo] : 0;
  const int kseg_hi = key_hi < sk ? ksegb[key_hi] : 0;
  const float scale_log2 = p.scale * LOG2E;
  float dk[T::NT][4], dv[T::NT][4];
#pragma unroll
  for (int n = 0; n < T::NT; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  int st = 0;
  while (cur < total) {
    const int q0 = (i_begin + cur % cnt) * BQ;
    const int nxt = next_active(cur + 1);
    const __nv_bfloat16* sQ = stage_q(st);
    const __nv_bfloat16* sdO = stage_do(st);
    const float* sLse = stage_row(st);
    const float* sDelta = sLse + 64;
    const int* qseg = stage_seg(st);
    if (nxt < total) {
      load_stage(st ^ 1, nxt);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // the 64 queries as two halves of 32, so that S^T and dP^T take 32
    // registers beside the two accumulators
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * 32;
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries each
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk) {
        uint32_t ka[4], va[4];
        load_a(ka, sK, T::LDH, wk, kk * 16, g, t);
        load_a(va, sV, T::LDH, wk, kk * 16, g, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b0, b1;
          load_b_nk(b0, b1, sQ, T::LDH, c0 + 8 * j, kk * 16, g, t);
          mma_bf16(s[j], ka, b0, b1);
          load_b_nk(b0, b1, sdO, T::LDH, c0 + 8 * j, kk * 16, g, t);
          mma_bf16(dp[j], va, b0, b1);
        }
      }

      // P^T and dS^T = P^T * (dP^T - delta) on the visible pairs; the query
      // is the column here, so its id, lse and delta are read per column
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * j + 2 * t + e;
          const int qrow = q0 + c;
          const int qs = qseg[c];
          const bool ok_lo = qs > 0 && qs == kseg_lo &&
                             (!CAUSAL || qrow >= key_lo);
          const bool ok_hi = qs > 0 && qs == kseg_hi &&
                             (!CAUSAL || qrow >= key_hi);
          const float l2 = sLse[c], dl = sDelta[c];
          const float p_lo = ok_lo ? exp2f(s[j][e] * scale_log2 - l2) : 0.f;
          const float p_hi =
              ok_hi ? exp2f(s[j][2 + e] * scale_log2 - l2) : 0.f;
          s[j][e] = p_lo;
          s[j][2 + e] = p_hi;
          dp[j][e] = p_lo * (dp[j][e] - dl);
          dp[j][2 + e] = p_hi * (dp[j][2 + e] - dl);
        }
      }

      // dV += P^T dO and dK += dS^T Q: P^T and dS^T re-packed as A, dO and
      // Q ([query][d]) through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t da[4] = {
            pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
            pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
            pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
            pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < T::NT / 2; ++np) {
          uint32_t b4[4];
          load_b_kn_x2(b4, sdO, T::LDH, c0 + kk * 16, np * 16, lane);
          mma_bf16(dv[2 * np], pa, b4[0], b4[1]);
          mma_bf16(dv[2 * np + 1], pa, b4[2], b4[3]);
          load_b_kn_x2(b4, sQ, T::LDH, c0 + kk * 16, np * 16, lane);
          mma_bf16(dk[2 * np], da, b4[0], b4[1]);
          mma_bf16(dk[2 * np + 1], da, b4[2], b4[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    cur = nxt;
    st ^= 1;
  }

  // a pad key matched nothing, so its accumulators are exact zeros
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (key_lo < sk) {
      *reinterpret_cast<uint32_t*>(dkb + key_lo * p.dk_sr + col) =
          pack_bf16(dk[n][0] * p.scale, dk[n][1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvb + key_lo * p.dv_sr + col) =
          pack_bf16(dv[n][0], dv[n][1]);
    }
    if (key_hi < sk) {
      *reinterpret_cast<uint32_t*>(dkb + key_hi * p.dk_sr + col) =
          pack_bf16(dk[n][2] * p.scale, dk[n][3] * p.scale);
      *reinterpret_cast<uint32_t*>(dvb + key_hi * p.dv_sr + col) =
          pack_bf16(dv[n][2], dv[n][3]);
    }
  }
}

enum Which { FWD = 0, DQ = 1, DKV = 2 };

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t bytes, const Params& p, dim3 grid,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
cudaError_t dispatch(const Params& p, int batch, int which,
                     cudaStream_t stream) {
  const int nq = (p.sq + BQ - 1) / BQ, nk = (p.sk + BK - 1) / BK;
  switch (which) {
    case FWD:
      return launch(segment_attention_fwd_kernel<D, CAUSAL>,
                    fwd_smem_bytes<D>(), p, dim3(nq, p.heads, batch), stream);
    case DQ:
      return launch(segment_attention_dq_kernel<D, CAUSAL>,
                    dq_smem_bytes<D>(), p, dim3(nq, p.heads, batch), stream);
    default:
      return launch(segment_attention_dkv_kernel<D, CAUSAL>,
                    dkv_smem_bytes<D>(), p,
                    dim3(nk, p.heads / p.kv_group, batch), stream);
  }
}

// ptrs: q, k, v, o, do, dq, dk, dv, lse, delta, q_seg, kv_seg, ranges (null
// where a kernel does not use one). dims: batch, sq, sk, heads, kv_heads,
// head_dim, causal. strides: 24 element strides, (batch, row, head) for q,
// k, v, o, do, dq, dk, dv in that order. ranges: scratch of
// 2 * batch * (ceil(sq/64) + ceil(sk/64)) ints, filled here.
int run(int which, void* const* ptrs, const int* dims,
        const long long* st, float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(ptrs[0]);
  p.k = static_cast<const __nv_bfloat16*>(ptrs[1]);
  p.v = static_cast<const __nv_bfloat16*>(ptrs[2]);
  p.o = static_cast<__nv_bfloat16*>(ptrs[3]);
  p.dO = static_cast<const __nv_bfloat16*>(ptrs[4]);
  p.dq = static_cast<__nv_bfloat16*>(ptrs[5]);
  p.dk = static_cast<__nv_bfloat16*>(ptrs[6]);
  p.dv = static_cast<__nv_bfloat16*>(ptrs[7]);
  p.lse = static_cast<float*>(ptrs[8]);
  p.delta = static_cast<float*>(ptrs[9]);
  p.q_seg = static_cast<const int*>(ptrs[10]);
  p.kv_seg = static_cast<const int*>(ptrs[11]);
  const int batch = dims[0], sq = dims[1], sk = dims[2], heads = dims[3],
            kv_heads = dims[4], head_dim = dims[5], causal = dims[6];
  if (kv_heads <= 0 || heads % kv_heads) return int(cudaErrorInvalidValue);
  if (batch <= 0 || sq <= 0 || sk <= 0) return int(cudaSuccess);
  const int nq = (sq + BQ - 1) / BQ, nk = (sk + BK - 1) / BK;
  int2* q_rng = static_cast<int2*>(ptrs[12]);
  int2* k_rng = q_rng + static_cast<long long>(batch) * nq;
  p.q_rng = q_rng;
  p.k_rng = k_rng;
  p.sq = sq;
  p.sk = sk;
  p.heads = heads;
  p.kv_group = heads / kv_heads;
  long long* dst[] = {&p.q_sb, &p.q_sr, &p.q_sh, &p.k_sb, &p.k_sr, &p.k_sh,
                      &p.v_sb, &p.v_sr, &p.v_sh, &p.o_sb, &p.o_sr, &p.o_sh,
                      &p.do_sb, &p.do_sr, &p.do_sh, &p.dq_sb, &p.dq_sr,
                      &p.dq_sh, &p.dk_sb, &p.dk_sr, &p.dk_sh, &p.dv_sb,
                      &p.dv_sr, &p.dv_sh};
  for (int i = 0; i < 24; ++i) *dst[i] = st[i];
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  segment_tile_ranges_kernel<<<dim3(nq, batch), 32, 0, s>>>(p.q_seg, sq, nq,
                                                            q_rng);
  segment_tile_ranges_kernel<<<dim3(nk, batch), 32, 0, s>>>(p.kv_seg, sk, nk,
                                                            k_rng);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  switch (head_dim) {
    case 64:
      return int(causal ? dispatch<64, true>(p, batch, which, s)
                        : dispatch<64, false>(p, batch, which, s));
    case 80:
      return int(causal ? dispatch<80, true>(p, batch, which, s)
                        : dispatch<80, false>(p, batch, which, s));
    case 128:
      return int(causal ? dispatch<128, true>(p, batch, which, s)
                        : dispatch<128, false>(p, batch, which, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points for ctypes, one per kernel; see `run` for the
// arguments. The dq kernel writes delta and the dk/dv kernel reads it, so
// launch dq first on one stream. Each returns a cudaError_t (0 = launched).
extern "C" int visrag_segment_attention_fwd(void* const* ptrs, const int* dims,
                                            const long long* strides,
                                            float scale, void* stream) {
  return run(FWD, ptrs, dims, strides, scale, stream);
}

extern "C" int visrag_segment_attention_bwd_dq(void* const* ptrs,
                                               const int* dims,
                                               const long long* strides,
                                               float scale, void* stream) {
  return run(DQ, ptrs, dims, strides, scale, stream);
}

extern "C" int visrag_segment_attention_bwd_dkv(void* const* ptrs,
                                                const int* dims,
                                                const long long* strides,
                                                float scale, void* stream) {
  return run(DKV, ptrs, dims, strides, scale, stream);
}

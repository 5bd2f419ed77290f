// The flash-attention backward on the Hopper core (hopper.cuh): the dk/dv
// body shared by K4 (segment ids, attention_segment_hopper.cu) and K2 (valid
// lengths, attention_lengths_bwd_hopper.cu), and a dq body on the same core
// (instantiated for K2 and K4). As in hopper_attention_fwd.cuh, the kernels
// differ only in which (query, key) pairs are visible; a mask policy says
// that, and everything else (tiles, the TMA ring, the products, the
// epilogue) is this one body. With p = exp(scale q.k - lse) on the visible
// pairs and 0 elsewhere:
//
//   delta[i] = sum_d o[i][d] do[i][d]
//   ds[i][j] = p[i][j] (do[i].v[j] - delta[i])
//   dq[i] = scale sum_j ds[i][j] k[j]
//   dk[j] = scale sum_{h in group} sum_i ds[i][j] q[i]
//   dv[j] = sum_{h in group} sum_i p[i][j] do[i]
//
// What bounds it on the H100: the operations (dq 3 products, dk/dv 4 on the
// visible pairs), reached only through wgmma fed by TMA. Both kernels run a
// producer warpgroup (dk/dv: a warp a ring stage; dq: one warp) and two
// consumer warpgroups (setmaxnreg 56 / 224), and ptxas keeps a consumer
// thread within 168 registers (PERF.md), which decides their shapes:
//
//   * dk/dv (PR 7's K4 design): a block owns 64 keys of one kv head and
//     walks the group's query heads (outer) and their 64-row query tiles
//     (inner), so every dk/dv element is written by one block (no atomics,
//     deterministic); Q and dO tiles stream through a 4-stage ring with each
//     row's lse log2(e), delta and (policy) query id staged beside them, a
//     producer warp a stage. Both warpgroups compute S^T = K Q^T and P^T =
//     exp2(S^T scale log2(e) - lse log2(e)); warpgroup 0 adds dV += P^T dO
//     (S^T an SS m64n64k16, P^T rounded to bf16 as the A operand of an RS
//     product, dO MN-major), warpgroup 1 dK += dS^T Q with dS^T = P^T (dP^T
//     - delta) (S^T and dP^T = V dO^T as SS m64n32k16 on 32-query halves, Q
//     MN-major): five products instead of four, so that one accumulator a
//     warpgroup (64 fp32 a thread at d 128) and the scores fit 168
//     registers. K4 (d 64 / 128) and K2 at d 128 run this body.
//   * dk/dv at d <= 72 (K2's ViT and LM): dK and dV together fit one
//     warpgroup, so a block owns 128 keys and each warpgroup computes S^T,
//     dP^T, dV and dK for its own 64 (attention_dkv_pair_kernel below): four
//     products, one exp2 per element, each Q / dO tile shared by 128 keys.
//   * dq: a block owns a 128-row query tile of one query head, 64 rows per
//     consumer warpgroup; Q and dO stay resident and the kv head's 64-key K
//     and V tiles stream through a 4-stage ring. Each warpgroup computes S =
//     Q K^T and dP = dO V^T (SS m64n64k16), P = exp2(S scale log2(e) - lse
//     log2(e)) and dS = P (dP - delta) in registers, rounded to bf16 as the
//     A operand of dQ += dS K (RS, K MN-major). The producer classes each
//     key tile for both warpgroups, loads the ones not both skip and hands
//     each stage's tile index and classes to the consumers beside it (and a
//     policy's key ids, K4), then a last stage that ends the walk: the
//     consumers hold no class state. Delta = rowsum(o do) in fp32
//     is computed in the prologue by each quad of threads for its two rows
//     from o and do in device memory, and stored (B, H, Sq) for the dk/dv
//     launch that follows on the same stream. dq = scale dQ at the end.
//
// Head dims: the column plan of hopper_attention_fwd.cuh (d 64 = one 64-
// column piece, 128 = two, 72 = a 64-column piece with the 128-byte swizzle
// and a 16-column piece with the 32-byte swizzle whose columns 72-79 TMA
// zero-fills). The products whose reduced dim is d (S, dP and their
// transposes) take 4 k16 steps on each 64-column piece and 1 on the 16-
// column one; the products whose N is d (dV, dK, dQ, with dO, Q or K MN-
// major) become an RS product of N = 64 (or 128) and one of N = 16. Only
// columns < d are stored: in the ViT's flat (n S, 3 H D) gradient buffer
// columns 72-79 are the next head's.
//
// Mask policies. A policy class has CAUSAL, Params and two nested classes,
// built once per block from its Params:
//   KeyBlock (dk/dv; 64 keys from k0; the pair kernel builds one a
//   warpgroup): k_live() (false: zero dk and dv rows, and a block with no
//   live key exits before the pipeline), locate(lane) (run by warp 0, all
//   32 lanes, before the walk, which the block then shares: a policy that
//   finds its walk in device memory does it here; the others do nothing),
//   q_begin() / q_end()
//   (the query tiles to walk), pair(qt) (SKIP / MASKED / UNMASKED), stage()
//   (the producer warp's staging of a query tile's rows: lse log2(e),
//   delta, ids), keys() (per-thread state of its two keys), apply() (the
//   per-element mask of a MASKED pair on four probabilities) and key_live()
//   (a dead key row is stored as zeros).
//   QueryBlock (dq; 128 rows from q0): qtile() (the query tile a block's
//   tile index names), q_live() (false: zeros and delta 0 and exit),
//   locate(lane) (run by warp 0, all 32 lanes, before the walk, which the
//   block then shares), first() and ntiles() (the key tiles [first,
//   ntiles) to walk), pair(t, cw) (the class of key tile t for
//   warpgroup cw's 64 rows; a tile that both warpgroups skip is not
//   loaded), IDS and stage(ids, t, lane) (the producer warp's staging of
//   IDS ints beside each K / V stage; IDS = 0 stages nothing), rows()
//   (per-thread state of its two query rows), apply() (the per-element mask
//   of a MASKED pair on four probabilities) and row_live() (a dead row gets
//   dq 0 and delta 0).

#pragma once

#include "hopper_attention_fwd.cuh"

namespace visrag {
namespace hopper {

constexpr int DKV_BQ = 64, DKV_BK = 64;   // dk/dv: query rows a stage, keys
constexpr int DQ_BQ = 128, DQ_BK = 64;    // dq: query rows a block, keys

// Tensor maps of q, k, v, do: one per piece of the column plan.
struct BwdMaps {
  CUtensorMap q, k, v, dO;                       // the 64-column pieces
  CUtensorMap q_tail, k_tail, v_tail, do_tail;   // the 16-column piece
};

struct BwdParams {
  const __nv_bfloat16* o;    // dq: the forward's output, for delta
  const __nv_bfloat16* dO;   // dq: do in device memory, for delta
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const float* lse;          // (B, H, Sq), natural log
  float* delta;              // (B, H, Sq): the dq kernel writes, dk/dv reads
  long long o_sb, o_sr, o_sh;
  long long do_sb, do_sr, do_sh;
  long long dq_sb, dq_sr, dq_sh;
  long long dk_sb, dk_sr, dk_sh;
  long long dv_sb, dv_sr, dv_sh;
  int sq, sk, heads, kv_group;
  float scale;
  // the grid's order, the launcher's choice: the tile index fastest (x),
  // or slowest (z) after the head (x) and the batch row (y)
  int tile_fastest;
};

// The (head, batch row, tile) a block owns in the launcher's grid order.
struct BlockAt {
  int head, b, tile;
};
__device__ __forceinline__ BlockAt block_at(int tile_fastest) {
  return tile_fastest ? BlockAt{static_cast<int>(blockIdx.y),
                                static_cast<int>(blockIdx.z),
                                static_cast<int>(blockIdx.x)}
                      : BlockAt{static_cast<int>(blockIdx.x),
                                static_cast<int>(blockIdx.y),
                                static_cast<int>(blockIdx.z)};
}

// Zeros in `rows` rows of D columns from `base` (row stride `sr`), every
// thread of the block storing 16 bytes at a time.
template <int D>
__device__ __forceinline__ void zero_rows(__nv_bfloat16* base, long long sr,
                                          int rows) {
  constexpr int VECS = D / 8;
  for (int i = threadIdx.x; i < rows * VECS; i += WS_THREADS)
    *reinterpret_cast<uint4*>(base + (i / VECS) * sr + (i % VECS) * 8) =
        make_uint4(0, 0, 0, 0);
}

// ---- dk/dv --------------------------------------------------------------------

// Shared memory of a dk/dv block of KEYS keys: the K and V tiles, then a
// 4-stage ring of Q and dO tiles with each stage's rows (lse * log2(e),
// delta, then the ids, DKV_BQ each), then the barriers.
template <int D, int KEYS>
struct DkvTiles {
  static constexpr int STAGES = 4;
  static constexpr int KV = KEYS * ColumnPlan<D>::ROW;     // K or V tile
  static constexpr int QT = DKV_BQ * ColumnPlan<D>::ROW;   // a Q or dO tile
  static constexpr int ROWS = DKV_BQ * 12;                 // lse, delta, ids
  static constexpr int BARS = (1 + 2 * STAGES) * 8;
  static constexpr size_t BYTES =
      1024 + 2 * KV + 2 * STAGES * QT + STAGES * ROWS + BARS;
  unsigned char* sK;
  unsigned char* sV;
  unsigned char* sQ;       // STAGES Q tiles
  unsigned char* sdO;      // STAGES dO tiles
  float* sRows;
  uint64_t* kv_full;
  uint64_t* full;
  uint64_t* empty;

  __device__ __forceinline__ explicit DkvTiles(unsigned char* smem_raw) {
    unsigned char* smem =
        smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    sK = smem;
    sV = sK + KV;
    sQ = sV + KV;
    sdO = sQ + STAGES * QT;
    sRows = reinterpret_cast<float*>(sdO + STAGES * QT);
    kv_full = reinterpret_cast<uint64_t*>(sRows + STAGES * 3 * DKV_BQ);
    full = kv_full + 1;
    empty = full + STAGES;
  }
  // thread 0 initialises the barriers; the block then syncs
  __device__ __forceinline__ void init_barriers() const {
    if (threadIdx.x == 0) {
      mbar_init(kv_full, 1);
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], CONSUMERS);
      }
      fence_barrier_init();
    }
    __syncthreads();
  }
};

// The dk/dv producer warpgroup. Warp 0 loads the block's K and V tiles (KEYS
// rows from k0); warp w then serves ring stage w: for each (query head of
// the group, query tile) that `skip` does not drop, in order, the warp
// that owns the tile's stage stages its rows through `stager` (lse *
// log2(e), delta, ids) from device memory and its lane 0 issues the tile's
// Q and dO loads. Four warps keep four tiles' row loads in flight, where
// one warp waited out each tile's load latency in turn.
template <int D, int KEYS, class KB, class Skip>
__device__ __forceinline__ void dkv_produce(const DkvTiles<D, KEYS>& t,
                                            const BwdMaps& maps,
                                            const BwdParams& p,
                                            const KB& stager, Skip skip,
                                            int hk, int b, int k0,
                                            const int2* walk) {
  using T = DkvTiles<D, KEYS>;
  static_assert(T::STAGES * 32 == WS_THREADS - PRODUCER,
                "one producer warp a stage");
  setmaxnreg_dec<PRODUCER_REGS>();
  const int q_begin = walk->x, q_end = walk->y;
  const int pw = (threadIdx.x - PRODUCER) / 32;
  const int lane = threadIdx.x % 32;
  if (pw == 0 && lane == 0) {
    mbar_arrive_expect_tx(t.kv_full, 2 * T::KV);
    load_tile<D>(t.sK, KEYS, &maps.k, &maps.k_tail, t.kv_full, k0, hk, b);
    load_tile<D>(t.sV, KEYS, &maps.v, &maps.v_tail, t.kv_full, k0, hk, b);
  }
  if (lane == 0) {
    tma_prefetch(&maps.q);
    tma_prefetch(&maps.dO);
    if constexpr (ColumnPlan<D>::TAIL > 0) {
      tma_prefetch(&maps.q_tail);
      tma_prefetch(&maps.do_tail);
    }
  }
  Ring<T::STAGES> ring;
  for (int h = hk * p.kv_group; h < (hk + 1) * p.kv_group; ++h) {
    const long long at = (static_cast<long long>(b) * p.heads + h) * p.sq;
    for (int qt = q_begin; qt < q_end; ++qt) {
      if (skip(qt)) continue;
      if (ring.stage == pw) {
        mbar_wait(&t.empty[pw], ring.phase ^ 1u);
        stager.stage(t.sRows + pw * 3 * DKV_BQ, p.lse + at, p.delta + at, qt,
                     lane);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(&t.full[pw], 2 * T::QT);
          load_tile<D>(t.sQ + pw * T::QT, DKV_BQ, &maps.q, &maps.q_tail,
                       &t.full[pw], qt * DKV_BQ, h, b);
          load_tile<D>(t.sdO + pw * T::QT, DKV_BQ, &maps.dO, &maps.do_tail,
                       &t.full[pw], qt * DKV_BQ, h, b);
        }
      }
      ring.advance();
    }
  }
}

template <int D, class Mask>
__global__ void __launch_bounds__(WS_THREADS, 1)
attention_dkv_wgmma_kernel(const __grid_constant__ BwdMaps maps,
                           const BwdParams p,
                           const typename Mask::Params mp) {
  using S = DkvTiles<D, DKV_BK>;
  using C = ColumnPlan<D>;
  using KB = typename Mask::KeyBlock;
  static_assert(C::TAIL == 0, "the split dk/dv body: d 64 or 128");
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const S tiles(smem_raw);
  unsigned char* sK = tiles.sK;
  unsigned char* sV = tiles.sV;
  unsigned char* sQ = tiles.sQ;
  unsigned char* sdO = tiles.sdO;
  float* sRows = tiles.sRows;
  uint64_t* full = tiles.full;
  uint64_t* empty = tiles.empty;

  const BlockAt blk = block_at(p.tile_fastest);
  const int hk = blk.head, b = blk.b, kt = blk.tile;
  const int k0 = kt * DKV_BK;
  const int sq = p.sq, sk = p.sk;
  const int nq = (sq + DKV_BQ - 1) / DKV_BQ, nk = (sk + DKV_BK - 1) / DKV_BK;
  KB mask(mp, b, kt, k0, nq, nk, sq, sk);
  if (!mask.k_live()) {
    const int rows = min(DKV_BK, sk - k0);
    zero_rows<D>(p.dk + b * p.dk_sb + hk * p.dk_sh + k0 * p.dk_sr, p.dk_sr,
                 rows);
    zero_rows<D>(p.dv + b * p.dv_sb + hk * p.dv_sh + k0 * p.dv_sr, p.dv_sr,
                 rows);
    return;
  }
  // the work: the group's query heads (outer) x the query tiles the policy
  // names (inner), active pairs only; the walk found once, by warp 0, and
  // shared through the block barrier
  __shared__ int2 walk;
  if (threadIdx.x < 32) {
    mask.locate(threadIdx.x);
    if (threadIdx.x == 0) walk = make_int2(mask.q_begin(), mask.q_end());
  }
  tiles.init_barriers();
  if (threadIdx.x >= PRODUCER) {
    dkv_produce(tiles, maps, p, mask,
                [&](int qt) { return mask.pair(qt) == SKIP; }, hk, b, k0,
                &walk);
    return;
  }

  // ---- consumers: both warpgroups walk the block's 64 keys; warpgroup 0
  // accumulates dV, warpgroup 1 dK
  setmaxnreg_inc<CONSUMER_REGS>();
  const int q_begin = walk.x, q_end = walk.y;
  const int cw = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int key_lo = k0 + 16 * warp + g, key_hi = key_lo + 8;
  const typename KB::Keys keys = mask.keys(key_lo, key_hi);
  const float sl2 = p.scale * LOG2E;

  mbar_wait(tiles.kv_full, 0);

  // P^T of one pair of query columns c, c + 1 for this thread's two keys:
  // exp2(S^T scale log2(e) - lse log2(e)), masked per element on a MASKED
  // pair
  auto probs = [&](const float* rows, int cls, int q0, int c, float s0,
                   float s1, float s2, float s3, float (&pr)[4]) {
    const float2 l2 = *reinterpret_cast<const float2*>(rows + c);
    pr[0] = exp2f(fmaf(s0, sl2, -l2.x));
    pr[1] = exp2f(fmaf(s1, sl2, -l2.y));
    pr[2] = exp2f(fmaf(s2, sl2, -l2.x));
    pr[3] = exp2f(fmaf(s3, sl2, -l2.y));
    if (cls == MASKED) mask.apply(pr, keys, rows, c, q0 + c, key_lo, key_hi);
  };
  // the K (or V) tile as the K-major A operand
  auto kv_desc = [&](unsigned char* tile) {
    return make_desc(opaque(smem_u32(tile)), 16, 1024);
  };
  // writes one accumulator's rows times `mul`; a dead key row is zeros
  auto store = [&](const float (&acc)[D / 2], __nv_bfloat16* out,
                   long long sr, float mul) {
    const bool live_lo = mask.key_live(key_lo), live_hi = mask.key_live(key_hi);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (key_lo < sk)
        *reinterpret_cast<uint32_t*>(out + key_lo * sr + col) =
            live_lo ? pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul) : 0u;
      if (key_hi < sk)
        *reinterpret_cast<uint32_t*>(out + key_hi * sr + col) =
            live_hi ? pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul)
                    : 0u;
    }
  };

  // One accumulator a warpgroup (64 fp32 a thread at d = 128), so that it
  // and the scores fit the registers ptxas gives a consumer thread (168)
  // without serializing the wgmma pipeline. Both compute S^T (5 products
  // instead of 4); both release each stage.
  Ring<STAGES> ring;
  if (cw == 0) {
    float dv[D / 2];
    zero(dv);
    for (int h = 0; h < p.kv_group; ++h) {
      for (int qt = q_begin; qt < q_end; ++qt) {
        const int cls = mask.pair(qt);
        if (cls == SKIP) continue;
        mbar_wait(&full[ring.stage], ring.phase);
        const uint32_t q_src = smem_u32(sQ) + ring.stage * S::QT;
        const uint32_t do_src = smem_u32(sdO) + ring.stage * S::QT;
        const float* rows = sRows + ring.stage * 3 * DKV_BQ;

        // S^T = K Q^T: 64 keys x 64 queries, Q the K-major B operand
        float s[32];
        const uint64_t k_desc = kv_desc(sK);
        const uint64_t q_desc = make_desc(q_src, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<64, 0>(
              s, desc_add(k_desc, (kk / 4) * DKV_BK * HALF_ROW + (kk % 4) * 32),
              desc_add(q_desc, (kk / 4) * DKV_BQ * HALF_ROW + (kk % 4) * 32),
              kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

        // P^T, rounded to bf16 in the A-fragment order; dV += P^T dO with
        // dO MN-major (k16 = 16 queries = 2048 bytes; LBO = the distance
        // between the d halves)
        uint32_t pa[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float pr[4];
          probs(rows, cls, qt * DKV_BQ, 8 * j + 2 * t4, s[4 * j], s[4 * j + 1],
                s[4 * j + 2], s[4 * j + 3], pr);
          pa[j / 2][2 * (j % 2)] = pack_bf16(pr[0], pr[1]);
          pa[j / 2][2 * (j % 2) + 1] = pack_bf16(pr[2], pr[3]);
        }
        const uint64_t do_mn = make_desc(do_src, DKV_BQ * HALF_ROW, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DKV_BQ / 16; ++kk)
          wgmma_rs<D, 1>(dv, pa[kk], desc_add(do_mn, kk * 16 * HALF_ROW), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(pa);
        if (tid == 0) mbar_arrive(&empty[ring.stage]);
        ring.advance();
      }
    }
    store(dv, p.dv + b * p.dv_sb + hk * p.dv_sh, p.dv_sr, 1.f);
  } else {
    float dk[D / 2];
    zero(dk);
    for (int h = 0; h < p.kv_group; ++h) {
      for (int qt = q_begin; qt < q_end; ++qt) {
        const int cls = mask.pair(qt);
        if (cls == SKIP) continue;
        mbar_wait(&full[ring.stage], ring.phase);
        const uint32_t q_src = smem_u32(sQ) + ring.stage * S::QT;
        const uint32_t do_src = smem_u32(sdO) + ring.stage * S::QT;
        const float* rows = sRows + ring.stage * 3 * DKV_BQ;

        // the 64 queries as two halves of 32
#pragma unroll 1
        for (int half = 0; half < 2; ++half) {
          const int c0 = 32 * half;
          const uint32_t q_half = q_src + c0 * HALF_ROW;
          const uint32_t do_half = do_src + c0 * HALF_ROW;

          // S^T = K Q^T and dP^T = V dO^T: 64 keys x 32 queries each
          float s[16], dp[16];
          const uint64_t k_desc = kv_desc(sK);
          const uint64_t v_desc = kv_desc(sV);
          const uint64_t q_desc = make_desc(q_half, 16, 1024);
          const uint64_t do_desc = make_desc(do_half, 16, 1024);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off_k =
                (kk / 4) * DKV_BK * HALF_ROW + (kk % 4) * 32;
            const uint32_t off_q =
                (kk / 4) * DKV_BQ * HALF_ROW + (kk % 4) * 32;
            wgmma_ss<32, 0>(s, desc_add(k_desc, off_k),
                            desc_add(q_desc, off_q), kk > 0);
          }
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off_k =
                (kk / 4) * DKV_BK * HALF_ROW + (kk % 4) * 32;
            const uint32_t off_q =
                (kk / 4) * DKV_BQ * HALF_ROW + (kk % 4) * 32;
            wgmma_ss<32, 0>(dp, desc_add(v_desc, off_k),
                            desc_add(do_desc, off_q), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);
          fence_regs(dp);

          // dS^T = P^T (dP^T - delta) in bf16; dK += dS^T Q, Q MN-major
          uint32_t da[2][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + 8 * j + 2 * t4;
            float pr[4];
            probs(rows, cls, qt * DKV_BQ, c, s[4 * j], s[4 * j + 1],
                  s[4 * j + 2], s[4 * j + 3], pr);
            const float2 dl =
                *reinterpret_cast<const float2*>(rows + DKV_BQ + c);
            da[j / 2][2 * (j % 2)] = pack_bf16(
                pr[0] * (dp[4 * j] - dl.x), pr[1] * (dp[4 * j + 1] - dl.y));
            da[j / 2][2 * (j % 2) + 1] =
                pack_bf16(pr[2] * (dp[4 * j + 2] - dl.x),
                          pr[3] * (dp[4 * j + 3] - dl.y));
          }
          const uint64_t q_mn = make_desc(q_half, DKV_BQ * HALF_ROW, 1024);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            wgmma_rs<D, 1>(dk, da[kk], desc_add(q_mn, kk * 16 * HALF_ROW), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dk);
          fence_regs(da);
        }
        if (tid == 0) mbar_arrive(&empty[ring.stage]);
        ring.advance();
      }
    }
    store(dk, p.dk + b * p.dk_sb + hk * p.dk_sh, p.dk_sr, p.scale);
  }
}

// ---- dk/dv, a warpgroup a key tile (d <= 72) ------------------------------

// At d <= 72 a consumer's dK and dV together are 64-80 registers, so one
// warpgroup can hold both: a block owns 128 keys, warpgroup w the 64 from
// k0 + 64 w, and each computes S^T, dP^T, dV and dK for its own keys: four
// products instead of the split kernel's five, P^T's exp2 once, and each
// streamed Q / dO tile serves 128 keys. (PERF.md, PR 9.) The mask policy's
// KeyBlock classes each warpgroup's 64 keys; the producer loads a query
// tile that either warpgroup needs, and a warpgroup whose pair is SKIP (or
// whose keys are all dead) waits for the stage and releases it.

template <int D, class Mask>
__global__ void __launch_bounds__(WS_THREADS, 1)
attention_dkv_pair_kernel(const __grid_constant__ BwdMaps maps,
                          const BwdParams p,
                          const typename Mask::Params mp) {
  constexpr int BK2 = 2 * DKV_BK;                 // the block's keys
  using S = DkvTiles<D, BK2>;
  using C = ColumnPlan<D>;
  using KB = typename Mask::KeyBlock;
  static_assert(C::HALVES == 1, "a warpgroup a key tile: d <= 72");
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const S tiles(smem_raw);
  unsigned char* sK = tiles.sK;
  unsigned char* sV = tiles.sV;
  unsigned char* sQ = tiles.sQ;
  unsigned char* sdO = tiles.sdO;
  float* sRows = tiles.sRows;
  uint64_t* full = tiles.full;
  uint64_t* empty = tiles.empty;

  const BlockAt blk = block_at(p.tile_fastest);
  const int hk = blk.head, b = blk.b;
  const int k0 = blk.tile * BK2;
  const int sq = p.sq, sk = p.sk;
  const int nq = (sq + DKV_BQ - 1) / DKV_BQ, nk = (sk + DKV_BK - 1) / DKV_BK;
  // the two warpgroups' 64-key tiles (the second may lie past sk)
  KB kb0(mp, b, 2 * blk.tile, k0, nq, nk, sq, sk);
  KB kb1(mp, b, min(2 * blk.tile + 1, nk - 1), k0 + DKV_BK, nq, nk, sq, sk);
  const bool live1 = k0 + DKV_BK < sk && kb1.k_live();
  if (!kb0.k_live()) {
    const int rows = min(BK2, sk - k0);
    zero_rows<D>(p.dk + b * p.dk_sb + hk * p.dk_sh + k0 * p.dk_sr, p.dk_sr,
                 rows);
    zero_rows<D>(p.dv + b * p.dv_sb + hk * p.dv_sh + k0 * p.dv_sr, p.dv_sr,
                 rows);
    return;
  }
  // the walk over both warpgroups' key tiles, found once, by warp 0, and
  // shared through the block barrier
  __shared__ int2 walk;
  if (threadIdx.x < 32) {
    kb0.locate(threadIdx.x);
    if (live1) kb1.locate(threadIdx.x);
    if (threadIdx.x == 0)
      walk = live1 ? make_int2(min(kb0.q_begin(), kb1.q_begin()),
                               max(kb0.q_end(), kb1.q_end()))
                   : make_int2(kb0.q_begin(), kb0.q_end());
  }
  auto pair_of = [&](int w, int qt) {
    return w == 0 ? kb0.pair(qt) : (live1 ? kb1.pair(qt) : int(SKIP));
  };
  tiles.init_barriers();
  if (threadIdx.x >= PRODUCER) {
    dkv_produce(tiles, maps, p, kb0,
                [&](int qt) {
                  return pair_of(0, qt) == SKIP && pair_of(1, qt) == SKIP;
                },
                hk, b, k0, &walk);
    return;
  }

  // ---- consumers: warpgroup cw owns keys [k0 + 64 cw, k0 + 64 cw + 64)
  setmaxnreg_inc<CONSUMER_REGS>();
  const int q_begin = walk.x, q_end = walk.y;
  const int cw = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const KB kb = cw == 0 ? kb0 : kb1;
  const int key_lo = k0 + DKV_BK * cw + 16 * warp + g, key_hi = key_lo + 8;
  const typename KB::Keys keys = kb.keys(key_lo, key_hi);
  const float sl2 = p.scale * LOG2E;
  // this warpgroup's 64 rows of the K and V tiles: the 64-column piece
  // (128-byte swizzle, 8-row atoms) and the 16-column piece (32-byte)
  const uint32_t k_rows = smem_u32(sK) + DKV_BK * cw * HALF_ROW;
  const uint32_t v_rows = smem_u32(sV) + DKV_BK * cw * HALF_ROW;
  const uint32_t k_tail = smem_u32(sK) + BK2 * HALF_ROW + DKV_BK * cw * TAIL_ROW;
  const uint32_t v_tail = smem_u32(sV) + BK2 * HALF_ROW + DKV_BK * cw * TAIL_ROW;

  float dv[32], dk[32];
  zero(dv);
  zero(dk);
  float dvt[C::TAIL > 0 ? C::TAIL / 2 : 1], dkt[C::TAIL > 0 ? C::TAIL / 2 : 1];
  zero(dvt);
  zero(dkt);
  mbar_wait(tiles.kv_full, 0);

  Ring<STAGES> ring;
  for (int h = 0; h < p.kv_group; ++h) {
    for (int qt = q_begin; qt < q_end; ++qt) {
      const int cls = pair_of(cw, qt);
      if (cls == SKIP && pair_of(cw ^ 1, qt) == SKIP) continue;
      mbar_wait(&full[ring.stage], ring.phase);
      if (cls != SKIP) {
        const uint32_t q_src = smem_u32(sQ) + ring.stage * S::QT;
        const uint32_t do_src = smem_u32(sdO) + ring.stage * S::QT;
        const float* rows = sRows + ring.stage * 3 * DKV_BQ;
#pragma unroll 1
        for (int half = 0; half < 2; ++half) {
          const int c0 = 32 * half;
          const uint32_t q_half = q_src + c0 * HALF_ROW;
          const uint32_t do_half = do_src + c0 * HALF_ROW;
          const uint32_t q_tail = q_src + DKV_BQ * HALF_ROW + c0 * TAIL_ROW;
          const uint32_t do_tail = do_src + DKV_BQ * HALF_ROW + c0 * TAIL_ROW;

          // S^T = K Q^T and dP^T = V dO^T: 64 keys x 32 queries each
          float s[16], dp[16];
          const uint64_t k_desc = make_desc(opaque(k_rows), 16, 1024);
          const uint64_t v_desc = make_desc(opaque(v_rows), 16, 1024);
          const uint64_t q_desc = make_desc(q_half, 16, 1024);
          const uint64_t do_desc = make_desc(do_half, 16, 1024);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<32, 0>(s, desc_add(k_desc, kk * 32),
                            desc_add(q_desc, kk * 32), kk > 0);
          if constexpr (C::TAIL > 0)
            wgmma_ss<32, 0>(s, make_desc<32>(opaque(k_tail), 16, 256),
                            make_desc<32>(q_tail, 16, 256), 1);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<32, 0>(dp, desc_add(v_desc, kk * 32),
                            desc_add(do_desc, kk * 32), kk > 0);
          if constexpr (C::TAIL > 0)
            wgmma_ss<32, 0>(dp, make_desc<32>(opaque(v_tail), 16, 256),
                            make_desc<32>(do_tail, 16, 256), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);
          fence_regs(dp);

          // P^T and dS^T = P^T (dP^T - delta), rounded to bf16 in the
          // A-fragment order
          uint32_t pa[2][4], da[2][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + 8 * j + 2 * t4;
            const float2 l2 = *reinterpret_cast<const float2*>(rows + c);
            float pr[4] = {exp2f(fmaf(s[4 * j], sl2, -l2.x)),
                           exp2f(fmaf(s[4 * j + 1], sl2, -l2.y)),
                           exp2f(fmaf(s[4 * j + 2], sl2, -l2.x)),
                           exp2f(fmaf(s[4 * j + 3], sl2, -l2.y))};
            if (cls == MASKED)
              kb.apply(pr, keys, rows, c, qt * DKV_BQ + c, key_lo, key_hi);
            const float2 dl =
                *reinterpret_cast<const float2*>(rows + DKV_BQ + c);
            pa[j / 2][2 * (j % 2)] = pack_bf16(pr[0], pr[1]);
            pa[j / 2][2 * (j % 2) + 1] = pack_bf16(pr[2], pr[3]);
            da[j / 2][2 * (j % 2)] = pack_bf16(
                pr[0] * (dp[4 * j] - dl.x), pr[1] * (dp[4 * j + 1] - dl.y));
            da[j / 2][2 * (j % 2) + 1] =
                pack_bf16(pr[2] * (dp[4 * j + 2] - dl.x),
                          pr[3] * (dp[4 * j + 3] - dl.y));
          }

          // dV += P^T dO and dK += dS^T Q, dO and Q MN-major
          const uint64_t do_mn = make_desc(do_half, DKV_BQ * HALF_ROW, 1024);
          const uint64_t dot_mn = make_desc<32>(do_tail, 256, 256);
          const uint64_t q_mn = make_desc(q_half, DKV_BQ * HALF_ROW, 1024);
          const uint64_t qt_mn = make_desc<32>(q_tail, 256, 256);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            wgmma_rs<64, 1>(dv, pa[kk], desc_add(do_mn, kk * 16 * HALF_ROW),
                            1);
            if constexpr (C::TAIL > 0)
              wgmma_rs<16, 1>(dvt, pa[kk],
                              desc_add(dot_mn, kk * 16 * TAIL_ROW), 1);
            wgmma_rs<64, 1>(dk, da[kk], desc_add(q_mn, kk * 16 * HALF_ROW), 1);
            if constexpr (C::TAIL > 0)
              wgmma_rs<16, 1>(dkt, da[kk],
                              desc_add(qt_mn, kk * 16 * TAIL_ROW), 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv);
          fence_regs(dk);
          if constexpr (C::TAIL > 0) {
            fence_regs(dvt);
            fence_regs(dkt);
          }
          fence_regs(pa);
          fence_regs(da);
        }
      }
      if (tid == 0) mbar_arrive(&empty[ring.stage]);
      ring.advance();
    }
  }

  // epilogue: the warpgroup's 64 keys (dead ones as zeros; rows past sk
  // not stored), columns < D
  const bool live_lo = kb.key_live(key_lo) && (cw == 0 || live1);
  const bool live_hi = kb.key_live(key_hi) && (cw == 0 || live1);
  auto store = [&](const float (&acc)[32],
                   const float (&acct)[C::TAIL > 0 ? C::TAIL / 2 : 1],
                   __nv_bfloat16* out, long long sr, float mul) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (key_lo < sk)
        *reinterpret_cast<uint32_t*>(out + key_lo * sr + col) =
            live_lo ? pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul) : 0u;
      if (key_hi < sk)
        *reinterpret_cast<uint32_t*>(out + key_hi * sr + col) =
            live_hi ? pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul)
                    : 0u;
    }
    if constexpr (C::TAIL > 0) {
#pragma unroll
      for (int j = 0; j < (D - 64) / 8; ++j) {
        const int col = 64 + 8 * j + 2 * t4;
        if (key_lo < sk)
          *reinterpret_cast<uint32_t*>(out + key_lo * sr + col) =
              live_lo ? pack_bf16(acct[4 * j] * mul, acct[4 * j + 1] * mul)
                      : 0u;
        if (key_hi < sk)
          *reinterpret_cast<uint32_t*>(out + key_hi * sr + col) =
              live_hi ? pack_bf16(acct[4 * j + 2] * mul,
                                  acct[4 * j + 3] * mul)
                      : 0u;
      }
    }
  };
  store(dv, dvt, p.dv + b * p.dv_sb + hk * p.dv_sh, p.dv_sr, 1.f);
  store(dk, dkt, p.dk + b * p.dk_sb + hk * p.dk_sh, p.dk_sr, p.scale);
}

// ---- dq -----------------------------------------------------------------------

template <int D, int IDS>
struct DqSmem {
  static constexpr int STAGES = 4;
  static constexpr int QT = DQ_BQ * ColumnPlan<D>::ROW;   // the Q or dO tile
  static constexpr int KV = DQ_BK * ColumnPlan<D>::ROW;   // a K or V tile
  static constexpr int IDS_BYTES = STAGES * IDS * 4;      // staged key ids
  static constexpr int INFO_BYTES = STAGES * 4;           // a stage's tile
  static constexpr int BARS = (1 + 2 * STAGES) * 8;
  static constexpr size_t BYTES =
      1024 + 2 * QT + 2 * STAGES * KV + IDS_BYTES + INFO_BYTES + BARS;
};

// sum_d o[row][d] * do[row][d] in fp32 over the columns this thread of a
// quad takes (16-byte vectors t4, t4 + 4, ...); the quad's sum is the row's.
template <int D>
__device__ __forceinline__ float row_dot(const __nv_bfloat16* o,
                                         const __nv_bfloat16* d, int t4) {
  float acc = 0.f;
#pragma unroll
  for (int c = t4; c < D / 8; c += 4) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + 8 * c);
    const uint4 e = *reinterpret_cast<const uint4*>(d + 8 * c);
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
    const uint32_t ew[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&aw[i]));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&ew[i]));
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  return acc;
}

// A loaded key tile as the producer hands it to the consumers: its index
// and the classes of warpgroups 0 and 1 (-1 ends the walk).
__device__ __forceinline__ int pack_tile(int t, int c0, int c1) {
  return (t << 4) | (c1 << 2) | c0;
}

template <int D, class Mask>
__global__ void __launch_bounds__(WS_THREADS, 1)
attention_dq_wgmma_kernel(const __grid_constant__ BwdMaps maps,
                          const BwdParams p,
                          const typename Mask::Params mp) {
  using QB = typename Mask::QueryBlock;
  using S = DqSmem<D, QB::IDS>;
  using C = ColumnPlan<D>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sQ = smem;
  unsigned char* sdO = sQ + S::QT;
  unsigned char* sK = sdO + S::QT;                  // STAGES K tiles
  unsigned char* sV = sK + STAGES * S::KV;          // STAGES V tiles
  int* sIds = reinterpret_cast<int*>(sV + STAGES * S::KV);   // STAGES x IDS
  int* sInfo = sIds + STAGES * QB::IDS;                       // STAGES
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sInfo + STAGES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const BlockAt blk = block_at(p.tile_fastest);
  const int h = blk.head, b = blk.b;
  const int sq = p.sq, sk = p.sk;
  const int nq = (sq + DQ_BQ - 1) / DQ_BQ, nk = (sk + DQ_BK - 1) / DQ_BK;
  const int qt = QB::qtile(mp, b, blk.tile, nq, sk);
  const int q0 = qt * DQ_BQ;
  const int hk = h / p.kv_group;
  const long long at = (static_cast<long long>(b) * p.heads + h) * sq;
  QB mask(mp, b, qt, q0, nq, nk, sq, sk);
  if (!mask.q_live()) {
    // a dead tile: dq 0 and delta 0 in its rows
    const int rows = min(DQ_BQ, sq - q0);
    zero_rows<D>(p.dq + b * p.dq_sb + h * p.dq_sh + q0 * p.dq_sr, p.dq_sr,
                 rows);
    for (int r = threadIdx.x; r < rows; r += WS_THREADS)
      p.delta[at + q0 + r] = 0.f;
    return;
  }
  // the walk, found once, by warp 0 before the register split, and shared
  // through the block barrier: the producer's code after setmaxnreg.dec
  // stays within its registers
  __shared__ int2 walk;
  if (threadIdx.x < 32) {
    mask.locate(threadIdx.x);
    if (threadIdx.x == 0) walk = make_int2(mask.first(), mask.ntiles());
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= PRODUCER) {
    // ---- producer: one warp issues every load (lane 0) and stages the
    // policy's key ids (the whole warp)
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= PRODUCER + 32) return;
    const int lane = threadIdx.x - PRODUCER;
    if (lane == 0) {
      tma_prefetch(&maps.k);
      tma_prefetch(&maps.v);
      if constexpr (C::TAIL > 0) {
        tma_prefetch(&maps.k_tail);
        tma_prefetch(&maps.v_tail);
      }
      mbar_arrive_expect_tx(q_full, 2 * S::QT);
      load_tile<D>(sQ, DQ_BQ, &maps.q, &maps.q_tail, q_full, q0, h, b);
      load_tile<D>(sdO, DQ_BQ, &maps.dO, &maps.do_tail, q_full, q0, h, b);
    }
    if (QB::IDS == 0 && lane != 0) return;
    Ring<STAGES> ring;
    for (int t = walk.x, end = walk.y; t < end; ++t) {
      const int c0 = mask.pair(t, 0), c1 = mask.pair(t, 1);
      if (c0 == SKIP && c1 == SKIP) continue;
      mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
      // ids only where a warpgroup masks per element
      if constexpr (QB::IDS > 0) {
        if (c0 == MASKED || c1 == MASKED)
          mask.stage(sIds + ring.stage * QB::IDS, t, lane);
        __syncwarp();
      }
      if (lane == 0) {
        sInfo[ring.stage] = pack_tile(t, c0, c1);
        mbar_arrive_expect_tx(&full[ring.stage], 2 * S::KV);
        load_tile<D>(sK + ring.stage * S::KV, DQ_BK, &maps.k, &maps.k_tail,
                     &full[ring.stage], t * DQ_BK, hk, b);
        load_tile<D>(sV + ring.stage * S::KV, DQ_BK, &maps.v, &maps.v_tail,
                     &full[ring.stage], t * DQ_BK, hk, b);
      }
      ring.advance();
    }
    // the end of the walk: one more stage, with no tile
    if (lane == 0) {
      mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
      sInfo[ring.stage] = -1;
      mbar_arrive(&full[ring.stage]);
    }
    return;
  }

  // ---- consumers: warpgroup cw owns query rows [64 cw, 64 cw + 64)
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int row_lo = q0 + 64 * cw + 16 * warp + g, row_hi = row_lo + 8;
  const bool live_lo = mask.row_live(row_lo), live_hi = mask.row_live(row_hi);
  const typename QB::Rows rows = mask.rows(row_lo, row_hi);
  const float sl2 = p.scale * LOG2E;

  // delta = rowsum(o do) of the thread's two rows, a quad a row pair, while
  // the Q and dO tiles are in flight; stored for the dk/dv kernel
  const __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
  const __nv_bfloat16* dob = p.dO + b * p.do_sb + h * p.do_sh;
  float dl_lo = live_lo ? row_dot<D>(ob + row_lo * p.o_sr,
                                     dob + row_lo * p.do_sr, t4)
                        : 0.f;
  float dl_hi = live_hi ? row_dot<D>(ob + row_hi * p.o_sr,
                                     dob + row_hi * p.do_sr, t4)
                        : 0.f;
  dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, 1);
  dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, 2);
  dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, 1);
  dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, 2);
  if (t4 == 0) {
    if (row_lo < sq) p.delta[at + row_lo] = dl_lo;
    if (row_hi < sq) p.delta[at + row_hi] = dl_hi;
  }
  const float l2_lo = live_lo ? p.lse[at + row_lo] * LOG2E : 0.f;
  const float l2_hi = live_hi ? p.lse[at + row_hi] * LOG2E : 0.f;

  float dq[C::MAIN / 2];
  zero(dq);
  float dqt[C::TAIL > 0 ? C::TAIL / 2 : 1];   // dQ's 16-column piece
  zero(dqt);
  mbar_wait(q_full, 0);

  // the loaded key tiles in the producer's order, each with its classes,
  // until the stage that ends the walk
  Ring<STAGES> ring;
  while (true) {
    mbar_wait(&full[ring.stage], ring.phase);
    const int info = sInfo[ring.stage];
    if (info < 0) break;
    const int t = info >> 4;
    const int cls = (info >> (2 * cw)) & 3;
    if (cls != SKIP) {
      const uint32_t k_src = smem_u32(sK) + ring.stage * S::KV;
      const uint32_t v_src = smem_u32(sV) + ring.stage * S::KV;

      // S = Q K^T and dP = dO V^T: 64 rows x 64 keys each; this
      // warpgroup's Q and dO rows as the K-major A operands, K and V as the
      // K-major B operands
      float s[32], dp[32];
      const uint64_t q_desc =
          make_desc(opaque(smem_u32(sQ) + 64 * cw * HALF_ROW), 16, 1024);
      const uint64_t do_desc =
          make_desc(opaque(smem_u32(sdO) + 64 * cw * HALF_ROW), 16, 1024);
      const uint64_t k_desc = make_desc(k_src, 16, 1024);
      const uint64_t v_desc = make_desc(v_src, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::MAIN / 16; ++kk) {
        const uint32_t off_q = (kk / 4) * DQ_BQ * HALF_ROW + (kk % 4) * 32;
        const uint32_t off_k = (kk / 4) * DQ_BK * HALF_ROW + (kk % 4) * 32;
        wgmma_ss<64, 0>(s, desc_add(q_desc, off_q), desc_add(k_desc, off_k),
                        kk > 0);
      }
      if constexpr (C::TAIL > 0)
        wgmma_ss<64, 0>(
            s,
            make_desc<32>(opaque(smem_u32(sQ) + C::HALVES * DQ_BQ * HALF_ROW +
                                 64 * cw * TAIL_ROW),
                          16, 256),
            make_desc<32>(k_src + C::HALVES * DQ_BK * HALF_ROW, 16, 256), 1);
#pragma unroll
      for (int kk = 0; kk < C::MAIN / 16; ++kk) {
        const uint32_t off_q = (kk / 4) * DQ_BQ * HALF_ROW + (kk % 4) * 32;
        const uint32_t off_k = (kk / 4) * DQ_BK * HALF_ROW + (kk % 4) * 32;
        wgmma_ss<64, 0>(dp, desc_add(do_desc, off_q),
                        desc_add(v_desc, off_k), kk > 0);
      }
      if constexpr (C::TAIL > 0)
        wgmma_ss<64, 0>(
            dp,
            make_desc<32>(opaque(smem_u32(sdO) + C::HALVES * DQ_BQ * HALF_ROW +
                                 64 * cw * TAIL_ROW),
                          16, 256),
            make_desc<32>(v_src + C::HALVES * DQ_BK * HALF_ROW, 16, 256), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P = exp2(S scale log2(e) - lse log2(e)) (masked per element on a
      // MASKED pair), dS = P (dP - delta), rounded to bf16 in the
      // A-fragment order
      uint32_t da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float pr[4] = {exp2f(fmaf(s[4 * j], sl2, -l2_lo)),
                       exp2f(fmaf(s[4 * j + 1], sl2, -l2_lo)),
                       exp2f(fmaf(s[4 * j + 2], sl2, -l2_hi)),
                       exp2f(fmaf(s[4 * j + 3], sl2, -l2_hi))};
        if (cls == MASKED)
          mask.apply(pr, rows, sIds + ring.stage * QB::IDS, row_lo, row_hi,
                     t * DQ_BK, 8 * j + 2 * t4);
        da[j / 2][2 * (j % 2)] = pack_bf16(pr[0] * (dp[4 * j] - dl_lo),
                                           pr[1] * (dp[4 * j + 1] - dl_lo));
        da[j / 2][2 * (j % 2) + 1] =
            pack_bf16(pr[2] * (dp[4 * j + 2] - dl_hi),
                      pr[3] * (dp[4 * j + 3] - dl_hi));
      }

      // dQ += dS K: K MN-major (k16 = 16 keys = 2048 bytes of a 64-column
      // piece, 512 of the 16-column one)
      const uint64_t k_mn = make_desc(k_src, DQ_BK * HALF_ROW, 1024);
      const uint64_t kt_mn =
          make_desc<32>(k_src + C::HALVES * DQ_BK * HALF_ROW, 256, 256);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_BK / 16; ++kk) {
        wgmma_rs<C::MAIN, 1>(dq, da[kk], desc_add(k_mn, kk * 16 * HALF_ROW),
                             1);
        if constexpr (C::TAIL > 0)
          wgmma_rs<16, 1>(dqt, da[kk], desc_add(kt_mn, kk * 16 * TAIL_ROW),
                          1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      if constexpr (C::TAIL > 0) fence_regs(dqt);
      fence_regs(da);
    }
    // every warp releases the stage: a warpgroup that skips the tile runs
    // no collective wgmma, and one warp's arrival could let the producer
    // rewrite the stage's entry before a slower warp of the warpgroup has
    // read it
    if (lane == 0) mbar_arrive(&empty[ring.stage]);
    ring.advance();
  }

  // epilogue: dq = scale dQ on live rows, zeros on dead ones; only columns
  // < D are stored
  __nv_bfloat16* qb = p.dq + b * p.dq_sb + h * p.dq_sh;
  const float mul = p.scale;
#pragma unroll
  for (int j = 0; j < C::MAIN / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (row_lo < sq)
      *reinterpret_cast<uint32_t*>(qb + row_lo * p.dq_sr + col) =
          live_lo ? pack_bf16(dq[4 * j] * mul, dq[4 * j + 1] * mul) : 0u;
    if (row_hi < sq)
      *reinterpret_cast<uint32_t*>(qb + row_hi * p.dq_sr + col) =
          live_hi ? pack_bf16(dq[4 * j + 2] * mul, dq[4 * j + 3] * mul) : 0u;
  }
  if constexpr (C::TAIL > 0) {
#pragma unroll
    for (int j = 0; j < (D - C::MAIN) / 8; ++j) {
      const int col = C::MAIN + 8 * j + 2 * t4;
      if (row_lo < sq)
        *reinterpret_cast<uint32_t*>(qb + row_lo * p.dq_sr + col) =
            live_lo ? pack_bf16(dqt[4 * j] * mul, dqt[4 * j + 1] * mul) : 0u;
      if (row_hi < sq)
        *reinterpret_cast<uint32_t*>(qb + row_hi * p.dq_sr + col) =
            live_hi ? pack_bf16(dqt[4 * j + 2] * mul, dqt[4 * j + 3] * mul)
                    : 0u;
    }
  }
}

// ---- host ---------------------------------------------------------------------

// Tensor maps of q, do (sq rows, `heads` heads, boxes of q_rows rows) and k,
// v (sk rows, kv_heads, boxes of k_rows rows) for the plan of D. → false if
// one was refused.
template <int D>
inline bool encode_bwd_maps(BwdMaps* m, int batch, int sq, int sk, int heads,
                            int kv_heads, const View& q, const View& k,
                            const View& v, const View& dO, int q_rows,
                            int k_rows) {
  using C = ColumnPlan<D>;
  auto enc = [&](CUtensorMap* map, const View& t, int s, int hh, int rows,
                 int cols, int swizzle) {
    return encode_bshd(map, t.ptr, batch, s, hh, D, t.sb, t.sr, t.sh, rows,
                       cols, swizzle);
  };
  if (!enc(&m->q, q, sq, heads, q_rows, 64, 128) ||
      !enc(&m->dO, dO, sq, heads, q_rows, 64, 128) ||
      !enc(&m->k, k, sk, kv_heads, k_rows, 64, 128) ||
      !enc(&m->v, v, sk, kv_heads, k_rows, 64, 128))
    return false;
  if constexpr (C::TAIL > 0) {
    if (!enc(&m->q_tail, q, sq, heads, q_rows, C::TAIL, 32) ||
        !enc(&m->do_tail, dO, sq, heads, q_rows, C::TAIL, 32) ||
        !enc(&m->k_tail, k, sk, kv_heads, k_rows, C::TAIL, 32) ||
        !enc(&m->v_tail, v, sk, kv_heads, k_rows, C::TAIL, 32))
      return false;
  } else {
    m->q_tail = m->q;
    m->do_tail = m->dO;
    m->k_tail = m->k;
    m->v_tail = m->v;
  }
  return true;
}

// The SMs of the current device, read once.
inline int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      count = 132;
    return count;
  }();
  return n;
}

// The grid order of a backward launch over `pairs` (head, batch row) pairs
// whose blocks each walk the whole of their pair's streamed operand. With
// at least a wave's worth of pairs, the tile-slowest order puts a wave of
// blocks on as many different pairs, each streaming its own Q and dO (dk/dv)
// or K and V (dq) once per tile: the ViT's 640 pairs of 1,152 rows stream
// several times the L2 from device memory. The tile-fastest order runs a
// pair's tiles side by side, so that they share that stream in L2. With
// fewer pairs (the RL update's 4 rows x 2 kv heads) a wave already holds
// each pair's tiles, and the tile-slowest order keeps causal grids'
// heaviest tiles first across pairs.
inline int tile_fastest(long long pairs) { return pairs >= sm_count(); }

// dk/dv at head dim D over (kv heads, batch, 64-key tiles).
template <int D, class Mask>
int launch_dkv(const BwdParams& p, const typename Mask::Params& mp, int batch,
               const View& q, const View& k, const View& v, const View& dO,
               cudaStream_t stream) {
  const int kvh = p.heads / p.kv_group;
  BwdMaps maps;
  if (!encode_bwd_maps<D>(&maps, batch, p.sq, p.sk, p.heads, kvh, q, k, v, dO,
                          DKV_BQ, DKV_BK))
    return TMA_ENCODE_FAILED;
  const int nk = (p.sk + DKV_BK - 1) / DKV_BK;
  BwdParams bp = p;
  bp.tile_fastest = tile_fastest(static_cast<long long>(kvh) * batch);
  return int(launch_ws(attention_dkv_wgmma_kernel<D, Mask>,
                       DkvTiles<D, DKV_BK>::BYTES,
                       bp.tile_fastest ? dim3(nk, kvh, batch)
                                       : dim3(kvh, batch, nk),
                       stream, maps, bp, mp));
}

// dk/dv with a warpgroup a key tile (d <= 72) over (kv heads, batch,
// 128-key tiles).
template <int D, class Mask>
int launch_dkv_pair(const BwdParams& p, const typename Mask::Params& mp,
                    int batch, const View& q, const View& k, const View& v,
                    const View& dO, cudaStream_t stream) {
  const int kvh = p.heads / p.kv_group;
  BwdMaps maps;
  if (!encode_bwd_maps<D>(&maps, batch, p.sq, p.sk, p.heads, kvh, q, k, v, dO,
                          DKV_BQ, 2 * DKV_BK))
    return TMA_ENCODE_FAILED;
  const int nk = (p.sk + 2 * DKV_BK - 1) / (2 * DKV_BK);
  BwdParams bp = p;
  bp.tile_fastest = tile_fastest(static_cast<long long>(kvh) * batch);
  return int(launch_ws(attention_dkv_pair_kernel<D, Mask>,
                       DkvTiles<D, 2 * DKV_BK>::BYTES,
                       bp.tile_fastest ? dim3(nk, kvh, batch)
                                       : dim3(kvh, batch, nk),
                       stream, maps, bp, mp));
}

// dq (and delta) at head dim D over (heads, batch, 128-row query tiles).
template <int D, class Mask>
int launch_dq(const BwdParams& p, const typename Mask::Params& mp, int batch,
              const View& q, const View& k, const View& v, const View& dO,
              cudaStream_t stream) {
  const int kvh = p.heads / p.kv_group;
  BwdMaps maps;
  if (!encode_bwd_maps<D>(&maps, batch, p.sq, p.sk, p.heads, kvh, q, k, v, dO,
                          DQ_BQ, DQ_BK))
    return TMA_ENCODE_FAILED;
  const int nq = (p.sq + DQ_BQ - 1) / DQ_BQ;
  BwdParams bp = p;
  bp.tile_fastest = tile_fastest(static_cast<long long>(p.heads) * batch);
  return int(launch_ws(attention_dq_wgmma_kernel<D, Mask>,
                       DqSmem<D, Mask::QueryBlock::IDS>::BYTES,
                       bp.tile_fastest ? dim3(nq, p.heads, batch)
                                       : dim3(p.heads, batch, nq),
                       stream, maps, bp, mp));
}

}  // namespace hopper
}  // namespace visrag

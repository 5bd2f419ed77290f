// Segment-id flash attention for Hopper (sm_90a), K4 at head dims 64 and
// 128: the forward with its log-sum-exp, and the dk/dv kernel, built on
// wgmma, TMA and a warp-specialised producer (hopper.cuh).
//
// Replaces the TPU kernels `_fwd_kernel` (visrag_tpu/ops/attention.py:219)
// and `_dkv_kernel` (:338). The segment contract, the formulas and the
// dq kernel that writes delta are those of attention_segment.cu, whose
// mma.sync kernels stay compiled at every head dim: they serve d = 80 (K3's
// backward, the vision tower) and the dq kernel at every d. Routing is by
// head dim alone (ops/attention.py `_route`), never by failure.
//
// What bounds it on the H100: the operations. The products on the visible
// pairs (2 forward, 4 for dk/dv) reach the 989 TFLOP/s bf16 peak only
// through wgmma, fed from shared memory that TMA fills without spending the
// consumers' instructions; the bytes (q, k, v, do read once) take 5-10x
// less time. What holds these kernels back from that bound is the serial
// chain inside each consumer warpgroup (products, then softmax, then
// products), which only the other warpgroup overlaps (PERF.md). The design:
//
//   * One block = two consumer warpgroups (0, 1) and a producer warpgroup
//     (2) of which one warp works (setmaxnreg: 224 / 56 registers). The
//     producer issues TMA tile loads into a ring of stages guarded by full /
//     empty mbarriers and stages the streamed side's ids (and, for dk/dv,
//     its lse and delta, three independent loads a row) beside them; the
//     consumers only compute, and each releases a stage with one arrival.
//   * Forward: the body shared with K1, hopper_attention_fwd.cuh, with the
//     segment mask below (SegmentMask): a 128-row Q tile (64 rows per
//     consumer warpgroup) against 128-key K/V tiles, 2 stages (3 at d = 64),
//     S = Q K^T an SS wgmma, the online softmax in base 2, P in registers as
//     the A operand of the RS wgmma for O += P V; the LSE in natural log;
//     rows that see no key give exact zeros and LSE_PAD. Causal query tiles
//     are launched heaviest first.
//   * dk/dv: a block owns 64 keys of one kv head and walks the group's
//     query heads and their 64-row query tiles, so every dk/dv element is
//     written by one block (no atomics, deterministic), 4 stages.
//     Registers decide its shape: ptxas keeps a consumer thread within 168
//     registers (the launch's 384 threads put three warps on each SM
//     sub-partition, and the allocator did not use the setmaxnreg grant,
//     see PERF.md), and dK + dV alone are 128 of them at d = 128; holding
//     both, the scores and the A fragments spilled and serialized every
//     wgmma. So the two consumer warpgroups split the accumulators: both
//     compute S^T = K Q^T and P^T = exp2(S^T scale log2(e) - lse log2(e));
//     warpgroup 0 adds dV += P^T dO (S^T an SS m64n64k16, P^T rounded to
//     bf16 as the A operand of an RS m64n{d}k16, dO MN-major), warpgroup 1
//     dK += dS^T Q with dS^T = P^T (dP^T - delta) (S^T and dP^T = V dO^T as
//     SS m64n32k16 on 32-query halves, Q MN-major): five products instead
//     of four, no spills, the wgmma pipeline intact.
//   * Tile classes. A pre-pass reduces each tile of ids to [min, max] of its
//     positive ids and whether it is uniform (one positive id, no pad row).
//     A (query tile, key tile) pair is skipped when the ranges cannot meet
//     or causal puts the key tile wholly after the query tile; it is
//     unmasked when both tiles are uniform with the same id and (causal)
//     the key tile ends at or before the query tile's first row; every other
//     pair masks per element by id equality (and key <= query). The plain
//     version is `segment_tile_classes_reference` / `segment_pair_classes_
//     reference` in ops/attention.py.
//
// Layout: (B, S, H, D) views with element strides (batch, row, head) and a
// contiguous head dim, read through one 4-D tensor map each (D, S, H, B),
// 64-column boxes with the 128-byte swizzle; rows past S are zero-filled by
// TMA and carry id 0. Base and strides must be 16-byte aligned (the wrapper
// raises otherwise); a tensor map the driver refuses is an error code.

#include <limits.h>

#include "hopper_attention_fwd.cuh"

namespace {

using namespace visrag;
using namespace visrag::hopper;

constexpr int DKV_BQ = 64, DKV_BK = 64;       // dk/dv tile rows

struct Params {
  __nv_bfloat16* o;          // forward output
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* lse;                // (B, H, Sq): forward writes, dk/dv reads
  const float* delta;        // (B, H, Sq): written by the dq kernel
  const int* q_seg;          // (B, Sq)
  const int* kv_seg;         // (B, Sk)
  const int4* q_cls;         // (B, nq): lo, hi, uniform
  const int4* k_cls;         // (B, nk)
  int sq, sk, heads, kv_group;
  long long o_sb, o_sr, o_sh;
  long long dk_sb, dk_sr, dk_sh;
  long long dv_sb, dv_sr, dv_sh;
  float scale;
};

// Per tile of `tile` rows: [min, max] of the positive ids ((INT_MAX, 0) for
// an all-pad tile, which meets nothing) and whether the tile is uniform.
// Rows past `seq` count as pad. One warp per tile.
__global__ void segment_tile_classes_kernel(const int* seg, int seq, int tile,
                                            int ntiles, int4* out) {
  const int t = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const int* row = seg + static_cast<long long>(b) * seq;
  int lo = INT_MAX, hi = 0;
  bool pad = false;
  for (int r = lane; r < tile; r += 32) {
    const int i = t * tile + r;
    const int id = i < seq ? row[i] : 0;
    if (id > 0) {
      lo = min(lo, id);
      hi = max(hi, id);
    } else {
      pad = true;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, d));
  }
  pad = __any_sync(0xffffffffu, pad);
  if (lane == 0)
    out[static_cast<long long>(b) * ntiles + t] =
        make_int4(lo, hi, !pad && lo == hi ? 1 : 0, 0);
}

// The class of the pair (query tile at row q0 of bq rows, key tile at k0 of
// bk rows); ops/attention.py segment_pair_classes_reference is the same.
__device__ __forceinline__ int pair_class(int4 qc, int q0, int bq, int4 kc,
                                          int k0, int bk, bool causal) {
  if (!(qc.x <= kc.y && kc.x <= qc.y)) return SKIP;
  if (causal && k0 > q0 + bq - 1) return SKIP;
  if (qc.z && kc.z && qc.x == kc.x && (!causal || k0 + bk - 1 <= q0))
    return UNMASKED;
  return MASKED;
}

// ---- forward: the shared body (hopper_attention_fwd.cuh) with the segment
// mask ---------------------------------------------------------------------

// Ids staged by the producer beside each K/V tile, the pre-pass's classes,
// id equality (and key <= query when causal).
template <bool C>
struct SegmentMask {
  static constexpr bool CAUSAL = C;
  static constexpr int IDS = FWD_BK;     // key ids staged per stage
  struct Params {
    const int* q_seg;        // (B, Sq)
    const int* kv_seg;       // (B, Sk)
    const int4* q_cls;       // (B, nq): lo, hi, uniform
    const int4* k_cls;       // (B, nk)
  };
  struct Rows {
    int lo, hi;              // the ids of the thread's two query rows
  };
  int4 qc;
  const int4* kcls;
  const int* qsegb;
  const int* ksegb;
  int qt, q0, nk, sq, sk;

  __device__ __forceinline__ SegmentMask(const Params& mp, int b, int qt_,
                                         int q0_, int nq, int nk_, int sq_,
                                         int sk_)
      : qc(mp.q_cls[static_cast<long long>(b) * nq + qt_]),
        kcls(mp.k_cls + static_cast<long long>(b) * nk_),
        qsegb(mp.q_seg + static_cast<long long>(b) * sq_),
        ksegb(mp.kv_seg + static_cast<long long>(b) * sk_),
        qt(qt_), q0(q0_), nk(nk_), sq(sq_), sk(sk_) {}

  // causal query tiles heaviest first
  static __device__ __forceinline__ int qtile(const Params&, int, int z,
                                              int nq, int) {
    return CAUSAL ? nq - 1 - z : z;
  }
  __device__ __forceinline__ bool q_live() const { return true; }
  __device__ __forceinline__ int ntiles() const {
    return CAUSAL ? min(nk, qt + 1) : nk;
  }
  __device__ __forceinline__ int pair(int t) const {
    return pair_class(qc, q0, FWD_BQ, kcls[t], t * FWD_BK, FWD_BK, CAUSAL);
  }
  __device__ __forceinline__ void stage(int* ids, int t, int lane) const {
    for (int r = lane; r < FWD_BK; r += 32) {
      const int j = t * FWD_BK + r;
      ids[r] = j < sk ? ksegb[j] : 0;
    }
  }
  __device__ __forceinline__ Rows rows(int row_lo, int row_hi) const {
    return {row_lo < sq ? qsegb[row_lo] : 0, row_hi < sq ? qsegb[row_hi] : 0};
  }
  // same positive id (keys past Sk carry id 0), key <= query
  __device__ __forceinline__ void apply(float (&s)[64], const Rows& r,
                                        const int* ids, int k0, int row_lo,
                                        int row_hi, int t4) const {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t4 + e;
        const int ks = ids[c];
        const bool ok_lo =
            r.lo > 0 && ks == r.lo && (!CAUSAL || k0 + c <= row_lo);
        const bool ok_hi =
            r.hi > 0 && ks == r.hi && (!CAUSAL || k0 + c <= row_hi);
        if (!ok_lo) s[4 * j + e] = -INFINITY;
        if (!ok_hi) s[4 * j + 2 + e] = -INFINITY;
      }
    }
  }
  __device__ __forceinline__ bool row_live(int) const { return true; }
};

// ---- dk/dv --------------------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr int STAGES = 4;
  static constexpr int KV = DKV_BK * D * 2;          // K or V tile
  static constexpr int QT = DKV_BQ * D * 2;          // a Q or dO tile
  static constexpr int ROWS = DKV_BQ * 12;           // lse, delta, ids
  static constexpr int BARS = (1 + 2 * STAGES) * 8;
  static constexpr size_t BYTES =
      1024 + 2 * KV + 2 * STAGES * QT + STAGES * ROWS + BARS;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(WS_THREADS, 1)
segment_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const Params p) {
  using S = DkvSmem<D>;
  constexpr int STAGES = S::STAGES;
  constexpr int HALVES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sK = smem;
  unsigned char* sV = sK + S::KV;
  unsigned char* sQ = sV + S::KV;                   // STAGES Q tiles
  unsigned char* sdO = sQ + STAGES * S::QT;         // STAGES dO tiles
  // per stage: lse * log2(e), delta, then the ids, DKV_BQ each
  float* sRows = reinterpret_cast<float*>(sdO + STAGES * S::QT);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sRows + STAGES * 3 * DKV_BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int hk = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int k0 = kt * DKV_BK;
  const int sq = p.sq, sk = p.sk;
  const int nq = (sq + DKV_BQ - 1) / DKV_BQ, nk = (sk + DKV_BK - 1) / DKV_BK;
  const int4 kc = p.k_cls[static_cast<long long>(b) * nk + kt];
  const int4* qcls = p.q_cls + static_cast<long long>(b) * nq;
  // the work: the group's query heads (outer) x the query tiles from the
  // first one that can see this key tile (inner), active pairs only
  const int i_begin = CAUSAL ? min(k0 / DKV_BQ, nq) : 0;
  auto cls_of = [&](int qt) {
    return pair_class(qcls[qt], qt * DKV_BQ, DKV_BQ, kc, k0, DKV_BK, CAUSAL);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= PRODUCER) {
    // ---- producer: one warp stages each query tile's lse * log2(e), delta
    // and ids; its lane 0 issues the TMA loads
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= PRODUCER + 32) return;
    const int lane = threadIdx.x - PRODUCER;
    if (lane == 0) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_do);
      mbar_arrive_expect_tx(kv_full, 2 * S::KV);
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) {
        tma_load_4d(sK + hf * DKV_BK * HALF_ROW, &tm_k, kv_full, 64 * hf, k0,
                    hk, b);
        tma_load_4d(sV + hf * DKV_BK * HALF_ROW, &tm_v, kv_full, 64 * hf, k0,
                    hk, b);
      }
    }
    const int* qsegb = p.q_seg + static_cast<long long>(b) * sq;
    Ring<STAGES> ring;
    for (int h = hk * p.kv_group; h < (hk + 1) * p.kv_group; ++h) {
      const long long at = (static_cast<long long>(b) * p.heads + h) * sq;
      for (int qt = i_begin; qt < nq; ++qt) {
        if (cls_of(qt) == SKIP) continue;
        mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
        float* rows = sRows + ring.stage * 3 * DKV_BQ;
#pragma unroll
        for (int r = lane; r < DKV_BQ; r += 32) {
          // three independent loads in flight at once
          const int row = qt * DKV_BQ + r;
          const bool in = row < sq;
          const int id = in ? qsegb[row] : 0;
          const float l = in ? p.lse[at + row] : 0.f;
          const float dl = in ? p.delta[at + row] : 0.f;
          rows[r] = id > 0 ? l * LOG2E : 0.f;
          rows[DKV_BQ + r] = id > 0 ? dl : 0.f;
          reinterpret_cast<int*>(rows)[2 * DKV_BQ + r] = id;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[ring.stage], 2 * S::QT);
#pragma unroll
          for (int hf = 0; hf < HALVES; ++hf) {
            tma_load_4d(sQ + ring.stage * S::QT + hf * DKV_BQ * HALF_ROW,
                        &tm_q, &full[ring.stage], 64 * hf, qt * DKV_BQ, h, b);
            tma_load_4d(sdO + ring.stage * S::QT + hf * DKV_BQ * HALF_ROW,
                        &tm_do, &full[ring.stage], 64 * hf, qt * DKV_BQ, h,
                        b);
          }
        }
        ring.advance();
      }
    }
    return;
  }

  // ---- consumers: both warpgroups walk the block's 64 keys; warpgroup 0
  // accumulates dV, warpgroup 1 dK
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int key_lo = k0 + 16 * warp + g, key_hi = key_lo + 8;
  const int* ksegb = p.kv_seg + static_cast<long long>(b) * sk;
  const int kid_lo = key_lo < sk ? ksegb[key_lo] : 0;
  const int kid_hi = key_hi < sk ? ksegb[key_hi] : 0;
  const float sl2 = p.scale * LOG2E;

  mbar_wait(kv_full, 0);

  // P^T of one pair of query columns c, c + 1 for this thread's two keys:
  // exp2(S^T scale log2(e) - lse log2(e)), masked per element on a MASKED
  // pair (same positive id, key <= query when causal)
  auto probs = [&](const float* rows, int cls, int q0, int c, float s0,
                   float s1, float s2, float s3, float (&pr)[4]) {
    const float2 l2 = *reinterpret_cast<const float2*>(rows + c);
    pr[0] = exp2f(fmaf(s0, sl2, -l2.x));
    pr[1] = exp2f(fmaf(s1, sl2, -l2.y));
    pr[2] = exp2f(fmaf(s2, sl2, -l2.x));
    pr[3] = exp2f(fmaf(s3, sl2, -l2.y));
    if (cls == MASKED) {
      const int2 qs = *reinterpret_cast<const int2*>(rows + 2 * DKV_BQ + c);
      const int r0 = q0 + c;
      if (!(qs.x > 0 && qs.x == kid_lo && (!CAUSAL || r0 >= key_lo)))
        pr[0] = 0.f;
      if (!(qs.y > 0 && qs.y == kid_lo && (!CAUSAL || r0 + 1 >= key_lo)))
        pr[1] = 0.f;
      if (!(qs.x > 0 && qs.x == kid_hi && (!CAUSAL || r0 >= key_hi)))
        pr[2] = 0.f;
      if (!(qs.y > 0 && qs.y == kid_hi && (!CAUSAL || r0 + 1 >= key_hi)))
        pr[3] = 0.f;
    }
  };
  // the K (or V) tile as the K-major A operand
  auto kv_desc = [&](unsigned char* tile) {
    return make_desc(opaque(smem_u32(tile)), 16, 1024);
  };
  // writes one accumulator's rows times `mul`; a pad key matched nothing,
  // so its rows are exact zeros
  auto store = [&](const float (&acc)[D / 2], __nv_bfloat16* out,
                   long long sr, float mul) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (key_lo < sk)
        *reinterpret_cast<uint32_t*>(out + key_lo * sr + col) =
            pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
      if (key_hi < sk)
        *reinterpret_cast<uint32_t*>(out + key_hi * sr + col) =
            pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
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
      for (int qt = i_begin; qt < nq; ++qt) {
        const int cls = cls_of(qt);
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
      for (int qt = i_begin; qt < nq; ++qt) {
        const int cls = cls_of(qt);
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

// ---- host ---------------------------------------------------------------------

enum Which { FWD = 0, DKV = 2 };

template <int D, bool CAUSAL>
int dispatch(int which, const Params& p, int batch, const View& q,
             const View& k, const View& v, const View& dO,
             cudaStream_t stream) {
  const int kvh = p.heads / p.kv_group;
  if (which == FWD) {
    FwdMaps maps;
    if (!encode_fwd_maps<D>(&maps, batch, p.sq, p.sk, p.heads, kvh, q, k, v))
      return TMA_ENCODE_FAILED;
    FwdParams fp;
    fp.o = p.o;
    fp.lse = p.lse;
    fp.o_sb = p.o_sb, fp.o_sr = p.o_sr, fp.o_sh = p.o_sh;
    fp.sq = p.sq, fp.sk = p.sk, fp.heads = p.heads, fp.kv_group = p.kv_group;
    fp.sl2 = p.scale * LOG2E;
    const typename SegmentMask<CAUSAL>::Params mp{p.q_seg, p.kv_seg, p.q_cls,
                                                  p.k_cls};
    return p.lse ? launch_fwd<D, true, SegmentMask<CAUSAL>>(maps, fp, mp,
                                                            batch, stream)
                 : launch_fwd<D, false, SegmentMask<CAUSAL>>(maps, fp, mp,
                                                             batch, stream);
  }
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_bshd(&tq, q.ptr, batch, p.sq, p.heads, D, q.sb, q.sr, q.sh,
                   DKV_BQ) ||
      !encode_bshd(&tk, k.ptr, batch, p.sk, kvh, D, k.sb, k.sr, k.sh,
                   DKV_BK) ||
      !encode_bshd(&tv, v.ptr, batch, p.sk, kvh, D, v.sb, v.sr, v.sh,
                   DKV_BK) ||
      !encode_bshd(&tdo, dO.ptr, batch, p.sq, p.heads, D, dO.sb, dO.sr, dO.sh,
                   DKV_BQ))
    return TMA_ENCODE_FAILED;
  const int nk = (p.sk + DKV_BK - 1) / DKV_BK;
  return int(launch_ws(segment_dkv_wgmma_kernel<D, CAUSAL>, DkvSmem<D>::BYTES,
                       dim3(kvh, batch, nk), stream, tq, tk, tv, tdo, p));
}

void tile_classes(const int* seg, int batch, int seq, int tile, int4* out,
                  cudaStream_t stream) {
  const int n = (seq + tile - 1) / tile;
  segment_tile_classes_kernel<<<dim3(n, batch), 32, 0, stream>>>(seg, seq,
                                                                 tile, n, out);
}

// ptrs, dims and strides as attention_segment.cu's entry points (q, k, v,
// o, do, dq, dk, dv, lse, delta, q_seg, kv_seg, classes); classes: scratch
// of 4 * batch * (ceil(sq / BQ) + ceil(sk / BK)) ints at the kernel's tile
// rows (forward 128 / 128, dk/dv 64 / 64), filled here.
int run(int which, void* const* ptrs, const int* dims, const long long* st,
        float scale, void* stream) {
  const int batch = dims[0], sq = dims[1], sk = dims[2], heads = dims[3],
            kv_heads = dims[4], head_dim = dims[5], causal = dims[6];
  if (kv_heads <= 0 || heads % kv_heads) return int(cudaErrorInvalidValue);
  if (batch <= 0 || sq <= 0 || sk <= 0) return int(cudaSuccess);
  Params p;
  p.o = static_cast<__nv_bfloat16*>(ptrs[3]);
  p.dk = static_cast<__nv_bfloat16*>(ptrs[6]);
  p.dv = static_cast<__nv_bfloat16*>(ptrs[7]);
  p.lse = static_cast<float*>(ptrs[8]);
  p.delta = static_cast<const float*>(ptrs[9]);
  p.q_seg = static_cast<const int*>(ptrs[10]);
  p.kv_seg = static_cast<const int*>(ptrs[11]);
  const int bq = which == FWD ? FWD_BQ : DKV_BQ;
  const int bk = which == FWD ? FWD_BK : DKV_BK;
  const int nq = (sq + bq - 1) / bq;
  int4* q_cls = static_cast<int4*>(ptrs[12]);
  int4* k_cls = q_cls + static_cast<long long>(batch) * nq;
  p.q_cls = q_cls;
  p.k_cls = k_cls;
  p.sq = sq;
  p.sk = sk;
  p.heads = heads;
  p.kv_group = heads / kv_heads;
  p.o_sb = st[9], p.o_sr = st[10], p.o_sh = st[11];
  p.dk_sb = st[18], p.dk_sr = st[19], p.dk_sh = st[20];
  p.dv_sb = st[21], p.dv_sr = st[22], p.dv_sh = st[23];
  p.scale = scale;
  const View q{ptrs[0], st[0], st[1], st[2]}, k{ptrs[1], st[3], st[4], st[5]},
      v{ptrs[2], st[6], st[7], st[8]}, dO{ptrs[4], st[12], st[13], st[14]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_classes(p.q_seg, batch, sq, bq, q_cls, s);
  tile_classes(p.kv_seg, batch, sk, bk, k_cls, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  switch (head_dim) {
    case 64:
      return causal ? dispatch<64, true>(which, p, batch, q, k, v, dO, s)
                    : dispatch<64, false>(which, p, batch, q, k, v, dO, s);
    case 128:
      return causal ? dispatch<128, true>(which, p, batch, q, k, v, dO, s)
                    : dispatch<128, false>(which, p, batch, q, k, v, dO, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points for ctypes; see `run` for the arguments. Each returns
// a cudaError_t (0 = launched) or -1 when the driver refused a tensor map.
extern "C" int visrag_segment_hopper_fwd(void* const* ptrs, const int* dims,
                                         const long long* strides, float scale,
                                         void* stream) {
  return run(FWD, ptrs, dims, strides, scale, stream);
}

extern "C" int visrag_segment_hopper_dkv(void* const* ptrs, const int* dims,
                                         const long long* strides, float scale,
                                         void* stream) {
  return run(DKV, ptrs, dims, strides, scale, stream);
}

// The pre-pass alone: classes of `tile`-row tiles of seg (batch, seq) into
// out (batch, ceil(seq / tile)) int4 {lo, hi, uniform, 0}.
extern "C" int visrag_segment_tile_classes(const int* seg, int batch, int seq,
                                           int tile, void* out, void* stream) {
  if (batch <= 0 || seq <= 0 || tile <= 0) return int(cudaErrorInvalidValue);
  tile_classes(seg, batch, seq, tile, static_cast<int4*>(out),
               static_cast<cudaStream_t>(stream));
  return int(cudaGetLastError());
}

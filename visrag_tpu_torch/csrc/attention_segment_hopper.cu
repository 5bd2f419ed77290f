// Segment-id flash attention for Hopper (sm_90a), K4 at head dims 64, 80
// and 128: the forward with its log-sum-exp, the dq kernel (which also
// writes delta) and the dk/dv kernel, built on wgmma, TMA and a
// warp-specialised producer (hopper.cuh); all three bodies are shared with
// the valid-length kernels (hopper_attention_fwd.cuh,
// hopper_attention_bwd.cuh).
//
// Replaces the TPU kernels `_fwd_kernel` (visrag_tpu/ops/attention.py:219),
// `_dq_kernel` (:302) and `_dkv_kernel` (:338). The segment contract and
// the formulas are those of attention_segment.cu, whose mma.sync kernels
// stay compiled, reached only with `legacy=True` (ops/attention.py `_route`)
// to time one against the other. d 80 is the Qwen2.5-VL vision tower's: the
// backward of K3 (attention_kvgrid_hopper.cu) and its `attn_impl="packed"`
// forward.
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
//   * dk/dv: the body shared with K2, hopper_attention_bwd.cuh, with the
//     segment mask's key-major view (SegmentMask::KeyBlock): at d 64 / 128
//     a block owns 64 keys of one kv head and walks the group's query heads
//     and their 64-row query tiles (no atomics, deterministic), 4 stages;
//     warpgroup 0 accumulates dV, warpgroup 1 dK, so that each fits the 168
//     registers ptxas gives a consumer thread (five products instead of
//     four, see that header and PERF.md). At d 80 (64 + 16 columns, d 72's
//     column plan) the split body cannot take the 16-column piece, and dK
//     and dV fit one warpgroup: K2's d 72 body, a warpgroup a 64-key tile,
//     128 keys a block, on the same KeyBlock.
//   * dq: the dq body of hopper_attention_bwd.cuh with the segment mask's
//     query-major view (SegmentMask::QueryBlock): a block owns a 128-row
//     query tile of one query head (64 rows a consumer warpgroup, Q and dO
//     resident) and walks its kv head's 64-key tiles through a 4-stage
//     ring, the producer warp staging each key tile's ids beside it; each
//     warpgroup classes its own 64 rows against each key tile, and a tile
//     both skip is not loaded. Delta = rowsum(o do) in fp32, 0 on pad rows,
//     is computed in the prologue and stored (B, H, Sq) for the dk/dv
//     launch. Causal query tiles are launched heaviest first; a tile of pad
//     rows only writes zeros and exits.
//   * Tile classes. A pre-pass reduces each tile of ids to [min, max] of its
//     positive ids and whether it is uniform (one positive id, no pad row).
//     A (query tile, key tile) pair is skipped when the ranges cannot meet
//     or causal puts the key tile wholly after the query tile; it is
//     unmasked when both tiles are uniform with the same id and (causal)
//     the key tile ends at or before the query tile's first row; every other
//     pair masks per element by id equality (and key <= query). The plain
//     version is `segment_tile_classes_reference` / `segment_pair_classes_
//     reference` in ops/attention.py.
//   * Sorted ids (the `sorted` flag, dims[7]; K3's backward, whose ids are
//     ascending runs with pad after them): the pre-pass's [lo, hi] are then
//     non-decreasing over the real tiles, so the tiles a block can meet form
//     one run, and the dq producer and every dk/dv warp find its ends by a
//     warp's 32-way search over the classes (`locate`: 2 rounds over 276
//     tiles) instead of walking all S / 64 tiles. Without the flag every
//     tile is walked, as before.
//
// Layout: (B, S, H, D) views with element strides (batch, row, head) and a
// contiguous head dim, read through one 4-D tensor map each (D, S, H, B),
// 64-column boxes with the 128-byte swizzle; rows past S are zero-filled by
// TMA and carry id 0. Base and strides must be 16-byte aligned (the wrapper
// raises otherwise); a tensor map the driver refuses is an error code.

#include <limits.h>

#include "hopper_attention_bwd.cuh"

namespace {

using namespace visrag;
using namespace visrag::hopper;

struct Params {
  __nv_bfloat16* o;          // forward output
  const __nv_bfloat16* dO;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* lse;                // (B, H, Sq): forward writes, dq and dk/dv read
  float* delta;              // (B, H, Sq): dq writes, dk/dv reads
  const int* q_seg;          // (B, Sq)
  const int* kv_seg;         // (B, Sk)
  const int4* q_cls;         // (B, nq): lo, hi, uniform
  const int4* k_cls;         // (B, nk)
  int sq, sk, heads, kv_group;
  int sorted;                // dq / dk/dv: walk only the band of sorted ids
  long long o_sb, o_sr, o_sh;
  long long do_sb, do_sr, do_sh;
  long long dq_sb, dq_sr, dq_sh;
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
    int sorted;              // the ids are ascending runs, pad after them
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

  // dk/dv (hopper_attention_bwd.cuh): the block's 64 keys against the
  // 64-row query tiles, classes from the pre-pass at 64 / 64, the query ids
  // staged by the producer beside lse and delta
  struct KeyBlock {
    struct Keys {
      int lo, hi;            // the ids of the thread's two keys
    };
    int4 kc;
    const int4* qcls;
    const int* qsegb;
    const int* ksegb;
    int k0, nq, sq, sk, sorted;
    int qb, qe;              // the query tiles to walk (locate)

    __device__ __forceinline__ KeyBlock(const Params& mp, int b, int kt,
                                        int k0_, int nq_, int nk, int sq_,
                                        int sk_)
        : kc(mp.k_cls[static_cast<long long>(b) * nk + kt]),
          qcls(mp.q_cls + static_cast<long long>(b) * nq_),
          qsegb(mp.q_seg + static_cast<long long>(b) * sq_),
          ksegb(mp.kv_seg + static_cast<long long>(b) * sk_),
          k0(k0_), nq(nq_), sq(sq_), sk(sk_), sorted(mp.sorted), qb(0),
          qe(nq_) {}

    __device__ __forceinline__ bool k_live() const { return true; }
    // Sorted ids: the query tiles whose ids can meet this key tile's are
    // one run of tiles, found by the warp's search over the pre-pass's
    // classes (real tiles first, their [lo, hi] non-decreasing; pad tiles
    // (INT_MAX, 0) after them): from the first whose hi reaches the key
    // tile's lo to the last whose lo is within its hi. A pad key tile walks
    // nothing. Other ids walk every query tile.
    __device__ __forceinline__ void locate(int lane) {
      if (!sorted) return;
      const int lo = kc.x, hi = kc.y;
      const int2 r = warp_partitions(
          make_int2(0, nq),
          [&](int t) {
            const int h = qcls[t].y;
            return h > 0 && h < lo;
          },
          make_int2(0, nq), [&](int t) { return qcls[t].x <= hi; }, lane);
      qb = r.x;
      qe = r.y;
    }
    // from the first query tile that can see this key tile
    __device__ __forceinline__ int q_begin() const {
      return CAUSAL ? max(qb, min(k0 / DKV_BQ, nq)) : qb;
    }
    __device__ __forceinline__ int q_end() const { return qe; }
    __device__ __forceinline__ int pair(int qt) const {
      return pair_class(qcls[qt], qt * DKV_BQ, DKV_BQ, kc, k0, DKV_BK,
                        CAUSAL);
    }
    // lse * log2(e), delta and the id of each row of query tile qt; a pad
    // row (id <= 0) matches nothing and stages zeros
    __device__ __forceinline__ void stage(float* rows, const float* lse,
                                          const float* delta, int qt,
                                          int lane) const {
#pragma unroll
      for (int r = lane; r < DKV_BQ; r += 32) {
        // three independent loads in flight at once
        const int row = qt * DKV_BQ + r;
        const bool in = row < sq;
        const int id = in ? qsegb[row] : 0;
        const float l = in ? lse[row] : 0.f;
        const float dl = in ? delta[row] : 0.f;
        rows[r] = id > 0 ? l * LOG2E : 0.f;
        rows[DKV_BQ + r] = id > 0 ? dl : 0.f;
        reinterpret_cast<int*>(rows)[2 * DKV_BQ + r] = id;
      }
    }
    __device__ __forceinline__ Keys keys(int key_lo, int key_hi) const {
      return {key_lo < sk ? ksegb[key_lo] : 0, key_hi < sk ? ksegb[key_hi] : 0};
    }
    // same positive id, key <= query when causal; pr: (query r0, key_lo),
    // (r0 + 1, key_lo), (r0, key_hi), (r0 + 1, key_hi)
    __device__ __forceinline__ void apply(float (&pr)[4], const Keys& k,
                                          const float* rows, int c, int r0,
                                          int key_lo, int key_hi) const {
      const int2 qs = *reinterpret_cast<const int2*>(rows + 2 * DKV_BQ + c);
      if (!(qs.x > 0 && qs.x == k.lo && (!CAUSAL || r0 >= key_lo)))
        pr[0] = 0.f;
      if (!(qs.y > 0 && qs.y == k.lo && (!CAUSAL || r0 + 1 >= key_lo)))
        pr[1] = 0.f;
      if (!(qs.x > 0 && qs.x == k.hi && (!CAUSAL || r0 >= key_hi)))
        pr[2] = 0.f;
      if (!(qs.y > 0 && qs.y == k.hi && (!CAUSAL || r0 + 1 >= key_hi)))
        pr[3] = 0.f;
    }
    // a pad key matched nothing, so its rows are exact zeros already
    __device__ __forceinline__ bool key_live(int) const { return true; }
  };

  // dq (hopper_attention_bwd.cuh): the block's 128 query rows from q0, 64
  // per consumer warpgroup, against 64-key tiles; the classes are the
  // pre-pass's at 64 / 64 (those of dk/dv), taken for each 64-row half
  // apart, and the producer stages a masked key tile's ids beside it
  struct QueryBlock {
    static constexpr int IDS = DQ_BK;    // key ids staged per stage
    struct Rows {
      int lo, hi;            // the ids of the thread's two query rows
    };
    int4 qc0, qc1;           // the classes of rows [q0, q0 + 64), [+64, +128)
    const int4* kcls;
    const int* qsegb;
    const int* ksegb;
    int q0, nk, sq, sk, sorted;
    int tb, te;              // the key tiles to walk (locate)

    __device__ __forceinline__ QueryBlock(const Params& mp, int b, int qt,
                                          int q0_, int, int nk_, int sq_,
                                          int sk_)
        : kcls(mp.k_cls + static_cast<long long>(b) * nk_),
          qsegb(mp.q_seg + static_cast<long long>(b) * sq_),
          ksegb(mp.kv_seg + static_cast<long long>(b) * sk_),
          q0(q0_), nk(nk_), sq(sq_), sk(sk_), sorted(mp.sorted), tb(0),
          te(nk_) {
      static_assert(DQ_BQ == 2 * DKV_BQ && DQ_BK == DKV_BK,
                    "dq classes a 128-row tile as two 64-row tiles");
      const int nq64 = (sq_ + DKV_BQ - 1) / DKV_BQ;
      const int4* qcls = mp.q_cls + static_cast<long long>(b) * nq64;
      qc0 = qcls[2 * qt];
      // past Sq: a tile of pad rows, which meets nothing
      qc1 = 2 * qt + 1 < nq64 ? qcls[2 * qt + 1] : make_int4(INT_MAX, 0, 0, 0);
    }

    // causal query tiles heaviest first
    static __device__ __forceinline__ int qtile(const Params&, int, int z,
                                                int nq, int) {
      return CAUSAL ? nq - 1 - z : z;
    }
    // some row holds a positive id
    __device__ __forceinline__ bool q_live() const {
      return qc0.y > 0 || qc1.y > 0;
    }
    // Sorted ids: the key tiles whose ids can meet the block's rows are one
    // run, found by the producer warp's search over the pre-pass's classes
    // (as KeyBlock::locate); other ids walk every key tile.
    __device__ __forceinline__ void locate(int lane) {
      if (!sorted) return;
      const int lo = min(qc0.x, qc1.x), hi = max(qc0.y, qc1.y);
      const int2 r = warp_partitions(
          make_int2(0, nk),
          [&](int t) {
            const int h = kcls[t].y;
            return h > 0 && h < lo;
          },
          make_int2(0, nk), [&](int t) { return kcls[t].x <= hi; }, lane);
      tb = r.x;
      te = r.y;
    }
    __device__ __forceinline__ int first() const { return tb; }
    // causal: the key tiles up to the tile's last row
    __device__ __forceinline__ int ntiles() const {
      return min(te, CAUSAL ? (min(q0 + DQ_BQ, sq) + DQ_BK - 1) / DQ_BK : nk);
    }
    __device__ __forceinline__ int pair(int t, int cw) const {
      return pair_class(cw ? qc1 : qc0, q0 + DKV_BQ * cw, DKV_BQ, kcls[t],
                        t * DQ_BK, DQ_BK, CAUSAL);
    }
    // the ids of key tile t's rows; keys past Sk stage id 0
    __device__ __forceinline__ void stage(int* ids, int t, int lane) const {
#pragma unroll
      for (int r = lane; r < DQ_BK; r += 32) {
        const int j = t * DQ_BK + r;
        ids[r] = j < sk ? ksegb[j] : 0;
      }
    }
    __device__ __forceinline__ Rows rows(int row_lo, int row_hi) const {
      return {row_lo < sq ? qsegb[row_lo] : 0,
              row_hi < sq ? qsegb[row_hi] : 0};
    }
    // same positive id, key <= query when causal; pr: (row_lo, key),
    // (row_lo, key + 1), (row_hi, key), (row_hi, key + 1), key = key0 + c
    __device__ __forceinline__ void apply(float (&pr)[4], const Rows& r,
                                          const int* ids, int row_lo,
                                          int row_hi, int key0, int c) const {
      const int2 ks = *reinterpret_cast<const int2*>(ids + c);
      const int key = key0 + c;
      if (!(r.lo > 0 && ks.x == r.lo && (!CAUSAL || key <= row_lo)))
        pr[0] = 0.f;
      if (!(r.lo > 0 && ks.y == r.lo && (!CAUSAL || key + 1 <= row_lo)))
        pr[1] = 0.f;
      if (!(r.hi > 0 && ks.x == r.hi && (!CAUSAL || key <= row_hi)))
        pr[2] = 0.f;
      if (!(r.hi > 0 && ks.y == r.hi && (!CAUSAL || key + 1 <= row_hi)))
        pr[3] = 0.f;
    }
    // a pad row (id <= 0) gets dq 0 and delta 0 whatever do holds; a
    // positive-id row that sees no key has P = 0 on every pair, so dq 0
    __device__ __forceinline__ bool row_live(int row) const {
      return row < sq && qsegb[row] > 0;
    }
  };
};

// ---- host ---------------------------------------------------------------------

enum Which { FWD = 0, DQ = 1, DKV = 2 };

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
                                                  p.k_cls, 0};
    return p.lse ? launch_fwd<D, true, SegmentMask<CAUSAL>>(maps, fp, mp,
                                                            batch, stream)
                 : launch_fwd<D, false, SegmentMask<CAUSAL>>(maps, fp, mp,
                                                             batch, stream);
  }
  BwdParams bp{};
  bp.o = p.o;
  bp.dO = p.dO;
  bp.dq = p.dq;
  bp.dk = p.dk;
  bp.dv = p.dv;
  bp.lse = p.lse;
  bp.delta = p.delta;
  bp.o_sb = p.o_sb, bp.o_sr = p.o_sr, bp.o_sh = p.o_sh;
  bp.do_sb = p.do_sb, bp.do_sr = p.do_sr, bp.do_sh = p.do_sh;
  bp.dq_sb = p.dq_sb, bp.dq_sr = p.dq_sr, bp.dq_sh = p.dq_sh;
  bp.dk_sb = p.dk_sb, bp.dk_sr = p.dk_sr, bp.dk_sh = p.dk_sh;
  bp.dv_sb = p.dv_sb, bp.dv_sr = p.dv_sr, bp.dv_sh = p.dv_sh;
  bp.sq = p.sq, bp.sk = p.sk, bp.heads = p.heads, bp.kv_group = p.kv_group;
  bp.scale = p.scale;
  const typename SegmentMask<CAUSAL>::Params mp{p.q_seg, p.kv_seg, p.q_cls,
                                                p.k_cls, p.sorted};
  if (which == DQ)
    return launch_dq<D, SegmentMask<CAUSAL>>(bp, mp, batch, q, k, v, dO,
                                             stream);
  // d 80 (64 + 16 columns): a warpgroup a 64-key tile, dK and dV in one
  // warpgroup; d 64 / 128: the split body
  if constexpr (ColumnPlan<D>::TAIL > 0)
    return launch_dkv_pair<D, SegmentMask<CAUSAL>>(bp, mp, batch, q, k, v,
                                                   dO, stream);
  else
    return launch_dkv<D, SegmentMask<CAUSAL>>(bp, mp, batch, q, k, v, dO,
                                              stream);
}

void tile_classes(const int* seg, int batch, int seq, int tile, int4* out,
                  cudaStream_t stream) {
  const int n = (seq + tile - 1) / tile;
  segment_tile_classes_kernel<<<dim3(n, batch), 32, 0, stream>>>(seg, seq,
                                                                 tile, n, out);
}

// ptrs, dims and strides as attention_segment.cu's entry points (q, k, v,
// o, do, dq, dk, dv, lse, delta, q_seg, kv_seg, classes), and dims[7] the
// sorted flag (dq and dk/dv walk only the band of sorted ids). classes:
// scratch of 4 * batch * (ceil(sq / BQ) + ceil(sk / BK)) ints at the
// kernel's tile rows (forward 128 / 128, dq and dk/dv 64 / 64), filled
// here.
int run(int which, void* const* ptrs, const int* dims, const long long* st,
        float scale, void* stream) {
  const int batch = dims[0], sq = dims[1], sk = dims[2], heads = dims[3],
            kv_heads = dims[4], head_dim = dims[5], causal = dims[6],
            sorted = dims[7];
  if (kv_heads <= 0 || heads % kv_heads) return int(cudaErrorInvalidValue);
  if (batch <= 0 || sq <= 0 || sk <= 0) return int(cudaSuccess);
  Params p;
  p.o = static_cast<__nv_bfloat16*>(ptrs[3]);
  p.dO = static_cast<const __nv_bfloat16*>(ptrs[4]);
  p.dq = static_cast<__nv_bfloat16*>(ptrs[5]);
  p.dk = static_cast<__nv_bfloat16*>(ptrs[6]);
  p.dv = static_cast<__nv_bfloat16*>(ptrs[7]);
  p.lse = static_cast<float*>(ptrs[8]);
  p.delta = static_cast<float*>(ptrs[9]);
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
  p.sorted = sorted;
  p.o_sb = st[9], p.o_sr = st[10], p.o_sh = st[11];
  p.do_sb = st[12], p.do_sr = st[13], p.do_sh = st[14];
  p.dq_sb = st[15], p.dq_sr = st[16], p.dq_sh = st[17];
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
    case 80:
      return causal ? dispatch<80, true>(which, p, batch, q, k, v, dO, s)
                    : dispatch<80, false>(which, p, batch, q, k, v, dO, s);
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

// dq and delta: run before visrag_segment_hopper_dkv on the same stream,
// which reads the delta written here.
extern "C" int visrag_segment_hopper_dq(void* const* ptrs, const int* dims,
                                        const long long* strides, float scale,
                                        void* stream) {
  return run(DQ, ptrs, dims, strides, scale, stream);
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

// Banded segment attention forward for Hopper (sm_90a), K3: the Qwen2.5-VL
// vision tower's window and full-attention layers, as a persistent kernel on
// the forward body of hopper_attention_fwd.cuh (its per-tile step and
// epilogue: wgmma, TMA, one producer warp and two consumer warpgroups) with
// a band walk.
//
// Replaces the TPU kernel `_fwd_kernel_banded` in
// visrag_tpu/ops/attention_kvgrid.py (and its band bounds `_band_bounds`).
// For each batch row b, head h and query row i:
//
//   o[i] = softmax_j(scale * q[i].k[j] : seg[j] == seg[i] > 0) . v
//
// Segment ids are contiguous ascending runs over the real tokens (1, 1, ...,
// 2, 2, ...) with padding (<= 0) only after them: windows of <= 64 patches
// in the 28 window layers, one segment per image in the 4 full-attention
// layers. Rows with seg <= 0, and rows with no key, are written as exact
// zeros; with the LSE template flag (a gradient is wanted: the backward is
// K4's dq and dk/dv, attention_segment_hopper.cu, which read it) the
// natural-log log-sum-exp is written too, LSE_PAD on those rows.
//
// What bounds it on the H100: the window layers are bytes-bound (q, k, v
// read once and o written once take about 3x the products' time at the
// tower's 17.7k patches; each key tile is read again by the 2-3 query tiles
// whose band holds it, from L2), the full layers operations-bound (a
// 5,000-patch image is 5,000^2 visible pairs). The design:
//
//   * The body's 128-row query tiles (64 rows a consumer warpgroup) and
//     128-key K/V tiles, S = Q K^T and O += P V on wgmma, the online softmax
//     in registers; d 80 is its column plan's 64-column piece (128-byte
//     swizzle) and 16-column piece (32-byte swizzle), with no zero-filled
//     columns.
//   * Persistent: a block an SM walks the work items (a query tile of a
//     head, heads fastest, so that the blocks at work at once share their
//     bands' key tiles in L2). The producer warp runs ahead across items
//     through two Q buffers and a 4-stage K/V ring, and hands each stage's
//     key tile and class to the consumers beside it (a stage with no tile
//     ends an item), so the next item's loads overlap this one's last
//     products and its stores. A window layer's item is 2-3 key tiles: one
//     block a tile, as the body launches it, spent most of its time filling
//     and draining its pipeline (PERF.md). The stores go 16 bytes a
//     thread (fwd_store's WIDE form): the 4-byte stores of one item held up
//     the next.
//   * The band, in the kernel, per query tile (BandMask::locate), found by
//     the producer warp. The ids are sorted, so the keys a tile can see are
//     one range [start, end): from the first key of the tile's first id to
//     the last key of its last id. One round of loads reads the tile's 128
//     ids and the 64 keys on either side of it, which settles both ends for
//     every window layer (windows of <= 64 patches); where a segment runs
//     past them (the full layers) a 32-way search over the ids finishes the
//     end (3 rounds over 17,668 keys). No pre-pass launch is needed. The
//     walk covers the band's 128-key tiles only.
//   * Tile classes in closed form from the bands of each consumer
//     warpgroup's 64 rows. Rows that hold one id see exactly the keys of
//     that id, so a key tile inside their band is UNMASKED: nearly every
//     pair of the full layers, which then skip the per-element mask. Every
//     other pair is MASKED by id equality against the key tile's ids, which
//     the producer warp stages beside it. A warpgroup skips a key tile
//     outside its rows' band, and takes only the 64-key half of a tile that
//     its band meets when the other half lies outside it (a window's band
//     often starts or ends mid-tile): S and P V of 64 keys instead of 128.
//     A query tile with no real row (sorted ids: its first row is pad)
//     loads nothing, and its rows are stored as zeros (and LSE_PAD).
//
// The plain versions: ops/attention_kvgrid.py `band_bounds` (the band in
// keys), `band_tile_range_reference` (in key tiles, as the JAX
// `_band_bounds`), `band_pair_classes_reference` (the classes) and
// `flash_attention_kvgrid_reference` (the function).
//
// Layout: q / k / v / o are base pointers plus element strides (batch, row,
// head) with a contiguous head dim, so the vision block's fused qkv GEMM
// output is read in place (row stride 3 H D); k / v may carry H / kv_group
// heads. TMA reads every operand, so bases and strides must be 16-byte
// aligned (the wrapper raises otherwise); a tensor map that the driver
// refuses is an error code, never another path.

#include "hopper_attention_bwd.cuh"   // the forward body, and sm_count()

namespace {

using namespace visrag;
using namespace visrag::hopper;

constexpr int PROBE = 64;    // keys read on either side of the query tile
enum Half { WHOLE = 0, LOWER = 1, UPPER = 2 };   // the keys of a tile taken

// The band of a query tile on sorted ids, and the per-element mask.
struct BandMask {
  struct Params {
    const int* seg;          // (B, S): query and key ids alike
  };
  struct Rows {
    int lo, hi;              // the ids of the thread's two query rows
  };
  const int* segb;
  int q0, seq;
  int qid;                   // the tile's first id (<= 0: no real row)
  // (locate) the band of the tile, in keys, and of each consumer
  // warpgroup's 64 rows: [start, end0) and [start1, end); whether each
  // half holds one id in every row, and whether the second has a real row
  int start, end, end0, start1;
  bool uniform0, uniform1, live1;

  __device__ __forceinline__ BandMask(const Params& mp, int b, int, int q0_,
                                      int, int, int sq, int)
      : segb(mp.seg + static_cast<long long>(b) * sq), q0(q0_), seq(sq),
        qid(segb[q0_]), start(0), end(0), end0(0), start1(0),
        uniform0(false), uniform1(false), live1(false) {}

  // sorted ids: a tile whose first row is pad has no real row
  __device__ __forceinline__ bool q_live() const { return qid > 0; }

  // The band [start, end) of this live tile, by the calling warp.
  __device__ __forceinline__ void locate(int lane) {
    // one round: the tile's ids and the PROBE keys on either side of it
    int ids[FWD_BQ / 32], back[PROBE / 32], ahead[PROBE / 32];
#pragma unroll
    for (int j = 0; j < FWD_BQ / 32; ++j) {
      const int r = q0 + lane + 32 * j;
      ids[j] = r < seq ? segb[r] : 0;
    }
#pragma unroll
    for (int j = 0; j < PROBE / 32; ++j) {
      const int r = q0 - PROBE + lane + 32 * j;
      back[j] = r >= 0 ? segb[r] : 0;
      const int a = q0 + FWD_BQ + lane + 32 * j;
      ahead[j] = a < seq ? segb[a] : 0;
    }
    // the tile's last id, its first half's last id, its second half's
    // first id, and its real rows (real rows come first)
    int hi = max(ids[2], ids[3]), hi0 = max(ids[0], ids[1]), real = 0;
#pragma unroll
    for (int j = 0; j < FWD_BQ / 32; ++j)
      real += __popc(__ballot_sync(0xffffffffu, ids[j] > 0));
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      hi0 = max(hi0, __shfl_xor_sync(0xffffffffu, hi0, d));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, d));
    }
    hi = max(hi, hi0);
    const int lo1 = __shfl_sync(0xffffffffu, ids[2], 0);
    uniform0 = real >= FWD_BQ / 2 && hi0 == qid;
    uniform1 = real == FWD_BQ && lo1 == hi;
    live1 = lo1 > 0;

    // start: the keys before the tile whose id is below qid form a prefix
    // (keys before row 0 count among them); PROBE probes settle it unless
    // the first of them is already of the tile's first id
    int below = 0, within = 0, below1 = 0, upto0 = 0;
#pragma unroll
    for (int j = 0; j < PROBE / 32; ++j) {
      below += __popc(__ballot_sync(0xffffffffu, back[j] < qid));
      within += __popc(
          __ballot_sync(0xffffffffu, ahead[j] > 0 && ahead[j] <= hi));
      below1 += __popc(__ballot_sync(0xffffffffu, back[j] < lo1));
      below1 += __popc(__ballot_sync(0xffffffffu, ids[j] < lo1));
    }
#pragma unroll
    for (int j = 0; j < FWD_BQ / 32; ++j)
      upto0 += __popc(
          __ballot_sync(0xffffffffu, ids[j] > 0 && ids[j] <= hi0));
    int2 s_rng = make_int2(0, 0), e_rng = make_int2(0, 0);
    if (below > 0) {
      start = q0 - PROBE + below;
    } else {
      s_rng = make_int2(0, q0 - PROBE);
    }
    // end: a tile with a pad row holds the last real row; else the keys
    // after it whose id is within the tile's last form a prefix
    if (real < FWD_BQ) {
      end = q0 + real;
    } else if (within < PROBE) {
      end = q0 + FWD_BQ + within;
    } else {
      e_rng = make_int2(q0 + FWD_BQ + PROBE, seq);
    }
    if (s_rng.x < s_rng.y || e_rng.x < e_rng.y) {
      const int lo = qid;
      const int2 r = warp_partitions(
          s_rng, [&](int j) { return segb[j] < lo; }, e_rng,
          [&](int j) {
            const int id = segb[j];
            return id > 0 && id <= hi;
          },
          lane);
      if (below == 0) start = r.x;
      if (e_rng.y > 0) end = r.y;
    }
    // the halves: the first ends where the ids pass its last (inside the
    // tile, or with the tile); the second starts at its first id's first
    // key: among the PROBE keys before the tile and the first half's rows
    // the ids below it are a prefix, settled unless that id already runs
    // from before them, and so from the tile's first row
    end0 = upto0 < FWD_BQ ? q0 + upto0 : end;
    start1 = below1 > 0 ? q0 - PROBE + below1 : start;
  }
  __device__ __forceinline__ int first() const { return start / FWD_BK; }
  __device__ __forceinline__ int ntiles() const {
    return (end + FWD_BK - 1) / FWD_BK;
  }
  // What warpgroup w's 64 rows do with key tile t: its class (SKIP /
  // MASKED / UNMASKED, bits 0-1) and the keys it takes (bits 2-3): the
  // whole tile (WHOLE), or the half of it that meets the rows' band
  // (LOWER / UPPER: a window's band often ends or starts mid-tile).
  // Skipped outside the band; unmasked when the rows hold one id and the
  // keys taken all lie within that id's keys; masked otherwise.
  __device__ __forceinline__ int pair(int t, int w) const {
    const int k0 = t * FWD_BK;
    const int a = w ? start1 : start, e = w ? end : end0;
    const bool lower = a < k0 + FWD_BK / 2 && e > k0;
    const bool upper = a < k0 + FWD_BK && e > k0 + FWD_BK / 2;
    if ((w && !live1) || !(lower || upper)) return SKIP;
    const int half = lower && upper ? WHOLE : lower ? LOWER : UPPER;
    const int ks = k0 + (half == UPPER ? FWD_BK / 2 : 0);
    const int ke = ks + (half == WHOLE ? FWD_BK : FWD_BK / 2);
    const int cls = (w ? uniform1 : uniform0) && ks >= a && ke <= e
                        ? UNMASKED
                        : MASKED;
    return cls | (half << 2);
  }
  // the key tile's ids, where a warpgroup masks by them
  __device__ __forceinline__ void stage(int* ids, int t, int lane) const {
    if ((pair(t, 0) & 3) != MASKED && (pair(t, 1) & 3) != MASKED) return;
    for (int r = lane; r < FWD_BK; r += 32) {
      const int j = t * FWD_BK + r;
      ids[r] = j < seq ? segb[j] : 0;
    }
  }
  __device__ __forceinline__ Rows rows(int row_lo, int row_hi) const {
    return {row_lo < seq ? segb[row_lo] : 0, row_hi < seq ? segb[row_hi] : 0};
  }
  // same positive id (keys past S carry id 0); s: N / 2 scores of N keys
  template <int N>
  __device__ __forceinline__ void apply(float (&s)[N], const Rows& r,
                                        const int* ids, int, int, int,
                                        int t4) const {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ks = ids[8 * j + 2 * t4 + e];
        if (!(r.lo > 0 && ks == r.lo)) s[4 * j + e] = -INFINITY;
        if (!(r.hi > 0 && ks == r.hi)) s[4 * j + 2 + e] = -INFINITY;
      }
    }
  }
  // a pad row matches no key: l = 0 gives its zeros and LSE_PAD
  __device__ __forceinline__ bool row_live(int) const { return true; }
};

// ---- the persistent kernel -------------------------------------------------

// Shared memory: two Q tiles (the next item's Q loads while this one's last
// key tiles run), a ring of K/V stages with each stage's key ids and walk
// entry, and the barriers.
template <int D>
struct BandSmem {
  static constexpr int STAGES = 4;
  static constexpr int Q = FWD_BQ * ColumnPlan<D>::ROW;    // a Q tile
  static constexpr int KV = FWD_BK * ColumnPlan<D>::ROW;   // a K or V tile
  static constexpr int BARS = (2 * 2 + 2 * STAGES) * 8;
  static constexpr int INFO = (STAGES + 1) / 2 * 2;   // 8-byte aligned
  static constexpr size_t BYTES =
      1024 + 2 * Q + 2 * STAGES * KV + (STAGES * FWD_BK + INFO) * 4 + BARS;
};

// The (head, batch row, query tile) of work item i, heads fastest: the
// blocks at work at once hold neighbouring query tiles of every head, whose
// bands share key tiles in L2.
struct Item {
  int h, b, qt;
};
__device__ __forceinline__ Item item_at(int i, int heads, int batch) {
  return {i % heads, (i / heads) % batch, i / (heads * batch)};
}

// K3 as a persistent kernel: a block an SM walks the work items (query
// tile of a head) blockIdx.x, + gridDim.x, ...; the producer warp runs ahead
// across items (the next item's Q and first K/V tiles load while the
// consumers finish this one and store it), handing each stage's key tile
// and class to the consumers beside it, and one stage with no tile that
// ends each item's walk. A query tile with no real row loads nothing: its
// walk is empty and the consumers store zeros and LSE_PAD.
template <int D, bool LSE>
__global__ void __launch_bounds__(WS_THREADS, 1)
band_fwd_kernel(const __grid_constant__ FwdMaps maps, const FwdParams p,
                const BandMask::Params mp, int batch) {
  using S = BandSmem<D>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sQ = smem;                         // 2 Q tiles
  unsigned char* sK = sQ + 2 * S::Q;                // STAGES K tiles
  unsigned char* sV = sK + STAGES * S::KV;          // STAGES V tiles
  int* sIds = reinterpret_cast<int*>(sV + STAGES * S::KV);   // STAGES x BK
  int* sInfo = sIds + STAGES * FWD_BK;                        // STAGES
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sInfo + S::INFO);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + STAGES;

  const int sq = p.sq, sk = p.sk;
  const int nq = (sq + FWD_BQ - 1) / FWD_BQ, nk = (sk + FWD_BK - 1) / FWD_BK;
  const int items = nq * p.heads * batch;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], CONSUMER_WARPS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // No setmaxnreg here: the producer's band search needs more registers
  // than a decremented producer holds, and ptxas keeps the consumers within
  // the 168 that every warp has at launch anyway.
  if (threadIdx.x >= PRODUCER) {
    // ---- producer: one warp finds each item's band and issues its loads
    if (threadIdx.x >= PRODUCER + 32) return;
    const int lane = threadIdx.x - PRODUCER;
    if (lane == 0) {
      tma_prefetch(&maps.q);
      tma_prefetch(&maps.k);
      tma_prefetch(&maps.v);
      tma_prefetch(&maps.q_tail);
      tma_prefetch(&maps.k_tail);
      tma_prefetch(&maps.v_tail);
    }
    Ring<STAGES> ring;
    Ring<2> qring;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const Item it = item_at(i, p.heads, batch);
      const int q0 = it.qt * FWD_BQ, hk = it.h / p.kv_group;
      BandMask mask(mp, it.b, it.qt, q0, nq, nk, sq, sk);
      const bool live = mask.q_live();
      mbar_wait(&q_empty[qring.stage], qring.phase ^ 1u);
      if (lane == 0) {
        uint64_t* bar = &q_full[qring.stage];
        if (live) {
          mbar_arrive_expect_tx(bar, S::Q);
          load_tile<D>(sQ + qring.stage * S::Q, FWD_BQ, &maps.q, &maps.q_tail,
                       bar, q0, it.h, it.b);
        } else {
          mbar_arrive(bar);
        }
      }
      qring.advance();
      if (live) {
        mask.locate(lane);
        for (int t = mask.first(), end = mask.ntiles(); t < end; ++t) {
          const int c0 = mask.pair(t, 0), c1 = mask.pair(t, 1);
          if ((c0 & 3) == SKIP && (c1 & 3) == SKIP) continue;
          mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
          mask.stage(sIds + ring.stage * FWD_BK, t, lane);
          __syncwarp();
          if (lane == 0) {
            sInfo[ring.stage] = (t << 8) | (c1 << 4) | c0;
            mbar_arrive_expect_tx(&full[ring.stage], 2 * S::KV);
            load_tile<D>(sK + ring.stage * S::KV, FWD_BK, &maps.k,
                         &maps.k_tail, &full[ring.stage], t * FWD_BK, hk,
                         it.b);
            load_tile<D>(sV + ring.stage * S::KV, FWD_BK, &maps.v,
                         &maps.v_tail, &full[ring.stage], t * FWD_BK, hk,
                         it.b);
          }
          ring.advance();
        }
      }
      // the end of the item's walk: a stage with no tile
      mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
      if (lane == 0) {
        sInfo[ring.stage] = -1;
        mbar_arrive(&full[ring.stage]);
      }
      ring.advance();
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows [64 cw, 64 cw + 64) of each item
  const int cw = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  Ring<STAGES> ring;
  Ring<2> qring;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const Item it = item_at(i, p.heads, batch);
    const int q0 = it.qt * FWD_BQ;
    const int row_lo = q0 + 64 * cw + 16 * warp + g, row_hi = row_lo + 8;
    const BandMask mask(mp, it.b, it.qt, q0, nq, nk, sq, sk);
    const BandMask::Rows rows = mask.rows(row_lo, row_hi);
    FwdAcc<D> acc;
    acc.reset();
    mbar_wait(&q_full[qring.stage], qring.phase);
    const uint32_t q_tile = smem_u32(sQ) + qring.stage * S::Q;
    while (true) {
      mbar_wait(&full[ring.stage], ring.phase);
      const int info = sInfo[ring.stage];
      const int mine = info < 0 ? int(SKIP) : (info >> (4 * cw)) & 15;
      const int cls = mine & 3, half = mine >> 2;
      const uint32_t k_tile = smem_u32(sK) + ring.stage * S::KV;
      const uint32_t v_tile = smem_u32(sV) + ring.stage * S::KV;
      const int* ids = sIds + ring.stage * FWD_BK;
      const int k0 = (info >> 8) * FWD_BK;
      if (cls != SKIP && half == WHOLE) {
        fwd_tile<D>(acc, mask, rows, q_tile, k_tile, v_tile, 0, ids, cls,
                    k0, cw, row_lo, row_hi, t4, p.sl2);
      } else if (cls != SKIP) {
        const int koff = half == UPPER ? FWD_BK / 2 : 0;
        fwd_tile<D, FWD_BK / 2>(acc, mask, rows, q_tile, k_tile, v_tile, koff,
                                ids + koff, cls, k0 + koff, cw, row_lo,
                                row_hi, t4, p.sl2);
      }
      // every warp releases the stage (a warpgroup that skips the tile runs
      // no collective wgmma that would hold its warps together)
      if (lane == 0) mbar_arrive(&empty[ring.stage]);
      ring.advance();
      if (info < 0) break;
    }
    // this item's Q is read: the producer may load a later item's into it
    if (lane == 0) mbar_arrive(&q_empty[qring.stage]);
    qring.advance();
    fwd_store<D, LSE, true>(acc, mask, p, it.b, it.h, row_lo, row_hi, t4);
  }
}

// K3 at head dim D: a block an SM (or an item), one launch.
template <int D>
int dispatch(const FwdParams& p, const int* seg, int batch, int kv_heads,
             const View& q, const View& k, const View& v,
             cudaStream_t stream) {
  FwdMaps maps;
  if (!encode_fwd_maps<D>(&maps, batch, p.sq, p.sk, p.heads, kv_heads, q, k,
                          v))
    return TMA_ENCODE_FAILED;
  const BandMask::Params mp{seg};
  const long long items =
      static_cast<long long>((p.sq + FWD_BQ - 1) / FWD_BQ) * p.heads * batch;
  const dim3 grid(static_cast<unsigned>(items < sm_count() ? items
                                                          : sm_count()));
  return p.lse ? int(launch_ws(band_fwd_kernel<D, true>, BandSmem<D>::BYTES,
                               grid, stream, maps, p, mp, batch))
               : int(launch_ws(band_fwd_kernel<D, false>, BandSmem<D>::BYTES,
                               grid, stream, maps, p, mp, batch));
}

}  // namespace

// Plain C entry point for ctypes, with attention_kvgrid.cu's arguments. lse:
// fp32 (batch, heads, seq) contiguous, or null for no LSE. seg: (batch, seq)
// int32 sorted ids. kv_heads divides heads (k / v strides are over kv
// heads). Returns a cudaError_t (0 = launched), or -1 when
// cuTensorMapEncodeTiled refused a tensor map.
extern "C" int visrag_kvgrid_hopper_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const int* seg, int batch, int seq, int heads, int kv_heads, int head_dim,
    long long q_sb, long long q_sr, long long q_sh,
    long long k_sb, long long k_sr, long long k_sh,
    long long v_sb, long long v_sr, long long v_sh,
    long long o_sb, long long o_sr, long long o_sh,
    float scale_log2, void* stream) {
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
    case 80:
      return dispatch<80>(p, seg, batch, kv_heads, qv, kv, vv, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The flash-attention forward on the Hopper core (hopper.cuh), shared by K4
// (segment ids, attention_segment_hopper.cu) and K1 (valid lengths,
// attention_lengths_hopper.cu). The two differ only in which (query, key)
// pairs are visible; a mask policy says that, and everything else (tiles,
// the TMA ring, the products, the online softmax, the epilogue) is this one
// body.
//
// One block = two consumer warpgroups (0, 1) and a producer warpgroup (2) of
// which one warp works (setmaxnreg: 224 / 56 registers). A block owns a
// 128-row query tile of one head (64 rows per consumer warpgroup) and walks
// 128-key K/V tiles; the producer issues the TMA loads into a ring of stages
// guarded by full / empty mbarriers (and lets the policy stage what it needs
// beside each tile), the consumers only compute and release each stage with
// one arrival. S = Q K^T is an SS wgmma m64n128k16 over the head dim; the
// online softmax runs in base 2 with scale * log2(e) folded into one FMA per
// score; P is rounded to bf16 in registers and is the A operand of the RS
// wgmma for O += P V, V read MN-major (the C fragment of S is the A fragment
// of P). O / l is written as bf16 and the LSE (template flag) in natural
// log; a row that sees no key, or that the policy calls dead, gives exact
// zeros and LSE_PAD. Causal query tiles are launched heaviest first.
//
// The column plan (ColumnPlan below; ops/attention_lengths.py
// `column_plan` is its plain version). TMA's 128-byte swizzle takes boxes of
// at most 64 bf16 columns and a wgmma k-step is 16 columns, so a head dim is
// cut into 64-column pieces (128-byte swizzle) and, where 64 does not divide
// it, one 16-column piece with the 32-byte swizzle: d 64 = (0, 64), d 128 =
// (0, 64) + (64, 64), d 72 = (0, 64) + (64, 16). The 16-column piece of d 72
// starts at column 64 of a tensor map whose dim 0 is 72, so TMA writes zeros
// for columns 72-79: they add nothing to S, and O's columns 72-79 are zeros
// that the epilogue does not store (in the ViT's flat (n S, 3 H D) layout
// they would be the next head's columns). Each piece is its own tensor map
// on the same (D, S, H, B) view and its own region of a tile in shared
// memory: rows x 128 bytes per 64-column piece, then rows x 32 bytes.
// Per tile at d 72: S takes 4 k16 steps on the first piece and 1 on the
// second into one accumulator; O += P V is an RS m64n64k16 and an RS
// m64n16k16 per k16 step of keys. The padding adds 16 / 144 of tensor work.
//
// Mask policy (a class with CAUSAL and IDS; see SegmentMask and LengthsMask
// in the two sources): qtile(mp, b, z, nq, sk) (the query tile block z of
// the grid owns: causal tiles heaviest first); built once per block from its
// Params; q_live() (does this query tile load anything: a dead tile writes
// zeros and LSE_PAD with 16-byte stores and returns before it sets up the
// pipeline), ntiles() (key tiles to walk), pair(t)
// (SKIP / MASKED / UNMASKED for key tile t), stage(ids, t, lane) (the
// producer warp's staging of IDS ints per stage; IDS = 0 stages nothing),
// rows(row_lo, row_hi) (per-thread state of its two query rows), apply()
// (the per-element mask of a MASKED pair) and row_live(row) (a dead row is
// written as zeros and LSE_PAD).

#pragma once

#include "attention_lengths_common.cuh"
#include "hopper.cuh"

namespace visrag {
namespace hopper {

constexpr int CONSUMERS = 2;                  // consumer warpgroups
constexpr int CONSUMER_WARPS = 4 * CONSUMERS;
constexpr int PRODUCER = 128 * CONSUMERS;    // first thread of the producer
constexpr int WS_THREADS = PRODUCER + 128;   // its warpgroup
// registers a thread, 56 x 128 + 2 x 224 x 128 = the 64,512 of the launch
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
constexpr int FWD_BQ = 128, FWD_BK = 128;     // forward tile rows
constexpr int HALF_ROW = 128;                 // bytes of a 64-column row
constexpr int TAIL_ROW = 32;                  // bytes of a 16-column row
constexpr int TMA_ENCODE_FAILED = -1;

enum PairClass { SKIP = 0, MASKED = 1, UNMASKED = 2 };

template <int D>
struct ColumnPlan {
  static constexpr int HALVES = D / 64;              // 64-column pieces
  static constexpr int MAIN = 64 * HALVES;           // their columns
  static constexpr int TAIL = D % 64 ? 16 : 0;       // the 16-column piece
  static constexpr int ROW = HALVES * HALF_ROW + (TAIL ? TAIL_ROW : 0);
  static_assert(HALVES >= 1 && D % 8 == 0 && D - MAIN <= 16,
                "ColumnPlan: d = 64 k, or 64 k + 8 or + 16");
};

// One round of a warp's search for the first index p of [r.x, r.y] at
// which `holds` fails, for a predicate that holds on a prefix of the range
// and fails on the rest (p = r.y when it holds throughout): the 32 lanes
// test 32 evenly spaced indices and the range shrinks to the gap between
// the last that holds and the first that fails. Every lane of the warp
// takes part; an empty range (r.x == r.y, the answer) is left as it is.
template <class Holds>
__device__ __forceinline__ void warp_narrow(int2& r, Holds holds, int lane) {
  if (r.x >= r.y) return;
  const int step = (r.y - r.x + 31) >> 5;
  const int at = r.x + lane * step;
  const int n = __popc(__ballot_sync(0xffffffffu, at < r.y && holds(at)));
  if (n == 0) {
    r.y = r.x;
    return;
  }
  r.y = min(r.y, r.x + n * step);
  r.x += (n - 1) * step + 1;
}

// Two such searches side by side, their loads in flight together: about
// log32 of the longer range rounds (3 over 17,668 keys, 2 over 276 tiles).
// → (p of a, p of b), the same in every lane.
template <class HoldsA, class HoldsB>
__device__ __forceinline__ int2 warp_partitions(int2 a, HoldsA holds_a,
                                                int2 b, HoldsB holds_b,
                                                int lane) {
  while (a.x < a.y || b.x < b.y) {
    warp_narrow(a, holds_a, lane);
    warp_narrow(b, holds_b, lane);
  }
  return make_int2(a.x, b.x);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

struct FwdMaps {
  CUtensorMap q, k, v;              // the 64-column pieces
  CUtensorMap q_tail, k_tail, v_tail;   // the 16-column piece (d 72)
};

struct FwdParams {
  __nv_bfloat16* o;
  float* lse;                // (B, H, Sq) fp32, written when LSE
  long long o_sb, o_sr, o_sh;
  int sq, sk, heads, kv_group;
  float sl2;                 // softmax scale * log2(e)
};

template <int D, int IDS>
struct FwdSmem {
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr int Q = FWD_BQ * ColumnPlan<D>::ROW;   // the Q tile
  static constexpr int KV = FWD_BK * ColumnPlan<D>::ROW;  // a K or V tile
  static constexpr int IDS_BYTES = STAGES * IDS * 4;
  static constexpr int BARS = (1 + 2 * STAGES) * 8;
  static constexpr size_t BYTES = 1024 + Q + 2 * STAGES * KV + IDS_BYTES +
                                  BARS;
};

// The TMA loads of one tile (`rows` rows from row r0 of head hh, batch b)
// into `dst`, every piece of the plan, completing on `bar`.
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst, int rows,
                                          const CUtensorMap* main,
                                          const CUtensorMap* tail,
                                          uint64_t* bar, int r0, int hh,
                                          int b) {
  using C = ColumnPlan<D>;
#pragma unroll
  for (int hf = 0; hf < C::HALVES; ++hf)
    tma_load_4d(dst + hf * rows * HALF_ROW, main, bar, 64 * hf, r0, hh, b);
  if constexpr (C::TAIL > 0)
    tma_load_4d(dst + C::HALVES * rows * HALF_ROW, tail, bar, C::MAIN, r0, hh,
                b);
}

// A query tile the policy calls dead: zeros in its rows' first D columns
// and LSE_PAD as their LSE, every thread of the block storing 16 bytes at a
// time.
template <int D, bool LSE>
__device__ __forceinline__ void write_dead_tile(const FwdParams& p, int b,
                                                int h, int q0) {
  constexpr int VECS = D / 8;                  // 16-byte vectors a row
  const int rows = min(FWD_BQ, p.sq - q0);
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh + q0 * p.o_sr;
  for (int i = threadIdx.x; i < rows * VECS; i += WS_THREADS)
    *reinterpret_cast<uint4*>(ob + (i / VECS) * p.o_sr + (i % VECS) * 8) =
        make_uint4(0, 0, 0, 0);
  if (LSE) {
    float* lb = p.lse + (static_cast<long long>(b) * p.heads + h) * p.sq + q0;
    for (int r = threadIdx.x; r < rows; r += WS_THREADS) lb[r] = LSE_PAD;
  }
}

// A consumer warpgroup's running state over one query tile: O's
// fragments (the 64-column pieces, and the 16-column piece), and the
// running max and sum of the thread's two rows.
template <int D>
struct FwdAcc {
  float o[ColumnPlan<D>::MAIN / 2];
  float ot[ColumnPlan<D>::TAIL > 0 ? ColumnPlan<D>::TAIL / 2 : 1];
  float m_lo, m_hi, l_lo, l_hi;
  __device__ __forceinline__ void reset() {
    zero(o);
    zero(ot);
    m_lo = m_hi = -INFINITY;
    l_lo = l_hi = 0.f;
  }
};

// One key tile for consumer warpgroup cw, or NK = 64 of its keys from
// koff (0 or 64): S = Q K^T over the Q tile at q_tile and the keys of the
// K tile at k_tile, the policy's per-element mask on a MASKED pair (ids: the
// slice's key ids, staged beside the tile; k0: its first key), the online
// softmax, and O += P V with the V tile at v_tile. The 64-column pieces of
// a K or V tile hold its FWD_BK rows, then the 16-column piece its rows.
template <int D, int NK = FWD_BK, class Mask>
__device__ __forceinline__ void fwd_tile(FwdAcc<D>& a, const Mask& mask,
                                         const typename Mask::Rows& rows,
                                         uint32_t q_tile, uint32_t k_tile,
                                         uint32_t v_tile, int koff,
                                         const int* ids, int cls, int k0,
                                         int cw, int row_lo, int row_hi,
                                         int t4, float sl2) {
  using C = ColumnPlan<D>;
  static_assert(NK == FWD_BK || NK == FWD_BK / 2, "a tile or half of one");
  // S = Q K^T: 64 rows x NK keys; Q rows of this warpgroup as the
  // K-major A operand, K as the K-major B operand
  float s[NK / 2];
  const uint64_t q_desc =
      make_desc(opaque(q_tile + 64 * cw * HALF_ROW), 16, 1024);
  const uint64_t k_desc = make_desc(k_tile + koff * HALF_ROW, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::MAIN / 16; ++kk) {
    const uint32_t off_q = (kk / 4) * FWD_BQ * HALF_ROW + (kk % 4) * 32;
    const uint32_t off_k = (kk / 4) * FWD_BK * HALF_ROW + (kk % 4) * 32;
    wgmma_ss<NK, 0>(s, desc_add(q_desc, off_q), desc_add(k_desc, off_k),
                    kk > 0);
  }
  if constexpr (C::TAIL > 0) {
    // the 16-column piece: one k16 step, 32-byte swizzle
    const uint64_t qt_desc = make_desc<32>(
        opaque(q_tile + C::HALVES * FWD_BQ * HALF_ROW +
               64 * cw * TAIL_ROW),
        16, 256);
    const uint64_t kt_desc = make_desc<32>(
        k_tile + C::HALVES * FWD_BK * HALF_ROW + koff * TAIL_ROW, 16, 256);
    wgmma_ss<NK, 0>(s, qt_desc, kt_desc, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  if (cls == MASKED) mask.apply(s, rows, ids, k0, row_lo, row_hi, t4);

  // online softmax in base 2 on raw scores; a row with no key yet keeps
  // max -inf and takes 0 as its reference, so every exp2 is 0 or finite
  float mx_lo = a.m_lo, mx_hi = a.m_hi;
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
  const float ref_lo = mx_lo == -INFINITY ? 0.f : mx_lo * sl2;
  const float ref_hi = mx_hi == -INFINITY ? 0.f : mx_hi * sl2;
  const float corr_lo = exp2f(a.m_lo * sl2 - ref_lo);
  const float corr_hi = exp2f(a.m_hi * sl2 - ref_hi);
  a.m_lo = mx_lo;
  a.m_hi = mx_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
  uint32_t pa[NK / 16][4];
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    const float p0 = exp2f(fmaf(s[4 * j], sl2, -ref_lo));
    const float p1 = exp2f(fmaf(s[4 * j + 1], sl2, -ref_lo));
    const float p2 = exp2f(fmaf(s[4 * j + 2], sl2, -ref_hi));
    const float p3 = exp2f(fmaf(s[4 * j + 3], sl2, -ref_hi));
    sum_lo += p0 + p1;
    sum_hi += p2 + p3;
    pa[j / 2][2 * (j % 2)] = pack_bf16(p0, p1);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);
  }
  a.l_lo = a.l_lo * corr_lo + sum_lo;
  a.l_hi = a.l_hi * corr_hi + sum_hi;
#pragma unroll
  for (int j = 0; j < C::MAIN / 8; ++j) {
    a.o[4 * j] *= corr_lo;
    a.o[4 * j + 1] *= corr_lo;
    a.o[4 * j + 2] *= corr_hi;
    a.o[4 * j + 3] *= corr_hi;
  }
  if constexpr (C::TAIL > 0) {
#pragma unroll
    for (int j = 0; j < C::TAIL / 8; ++j) {
      a.ot[4 * j] *= corr_lo;
      a.ot[4 * j + 1] *= corr_lo;
      a.ot[4 * j + 2] *= corr_hi;
      a.ot[4 * j + 3] *= corr_hi;
    }
  }

  // O += P V: P from registers, V MN-major (k16 = 16 keys = 2048 bytes of
  // a 64-column piece, 512 of the 16-column one)
  const uint64_t v_desc =
      make_desc(v_tile + koff * HALF_ROW, FWD_BK * HALF_ROW, 1024);
  const uint64_t vt_desc = make_desc<32>(
      v_tile + C::HALVES * FWD_BK * HALF_ROW + koff * TAIL_ROW, 256, 256);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    wgmma_rs<C::MAIN, 1>(a.o, pa[kk], desc_add(v_desc, kk * 16 * HALF_ROW),
                         1);
    if constexpr (C::TAIL > 0)
      wgmma_rs<16, 1>(a.ot, pa[kk], desc_add(vt_desc, kk * 16 * TAIL_ROW),
                      1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(a.o);
  if constexpr (C::TAIL > 0) fence_regs(a.ot);
}

// Four bf16 pairs a thread of a quad holds (v0..v3: column pairs 2 t4 of
// four 8-column groups) → the four pairs of group t4 (its 8 consecutive
// columns), gathered from the quad by three shuffles.
__device__ __forceinline__ uint4 quad_gather(uint32_t v0, uint32_t v1,
                                             uint32_t v2, uint32_t v3,
                                             int t4) {
  uint32_t w0 = v0, w1 = v1, w2 = v2, w3 = v3;
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    // lane t4 ^ r gives the pair of group t4 and takes that of its own
    const int peer = t4 ^ r;
    const uint32_t give =
        peer == 0 ? v0 : peer == 1 ? v1 : peer == 2 ? v2 : v3;
    const uint32_t got = __shfl_xor_sync(0xffffffffu, give, r);
    w0 = peer == 0 ? got : w0;
    w1 = peer == 1 ? got : w1;
    w2 = peer == 2 ? got : w2;
    w3 = peer == 3 ? got : w3;
  }
  // own pair: group t4's column pair 2 t4
  const uint32_t own = t4 == 0 ? v0 : t4 == 1 ? v1 : t4 == 2 ? v2 : v3;
  w0 = t4 == 0 ? own : w0;
  w1 = t4 == 1 ? own : w1;
  w2 = t4 == 2 ? own : w2;
  w3 = t4 == 3 ? own : w3;
  return make_uint4(w0, w1, w2, w3);
}

// The epilogue of a consumer thread's two rows: o / l and (template flag)
// the LSE. WIDE: each quad gathers its rows' 8-column groups with shuffles
// and stores 16 bytes a thread, a quarter of the store instructions and
// whole 32-byte sectors (K3's persistent kernel, whose stores of one item
// otherwise hold up the next).
template <int D, bool LSE, bool WIDE = false, class Mask>
__device__ __forceinline__ void fwd_store(FwdAcc<D>& a, const Mask& mask,
                                          const FwdParams& p, int b, int h,
                                          int row_lo, int row_hi, int t4) {
  using C = ColumnPlan<D>;
  const float sl2 = p.sl2;
  // epilogue: o / l over the quad's summed l (l == 0, or a dead row, gives
  // exact zeros); only columns < D are stored
  a.l_lo += __shfl_xor_sync(0xffffffffu, a.l_lo, 1);
  a.l_lo += __shfl_xor_sync(0xffffffffu, a.l_lo, 2);
  a.l_hi += __shfl_xor_sync(0xffffffffu, a.l_hi, 1);
  a.l_hi += __shfl_xor_sync(0xffffffffu, a.l_hi, 2);
  const bool sees_lo = a.l_lo > 0.f && mask.row_live(row_lo);
  const bool sees_hi = a.l_hi > 0.f && mask.row_live(row_hi);
  const float inv_lo = sees_lo ? 1.f / a.l_lo : 0.f;
  const float inv_hi = sees_hi ? 1.f / a.l_hi : 0.f;
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
  if constexpr (WIDE) {
    static_assert(C::MAIN % 32 == 0 && (D - C::MAIN) / 8 <= 4,
                  "groups of four 8-column pieces");
    auto pairs = [&](const auto& acc, int j, float inv, int e) {
      return pack_bf16(acc[4 * j + e] * inv, acc[4 * j + e + 1] * inv);
    };
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = hi ? row_hi : row_lo;
      const float inv = hi ? inv_hi : inv_lo;
#pragma unroll
      for (int j0 = 0; j0 < C::MAIN / 8; j0 += 4) {
        const uint4 w = quad_gather(
            pairs(a.o, j0, inv, 2 * hi), pairs(a.o, j0 + 1, inv, 2 * hi),
            pairs(a.o, j0 + 2, inv, 2 * hi), pairs(a.o, j0 + 3, inv, 2 * hi),
            t4);
        if (row < p.sq)
          *reinterpret_cast<uint4*>(ob + row * p.o_sr + 8 * (j0 + t4)) = w;
      }
      if constexpr (C::TAIL > 0) {
        constexpr int TJ = (D - C::MAIN) / 8;
        const uint4 w = quad_gather(
            pairs(a.ot, 0, inv, 2 * hi),
            TJ > 1 ? pairs(a.ot, TJ > 1 ? 1 : 0, inv, 2 * hi) : 0u, 0u, 0u,
            t4);
        if (row < p.sq && t4 < TJ)
          *reinterpret_cast<uint4*>(ob + row * p.o_sr + C::MAIN + 8 * t4) =
              w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < C::MAIN / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (row_lo < p.sq)
        *reinterpret_cast<uint32_t*>(ob + row_lo * p.o_sr + col) =
            pack_bf16(a.o[4 * j] * inv_lo, a.o[4 * j + 1] * inv_lo);
      if (row_hi < p.sq)
        *reinterpret_cast<uint32_t*>(ob + row_hi * p.o_sr + col) =
            pack_bf16(a.o[4 * j + 2] * inv_hi, a.o[4 * j + 3] * inv_hi);
    }
    if constexpr (C::TAIL > 0) {
#pragma unroll
      for (int j = 0; j < (D - C::MAIN) / 8; ++j) {
        const int col = C::MAIN + 8 * j + 2 * t4;
        if (row_lo < p.sq)
          *reinterpret_cast<uint32_t*>(ob + row_lo * p.o_sr + col) =
              pack_bf16(a.ot[4 * j] * inv_lo, a.ot[4 * j + 1] * inv_lo);
        if (row_hi < p.sq)
          *reinterpret_cast<uint32_t*>(ob + row_hi * p.o_sr + col) =
              pack_bf16(a.ot[4 * j + 2] * inv_hi, a.ot[4 * j + 3] * inv_hi);
      }
    }
  }
  if (LSE && t4 == 0) {
    float* lb = p.lse + (static_cast<long long>(b) * p.heads + h) * p.sq;
    if (row_lo < p.sq)
      lb[row_lo] = sees_lo ? (a.m_lo * sl2 + log2f(a.l_lo)) * LN2 : LSE_PAD;
    if (row_hi < p.sq)
      lb[row_hi] = sees_hi ? (a.m_hi * sl2 + log2f(a.l_hi)) * LN2 : LSE_PAD;
  }
}

template <int D, bool LSE, class Mask>
__global__ void __launch_bounds__(WS_THREADS, 1)
attention_fwd_wgmma_kernel(const __grid_constant__ FwdMaps maps,
                           const FwdParams p,
                           const typename Mask::Params mp) {
  using S = FwdSmem<D, Mask::IDS>;
  using C = ColumnPlan<D>;
  constexpr bool CAUSAL = Mask::CAUSAL;
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sQ = smem;
  unsigned char* sK = sQ + S::Q;                    // STAGES K tiles
  unsigned char* sV = sK + STAGES * S::KV;          // STAGES V tiles
  int* sIds = reinterpret_cast<int*>(sV + STAGES * S::KV);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sIds + STAGES * Mask::IDS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int sq = p.sq, sk = p.sk;
  const int nq = (sq + FWD_BQ - 1) / FWD_BQ, nk = (sk + FWD_BK - 1) / FWD_BK;
  const int qt = Mask::qtile(mp, b, static_cast<int>(blockIdx.z), nq, sk);
  const int q0 = qt * FWD_BQ;
  const int hk = h / p.kv_group;
  const Mask mask(mp, b, qt, q0, nq, nk, sq, sk);
  if (!mask.q_live()) {
    write_dead_tile<D, LSE>(p, b, h, q0);
    return;
  }
  const int ntiles = mask.ntiles();

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= PRODUCER) {
    // ---- producer: one warp issues every load
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= PRODUCER + 32) return;
    const int lane = threadIdx.x - PRODUCER;
    if (lane == 0) {
      tma_prefetch(&maps.q);
      tma_prefetch(&maps.k);
      tma_prefetch(&maps.v);
      if constexpr (C::TAIL > 0) {
        tma_prefetch(&maps.q_tail);
        tma_prefetch(&maps.k_tail);
        tma_prefetch(&maps.v_tail);
      }
      mbar_arrive_expect_tx(q_full, S::Q);
      load_tile<D>(sQ, FWD_BQ, &maps.q, &maps.q_tail, q_full, q0, h, b);
    }
    Ring<STAGES> ring;
    for (int t = 0; t < ntiles; ++t) {
      if (mask.pair(t) == SKIP) continue;
      mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
      if constexpr (Mask::IDS > 0) {
        mask.stage(sIds + ring.stage * Mask::IDS, t, lane);
        __syncwarp();
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[ring.stage], 2 * S::KV);
        load_tile<D>(sK + ring.stage * S::KV, FWD_BK, &maps.k, &maps.k_tail,
                     &full[ring.stage], t * FWD_BK, hk, b);
        load_tile<D>(sV + ring.stage * S::KV, FWD_BK, &maps.v, &maps.v_tail,
                     &full[ring.stage], t * FWD_BK, hk, b);
      }
      ring.advance();
    }
    return;
  }

  // ---- consumers: warpgroup cw owns query rows [64 cw, 64 cw + 64)
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int row_lo = q0 + 64 * cw + 16 * warp + g, row_hi = row_lo + 8;
  const typename Mask::Rows rows = mask.rows(row_lo, row_hi);
  const float sl2 = p.sl2;

  FwdAcc<D> acc;
  acc.reset();
  mbar_wait(q_full, 0);

  Ring<STAGES> ring;
  for (int t = 0; t < ntiles; ++t) {
    const int cls = mask.pair(t);
    if (cls == SKIP) continue;
    mbar_wait(&full[ring.stage], ring.phase);
    fwd_tile<D>(acc, mask, rows, smem_u32(sQ),
                smem_u32(sK) + ring.stage * S::KV,
                smem_u32(sV) + ring.stage * S::KV, 0,
                sIds + ring.stage * Mask::IDS, cls, t * FWD_BK, cw, row_lo,
                row_hi, t4, sl2);
    if (tid == 0) mbar_arrive(&empty[ring.stage]);
    ring.advance();
  }
  fwd_store<D, LSE>(acc, mask, p, b, h, row_lo, row_hi, t4);
}

// ---- host ---------------------------------------------------------------------

// A (B, S, H, D) bf16 view: base and element strides (batch, row, head).
struct View {
  const void* ptr;
  long long sb, sr, sh;
};

// Tensor maps of q (sq rows, `heads` heads) and k, v (sk rows, kv_heads)
// for the plan of D: one map per piece and operand. → false if one was
// refused.
template <int D>
inline bool encode_fwd_maps(FwdMaps* m, int batch, int sq, int sk, int heads,
                            int kv_heads, const View& q, const View& k,
                            const View& v) {
  using C = ColumnPlan<D>;
  auto enc = [&](CUtensorMap* map, const View& t, int s, int hh, int cols,
                 int swizzle) {
    return encode_bshd(map, t.ptr, batch, s, hh, D, t.sb, t.sr, t.sh,
                       FWD_BQ, cols, swizzle);
  };
  static_assert(FWD_BQ == FWD_BK, "one box height for q and k/v");
  if (!enc(&m->q, q, sq, heads, 64, 128) ||
      !enc(&m->k, k, sk, kv_heads, 64, 128) ||
      !enc(&m->v, v, sk, kv_heads, 64, 128))
    return false;
  if constexpr (C::TAIL > 0) {
    if (!enc(&m->q_tail, q, sq, heads, C::TAIL, 32) ||
        !enc(&m->k_tail, k, sk, kv_heads, C::TAIL, 32) ||
        !enc(&m->v_tail, v, sk, kv_heads, C::TAIL, 32))
      return false;
  } else {
    m->q_tail = m->q;
    m->k_tail = m->k;
    m->v_tail = m->v;
  }
  return true;
}

// The compiled column plan of D as (first column, width, swizzle bytes)
// triples, to hold the wrapper's against.
template <int D>
inline bool plan_matches(const int* plan, int n) {
  using C = ColumnPlan<D>;
  if (!plan || n != C::HALVES + (C::TAIL > 0)) return false;
  for (int i = 0; i < C::HALVES; ++i)
    if (plan[3 * i] != 64 * i || plan[3 * i + 1] != 64 ||
        plan[3 * i + 2] != 128)
      return false;
  if (C::TAIL > 0) {
    const int* t = plan + 3 * C::HALVES;
    if (t[0] != C::MAIN || t[1] != C::TAIL || t[2] != 32) return false;
  }
  return true;
}

// A warp-specialised launch: opts into `bytes` of dynamic shared memory,
// launches WS_THREADS threads a block, returns the launch's error.
template <typename Kernel, typename... Args>
cudaError_t launch_ws(Kernel kernel, size_t bytes, dim3 grid,
                      cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, WS_THREADS, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// The forward at head dim D over (heads, batch, query tiles).
template <int D, bool LSE, class Mask>
int launch_fwd(const FwdMaps& maps, const FwdParams& p,
               const typename Mask::Params& mp, int batch,
               cudaStream_t stream) {
  const int nq = (p.sq + FWD_BQ - 1) / FWD_BQ;
  return int(launch_ws(attention_fwd_wgmma_kernel<D, LSE, Mask>,
                       FwdSmem<D, Mask::IDS>::BYTES, dim3(p.heads, batch, nq),
                       stream, maps, p, mp));
}

}  // namespace hopper
}  // namespace visrag

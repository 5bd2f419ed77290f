// Valid-length flash attention backward for Hopper (sm_90a): dq, and dk/dv.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` in
// visrag_tpu/ops/attention_lengths.py (launched by flash_bwd_lengths), the
// backward of the forward in attention_lengths.cu. With p[i][j] =
// exp(scale * q[i].k[j] - lse[i]) over the valid pairs (j < len, i < len,
// and j <= i when causal) and 0 elsewhere:
//
//   delta[i] = sum_d o[i][d] * do[i][d]
//   ds[i][j] = p[i][j] * (do[i].v[j] - delta[i])
//   dq[i] = scale * sum_j ds[i][j] k[j]
//   dk[j] = scale * sum_{h in group} sum_i ds[i][j] q[i]
//   dv[j] = sum_{h in group} sum_i p[i][j] do[i]
//
// Query rows at or past len are outside the forward's contract: their `do`
// is ignored (the caller's do on pad rows need not be zero) and their dq is
// zero; pad key rows get zero dk and dv; a length-0 row is all zeros.
//
// Grouped kv heads: k/v carry H / kv_group heads and are read through
// strides, never repeated (query head h reads kv head h / kv_group), as in
// the forward. The JAX package repeats K/V to H heads and sums the repeated
// gradients; here the sum over the group happens inside the dk/dv kernel.
//
// Two kernels, as on the TPU, so that every output element is written by
// one block and the result is deterministic (no atomics):
//   * dq: one block per (64-query tile, query head, batch row); each warp
//     owns 16 query rows and loops over the K/V tiles up to ceil(len/64)
//     (causal: up to the diagonal). Delta is computed here from the o and do
//     tiles and also stored, fp32 (B, H, S), for the dk/dv kernel, which the
//     wrapper launches after this one on the same stream.
//   * dk/dv: one block per (64-key tile, kv head, batch row); each warp owns
//     16 keys and walks a flattened list of (query head of the group, query
//     tile) from the diagonal (causal) or 0 up to ceil(len/64), masking the
//     rows at or past len in the last tile. This is K4's dk/dv design
//     (attention_segment.cu) with length masks in place of segment ids.
// Tiles past the length do no tile work and write zeros.
//
// Both work transposed where that keeps the product's rows in the warp:
// the dk/dv kernel computes S^T = K Q^T and dP^T = V dO^T, so that P^T and
// dS^T are A operands of dV += P^T dO and dK += dS^T Q. Every product is
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) with the score tiles in
// registers; operands that are read along their rows come in through
// ldmatrix.trans. cp.async double-buffers the streamed tiles. What bounds
// it, as in the forward: the work on the 64 x 64 score tile (here five
// tensor-core products and the exp2 per element), not HBM. Registers are the
// scarce resource at d = 128: the dk/dv kernel holds two 16 x 128 fp32
// accumulators per warp (128 registers), so it takes each 64-query tile as
// two 32-query halves to keep S^T and dP^T at 32 registers, and neither
// kernel caches its resident tile's fragments in registers (they are read
// from shared memory at each k step). d is padded to a multiple of 16 in
// shared memory only; the strides are the forward's, so the ViT's flat
// layout writes dq, dk and dv straight into one (n*S, 3*H*D) buffer, the
// gradient of the fused qkv GEMM's output. d in {64, 72, 128}.

#include "attention_lengths_common.cuh"

namespace {

using namespace visrag;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dO;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const float* lse;      // (B, H, S), natural log
  float* delta;          // (B, H, S): written by dq, read by dk/dv
  const int* lengths;
  int seq, heads, kv_group;
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

template <int D>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  // q, do, 2 x (k, v), then lse*log2(e) and delta of the 64 rows
  return 6 * Tile<D>::TILE_BYTES + 2 * 64 * sizeof(float);
}

template <int D>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  // k, v, 2 x (q, do), then 2 x (lse*log2(e), delta) of the query tile
  return 6 * Tile<D>::TILE_BYTES + 2 * 2 * 64 * sizeof(float);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
lengths_attention_dq_kernel(const Params p) {
  using T = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + 64 * T::LDH;
  __nv_bfloat16* sKV0 = sdO + 64 * T::LDH;
  float* sLse = reinterpret_cast<float*>(smem + 6 * T::TILE_BYTES);
  float* sDelta = sLse + 64;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int seq = p.seq;
  const int kv_end = min(max(p.lengths[b], 0), seq);

  __nv_bfloat16* dqb = p.dq + b * p.dq_sb + h * p.dq_sh;
  if (q0 >= kv_end) {        // every row of this tile is a pad row
    store_zero_rows<D>(dqb, p.dq_sr, q0, seq);
    return;
  }
  const int hk = h / p.kv_group;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;
  const __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
  const __nv_bfloat16* dob = p.dO + b * p.do_sb + h * p.do_sh;
  const long long row_base = (static_cast<long long>(b) * p.heads + h) * seq;

  zero_smem(smem, 6 * T::TILE_BYTES);
  __syncthreads();

  auto stage_k = [&](int st) { return sKV0 + st * 2 * 64 * T::LDH; };
  auto stage_v = [&](int st) { return stage_k(st) + 64 * T::LDH; };
  int hi = kv_end;
  if (CAUSAL) hi = min(hi, q0 + BQ);
  const int ntiles = (hi + BK - 1) / BK;   // >= 1 here
  load_tile_async<D>(sQ, qb, p.q_sr, q0, kv_end);
  load_tile_async<D>(sdO, dob, p.do_sr, q0, kv_end);
  load_tile_async<D>(stage_k(0), kb, p.k_sr, 0, kv_end);
  load_tile_async<D>(stage_v(0), vb, p.v_sr, 0, kv_end);
  cp_async_commit();

  // delta = rowsum(o * do) in fp32, two threads per row (o from global,
  // do from global too: the tile copy is still in flight)
  {
    const int r = tid >> 1, half = tid & 1;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < kv_end) {
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
      sLse[r] = row < kv_end ? p.lse[row_base + row] * LOG2E : 0.f;
      if (row < seq) p.delta[row_base + row] = acc;
    }
  }

  const int wrow = warp * 16;
  const int qrow_lo = q0 + wrow + g, qrow_hi = qrow_lo + 8;
  const float scale_log2 = p.scale * LOG2E;
  float dq[T::NT][4];
#pragma unroll
  for (int n = 0; n < T::NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * BK;
    const __nv_bfloat16* sK = stage_k(tile & 1);
    const __nv_bfloat16* sV = stage_v(tile & 1);
    if (tile + 1 < ntiles) {
      load_tile_async<D>(stage_k((tile + 1) & 1), kb, p.k_sr, k0 + BK, kv_end);
      load_tile_async<D>(stage_v((tile + 1) & 1), vb, p.v_sr, k0 + BK, kv_end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // q, do, lse and delta have landed with the first tile
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

    // dS = P * (dP - delta), P = exp(scale*s - lse) on the valid pairs
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + 2 * t + e;
        const bool ok_lo = col < kv_end && qrow_lo < kv_end &&
                           (!CAUSAL || col <= qrow_lo);
        const bool ok_hi = col < kv_end && qrow_hi < kv_end &&
                           (!CAUSAL || col <= qrow_hi);
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
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (qrow_lo < seq)
      *reinterpret_cast<uint32_t*>(dqb + qrow_lo * p.dq_sr + col) =
          pack_bf16(dq[n][0] * p.scale, dq[n][1] * p.scale);
    if (qrow_hi < seq)
      *reinterpret_cast<uint32_t*>(dqb + qrow_hi * p.dq_sr + col) =
          pack_bf16(dq[n][2] * p.scale, dq[n][3] * p.scale);
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
lengths_attention_dkv_kernel(const Params p) {
  using T = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + 64 * T::LDH;
  __nv_bfloat16* sQD0 = sV + 64 * T::LDH;
  float* sRow0 = reinterpret_cast<float*>(smem + 6 * T::TILE_BYTES);

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;          // kv head
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int seq = p.seq;
  const int kv_end = min(max(p.lengths[b], 0), seq);

  __nv_bfloat16* dkb = p.dk + b * p.dk_sb + hk * p.dk_sh;
  __nv_bfloat16* dvb = p.dv + b * p.dv_sb + hk * p.dv_sh;
  if (k0 >= kv_end) {        // every key of this tile is a pad key
    store_zero_rows<D>(dkb, p.dk_sr, k0, seq);
    store_zero_rows<D>(dvb, p.dv_sr, k0, seq);
    return;
  }
  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;

  zero_smem(smem, 6 * T::TILE_BYTES);
  __syncthreads();

  // the work list: (query head of the group, query tile) pairs, heads outer
  const int i_begin = CAUSAL ? k0 / BQ : 0;
  const int cnt = (kv_end + BQ - 1) / BQ - i_begin;   // > 0 here
  const int total = p.kv_group * cnt;

  auto stage_q = [&](int st) { return sQD0 + st * 2 * 64 * T::LDH; };
  auto stage_do = [&](int st) { return stage_q(st) + 64 * T::LDH; };
  auto stage_row = [&](int st) { return sRow0 + st * 2 * 64; };
  // q and do tiles of work item idx, with lse*log2(e) and delta of its 64
  // query rows (plain stores; the barrier at the top of the iteration that
  // reads them orders them)
  auto load_stage = [&](int st, int idx) {
    const int h = hk * p.kv_group + idx / cnt;
    const int q0 = (i_begin + idx % cnt) * BQ;
    load_tile_async<D>(stage_q(st), p.q + b * p.q_sb + h * p.q_sh, p.q_sr, q0,
                       kv_end);
    load_tile_async<D>(stage_do(st), p.dO + b * p.do_sb + h * p.do_sh,
                       p.do_sr, q0, kv_end);
    if (tid < BQ) {
      const int row = q0 + tid;
      const bool ok = row < kv_end;
      const long long at = (static_cast<long long>(b) * p.heads + h) * seq + row;
      stage_row(st)[tid] = ok ? p.lse[at] * LOG2E : 0.f;
      stage_row(st)[64 + tid] = ok ? p.delta[at] : 0.f;
    }
    cp_async_commit();
  };
  load_tile_async<D>(sK, kb, p.k_sr, k0, kv_end);
  load_tile_async<D>(sV, vb, p.v_sr, k0, kv_end);
  load_stage(0, 0);          // one group with k and v

  const int wk = warp * 16;
  const int key_lo = k0 + wk + g, key_hi = key_lo + 8;
  const float scale_log2 = p.scale * LOG2E;
  float dk[T::NT][4], dv[T::NT][4];
#pragma unroll
  for (int n = 0; n < T::NT; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int cur = 0; cur < total; ++cur) {
    const int q0 = (i_begin + cur % cnt) * BQ;
    const int st = cur & 1;
    const __nv_bfloat16* sQ = stage_q(st);
    const __nv_bfloat16* sdO = stage_do(st);
    const float* sLse = stage_row(st);
    const float* sDelta = sLse + 64;
    if (cur + 1 < total) {
      load_stage(st ^ 1, cur + 1);
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
      if (q0 + c0 >= kv_end) break;   // the half holds pad rows only
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

      // P^T and dS^T = P^T * (dP^T - delta) on the valid pairs; the query
      // is the column here, so lse and delta are read per column
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * j + 2 * t + e;
          const int qrow = q0 + c;
          const bool q_ok = qrow < kv_end;
          const bool ok_lo = q_ok && key_lo < kv_end &&
                             (!CAUSAL || qrow >= key_lo);
          const bool ok_hi = q_ok && key_hi < kv_end &&
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
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (key_lo < seq) {
      const bool ok = key_lo < kv_end;
      *reinterpret_cast<uint32_t*>(dkb + key_lo * p.dk_sr + col) = ok
          ? pack_bf16(dk[n][0] * p.scale, dk[n][1] * p.scale) : 0u;
      *reinterpret_cast<uint32_t*>(dvb + key_lo * p.dv_sr + col) = ok
          ? pack_bf16(dv[n][0], dv[n][1]) : 0u;
    }
    if (key_hi < seq) {
      const bool ok = key_hi < kv_end;
      *reinterpret_cast<uint32_t*>(dkb + key_hi * p.dk_sr + col) = ok
          ? pack_bf16(dk[n][2] * p.scale, dk[n][3] * p.scale) : 0u;
      *reinterpret_cast<uint32_t*>(dvb + key_hi * p.dv_sr + col) = ok
          ? pack_bf16(dv[n][2], dv[n][3]) : 0u;
    }
  }
}

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
  const int tiles = (p.seq + 63) / 64;
  if (which == 0)
    return launch(lengths_attention_dq_kernel<D, CAUSAL>, dq_smem_bytes<D>(),
                  p, dim3(tiles, p.heads, batch), stream);
  return launch(lengths_attention_dkv_kernel<D, CAUSAL>, dkv_smem_bytes<D>(),
                p, dim3(tiles, p.heads / p.kv_group, batch), stream);
}

int run(int which, const void* q, const void* k, const void* v, const void* o,
        const void* dO, void* dq, void* dk, void* dv, const void* lse,
        void* delta, const int* lengths, int batch, int seq, int heads,
        int kv_heads, int head_dim, const long long* st, int causal,
        float scale, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads) return int(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dO = static_cast<const __nv_bfloat16*>(dO);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.lengths = lengths;
  p.seq = seq;
  p.heads = heads;
  p.kv_group = heads / kv_heads;
  long long* dst[] = {&p.q_sb, &p.q_sr, &p.q_sh, &p.k_sb, &p.k_sr, &p.k_sh,
                      &p.v_sb, &p.v_sr, &p.v_sh, &p.o_sb, &p.o_sr, &p.o_sh,
                      &p.do_sb, &p.do_sr, &p.do_sh, &p.dq_sb, &p.dq_sr,
                      &p.dq_sh, &p.dk_sb, &p.dk_sr, &p.dk_sh, &p.dv_sb,
                      &p.dv_sr, &p.dv_sh};
  for (int i = 0; i < 24; ++i) *dst[i] = st[i];
  p.scale = scale;
  if (batch <= 0 || seq <= 0 || heads <= 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return int(causal ? dispatch<64, true>(p, batch, which, s)
                        : dispatch<64, false>(p, batch, which, s));
    case 72:
      return int(causal ? dispatch<72, true>(p, batch, which, s)
                        : dispatch<72, false>(p, batch, which, s));
    case 128:
      return int(causal ? dispatch<128, true>(p, batch, which, s)
                        : dispatch<128, false>(p, batch, which, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points for ctypes, one per kernel. strides: 24 element
// strides, (batch, row, head) for q, k, v, o, do, dq, dk, dv in that order;
// k, v, dk and dv carry kv_heads heads, which must divide heads.
// lse and delta: fp32 (batch, heads, seq) contiguous; the dq kernel writes
// delta and the dk/dv kernel reads it, so launch dq first on one stream.
// Each returns a cudaError_t (0 = launched).
extern "C" int visrag_lengths_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, void* dq, void* dk, void* dv, const void* lse,
    void* delta, const int* lengths, int batch, int seq, int heads,
    int kv_heads, int head_dim, const long long* strides, int causal,
    float scale, void* stream) {
  return run(0, q, k, v, o, dO, dq, dk, dv, lse, delta, lengths, batch, seq,
             heads, kv_heads, head_dim, strides, causal, scale, stream);
}

extern "C" int visrag_lengths_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, void* dq, void* dk, void* dv, const void* lse,
    void* delta, const int* lengths, int batch, int seq, int heads,
    int kv_heads, int head_dim, const long long* strides, int causal,
    float scale, void* stream) {
  return run(1, q, k, v, o, dO, dq, dk, dv, lse, delta, lengths, batch, seq,
             heads, kv_heads, head_dim, strides, causal, scale, stream);
}

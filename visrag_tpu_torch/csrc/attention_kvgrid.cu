// Banded segment attention forward for Hopper (sm_90a), K3: the first
// kernel, on the mma.sync core. Every K3 launch of the port runs
// attention_kvgrid_hopper.cu; this one is reached only with `legacy=True`
// (ops/attention_kvgrid.py), to time one against the other.
//
// Replaces the TPU kernel `_fwd_kernel_banded` in
// visrag_tpu/ops/attention_kvgrid.py (its band bounds `_band_bounds`, and
// the wrapper's padding) for the Qwen2.5-VL vision tower. For each batch row
// b, head h and query row i:
//
//   o[i] = softmax_j(scale * q[i].k[j] : seg[j] == seg[i] > 0) . v
//
// Segment ids are contiguous ascending runs over the real tokens (1, 1, ...,
// 2, 2, ...) with padding (<= 0) only after them: window segments of <= 64
// patches in the 28 window layers, one segment per image in the 4
// full-attention layers. Rows with seg <= 0, and rows with no key, are
// written as exact zeros.
//
// With the LSE template flag (training: the backward replays the segment
// kernels of attention_segment.cu, which read it) it also writes the
// natural-log log-sum-exp of each row's scores, fp32 (B, H, S) contiguous;
// rows with no key get the +LARGE sentinel LSE_PAD. Without the flag
// (inference) the LSE is neither computed nor written.
//
// The band. Because the ids are sorted, the keys a 64-row query tile can see
// form one contiguous range [kstart, kend): the rows whose id lies in the
// tile's [min real id, max real id]. Thread 0 finds both ends by binary
// search over the row's ids (O(log S) cached loads), so the band is exact:
// no bound on the segment length is needed and nothing is cut, at any
// length. The K/V loop then streams only the band, 64 keys at a time from
// kstart (not tile-aligned: 64-patch windows straddle 64-row tiles, so the
// band starts mid-window), and masks every score by segment equality.
//
// What bounds it: window layers are 64-wide bands of 1-3 key tiles per query
// tile, so the work is the two (64 x 64 x d) tensor-core products per tile
// plus the mask; full layers run 5040-key spans per page. As in K1 (see
// attention_lengths.cu) each warp owns 16 query rows and keeps S, P, the
// running max/sum and O in mma.sync m16n8k16 fragments (bf16 in, fp32
// accumulate), the online softmax runs in base 2 with scale*log2(e) folded
// into the q tile, and two cp.async stages of K/V (and their 64 segment ids)
// live in shared memory (57 KB at d=80, opted into at launch). d = 80 is
// 5 x k16, so nothing is padded.
//
// Layout: q/k/v/o base pointers plus element strides (batch, row, head) with
// a contiguous head dim, so the vision block's fused qkv GEMM output is read
// in place; k/v may carry H / kv_group heads.

#include "attention_lengths_common.cuh"

namespace {

using namespace visrag;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;            // (B, H, S) or null
  const int* seg;        // (B, S) contiguous segment ids
  int seq, heads, kv_group;
  long long q_sb, q_sr, q_sh;
  long long k_sb, k_sr, k_sh;
  long long v_sb, v_sr, v_sh;
  long long o_sb, o_sr, o_sh;
  float scale_log2;
};

template <int D>
__host__ __device__ constexpr size_t kvgrid_smem_bytes() {
  return 5 * Tile<D>::TILE_BYTES + 2 * BK * sizeof(int);  // + stage key ids
}

// Rows i in [0, seq) with 0 < seg[i] < id. Over sorted real ids followed by
// padding this predicate holds on a prefix, so the count is a binary search.
__device__ int count_below(const int* seg, int seq, int id) {
  int lo = 0, hi = seq;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int s = seg[mid];
    if (s > 0 && s < id) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <int D, bool LSE>
__global__ void __launch_bounds__(NTHREADS)
kvgrid_fwd_kernel(const Params p) {
  using T = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK0 = sQ + 64 * T::LDH;
  int* sSeg = reinterpret_cast<int*>(smem + 5 * T::TILE_BYTES);
  __shared__ int band[2];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int seq = p.seq;
  const int* segb = p.seg + static_cast<long long>(b) * seq;

  if (tid == 0) {
    const int lo_id = segb[q0];
    int hi_id = 0;
    for (int r = 0; r < BQ && q0 + r < seq; ++r) hi_id = max(hi_id, segb[q0 + r]);
    int ks = 0, ke = 0;
    if (lo_id > 0) {
      ks = count_below(segb, seq, lo_id);
      ke = count_below(segb, seq, hi_id + 1);
    }
    band[0] = ks;
    band[1] = ke;
  }
  zero_smem(smem, 5 * T::TILE_BYTES);
  __syncthreads();
  const int kstart = band[0], kend = band[1];

  const int hk = h / p.kv_group;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;

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

  const int wrow = warp * 16;
  uint32_t qf[T::KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < T::KSTEPS; ++kk)
    load_a(qf[kk], sQ, T::LDH, wrow, kk * 16, g, t);

  float o[T::NT][4];
#pragma unroll
  for (int n = 0; n < T::NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  const int qrow_lo = q0 + wrow + g, qrow_hi = qrow_lo + 8;
  // a pad row (id <= 0) matches no key: its output stays exactly zero
  const int qseg_lo = qrow_lo < seq ? segb[qrow_lo] : 0;
  const int qseg_hi = qrow_hi < seq ? segb[qrow_hi] : 0;

  const int ntiles = kend > kstart ? (kend - kstart + BK - 1) / BK : 0;

  auto stage_k = [&](int st) { return sK0 + st * 2 * 64 * T::LDH; };
  auto stage_v = [&](int st) { return stage_k(st) + 64 * T::LDH; };
  auto load_stage = [&](int st, int r0) {
    load_tile_async<D>(stage_k(st), kb, p.k_sr, r0, kend);
    load_tile_async<D>(stage_v(st), vb, p.v_sr, r0, kend);
    if (tid < BK) sSeg[st * BK + tid] = r0 + tid < kend ? segb[r0 + tid] : 0;
    cp_async_commit();
  };
  if (ntiles > 0) load_stage(0, kstart);

  for (int tile = 0; tile < ntiles; ++tile) {
    const int st = tile & 1;
    const __nv_bfloat16* sK = stage_k(st);
    const __nv_bfloat16* sV = stage_v(st);
    if (tile + 1 < ntiles) {
      // the other stage was released by the barrier that ended tile - 1
      load_stage(st ^ 1, kstart + (tile + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (tiles and ids) has landed for every thread
    const int* kseg = sSeg + st * BK;

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

    // mask: same segment, real query (keys past kend carry id 0)
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ks = kseg[8 * j + 2 * t + e];
        s[j][e] = (qseg_lo > 0 && ks == qseg_lo) ? s[j][e] : -INFINITY;
        s[j][2 + e] = (qseg_hi > 0 && ks == qseg_hi) ? s[j][2 + e] : -INFINITY;
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
      lb[qrow_lo] = l_lo > 0.f ? (m_lo + log2f(l_lo)) * LN2 : LSE_PAD;
    if (qrow_hi < seq)
      lb[qrow_hi] = l_hi > 0.f ? (m_hi + log2f(l_hi)) * LN2 : LSE_PAD;
  }
}

template <int D, bool LSE>
cudaError_t launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  auto kernel = kvgrid_fwd_kernel<D, LSE>;
  const size_t bytes = kvgrid_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + BQ - 1) / BQ, heads, batch);
  kernel<<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. seg: int32 (batch, seq) contiguous; lse:
// fp32 (batch, heads, seq) contiguous, or null for no LSE; kv_heads divides
// heads. Returns a cudaError_t (0 = launched).
extern "C" int visrag_kvgrid_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const int* seg,
    int batch, int seq, int heads, int kv_heads, int head_dim,
    long long q_sb, long long q_sr, long long q_sh,
    long long k_sb, long long k_sr, long long k_sh,
    long long v_sb, long long v_sr, long long v_sh,
    long long o_sb, long long o_sr, long long o_sh,
    float scale_log2, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.seg = seg;
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
  // d = 80: every Qwen2.5-VL vision tower (1280 wide, 16 heads)
  if (head_dim != 80) return int(cudaErrorInvalidValue);
  return int(p.lse ? launch<80, true>(p, batch, heads, s)
                   : launch<80, false>(p, batch, heads, s));
}

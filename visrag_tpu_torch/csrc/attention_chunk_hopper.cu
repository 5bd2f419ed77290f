// Chunked-prefill attention for Hopper (sm_90a), K8: the forward body of
// hopper_attention_fwd.cuh (wgmma, TMA, one producer warp and two consumer
// warpgroups) with a mask at a query offset.
//
// Replaces no TPU kernel: the JAX package runs this function as plain XLA
// (`xla_chunk_attention`, visrag_tpu/ops/attention.py:86), and the port ran
// it as plain PyTorch (ops/attention.py `chunk_attention_reference`), which
// on an H100 spent about 250 ms of every 2048-token chunk of the 7B in fp32
// SGEMMs and a dozen full passes over fp32 score planes. For each
// batch row b, head h and query row i of a chunk at global positions
// start[b] + i:
//
//   o[i] = softmax_j(scale * q[i].k[j] : j <= start[b] + i and j < L) . v
//
// q and o are (B, C, H, D), k and v (B, L, H_kv, D) with L >= start + C
// (the prefix gathered from the paged pool with this chunk already
// written), bf16 in and out; scores, running max / sum and the accumulator
// in fp32, P rounded to bf16 for P V (the plain version's own rounding).
// Grouped-query attention: query head h reads kv head h / (H / H_kv)
// through the tensor maps, with no repeat in memory (the 7B: 28 over 4; the
// 3B rollout 16 over 2; a tensor-parallel rank 14 over 2 or 7 over 1).
//
// What bounds it on the H100: the operations. A 2048-row chunk at start
// 4096 over 28 heads of 128 is 150 GFLOP (0.152 ms at 989 TFLOP/s) against
// 37 MB of q, k, v and o (0.011 ms at 3.35 TB/s). The design is K1's and
// K4's forward: 128-row query tiles walk 128-key K/V tiles through a TMA
// ring, SS wgmma for S and RS wgmma for O += P V, and the mask needs no
// pre-pass: each (query tile at q0, key tile at k0) pair is classed in
// closed form from start (ChunkMask below; the plain version is
// `chunk_pair_classes_reference` in ops/attention.py):
//   skip      when k0 > start + q0 + BQ - 1 (the tile lies past every
//             row's last visible key; tiles at or past L are never walked);
//   unmasked  when k0 + BK - 1 <= start + q0 and k0 + BK <= L;
//   masked    otherwise, per element on key <= start + query and key < L.
// A query tile walks ceil((start + q0 + BQ) / BK) key tiles (at most all of
// L), so the tiles of a chunk differ in work by C / BK tiles at most; the
// grid launches them heaviest first, as K1's causal tiles. Only d 128 is
// compiled: the Qwen2.5 text stack is the one caller.

#include "hopper_attention_fwd.cuh"

namespace {

using namespace visrag;
using namespace visrag::hopper;

constexpr int CHUNK_D = 128;

// Closed-form classes from start[b], read once per block; nothing staged.
struct ChunkMask {
  static constexpr bool CAUSAL = true;
  static constexpr int IDS = 0;
  struct Params {
    const int* start;        // (B,) global position of each row's query 0
  };
  struct Rows {};
  int start, q0, nk, sk;

  __device__ __forceinline__ ChunkMask(const Params& mp, int b, int, int q0_,
                                       int, int nk_, int, int sk_)
      : start(mp.start[b]), q0(q0_), nk(nk_), sk(sk_) {}

  // the query tiles heaviest first: tile qt walks the most keys at the top
  static __device__ __forceinline__ int qtile(const Params&, int, int z,
                                              int nq, int) {
    return nq - 1 - z;
  }
  __device__ __forceinline__ bool q_live() const { return true; }
  __device__ __forceinline__ int ntiles() const {
    return min(nk, (start + q0 + FWD_BQ - 1) / FWD_BK + 1);
  }
  __device__ __forceinline__ int pair(int t) const {
    const int k0 = t * FWD_BK;
    if (k0 > start + q0 + FWD_BQ - 1) return SKIP;
    if (k0 + FWD_BK - 1 <= start + q0 && k0 + FWD_BK <= sk) return UNMASKED;
    return MASKED;
  }
  __device__ __forceinline__ void stage(int*, int, int) const {}
  __device__ __forceinline__ Rows rows(int, int) const { return {}; }
  __device__ __forceinline__ void apply(float (&s)[64], const Rows&,
                                        const int*, int k0, int row_lo,
                                        int row_hi, int t4) const {
    const int last_lo = min(start + row_lo, sk - 1);
    const int last_hi = min(start + row_hi, sk - 1);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t4 + e;
        if (key > last_lo) s[4 * j + e] = -INFINITY;
        if (key > last_hi) s[4 * j + 2 + e] = -INFINITY;
      }
    }
  }
  __device__ __forceinline__ bool row_live(int) const { return true; }
};

}  // namespace

// Plain C entry point for ctypes, in the style of K1's
// visrag_lengths_hopper_fwd: q / o (batch, chunk, heads, head_dim), k / v
// (batch, keys, kv_heads, head_dim), bf16, element strides (batch, row,
// head) with a contiguous head dim; start (batch,) int32 on the device.
// kv_heads divides heads. Returns a cudaError_t (0 = launched), or -1 when
// cuTensorMapEncodeTiled refused a tensor map.
extern "C" int visrag_chunk_hopper_fwd(
    const void* q, const void* k, const void* v, void* o, const int* start,
    int batch, int chunk, int keys, int heads, int kv_heads, int head_dim,
    long long q_sb, long long q_sr, long long q_sh,
    long long k_sb, long long k_sr, long long k_sh,
    long long v_sb, long long v_sr, long long v_sh,
    long long o_sb, long long o_sr, long long o_sh,
    float scale_log2, void* stream) {
  if (head_dim != CHUNK_D || kv_heads <= 0 || heads % kv_heads || keys <= 0)
    return int(cudaErrorInvalidValue);
  if (batch <= 0 || chunk <= 0 || heads <= 0) return int(cudaSuccess);
  FwdParams p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = nullptr;
  p.o_sb = o_sb, p.o_sr = o_sr, p.o_sh = o_sh;
  p.sq = chunk, p.sk = keys, p.heads = heads, p.kv_group = heads / kv_heads;
  p.sl2 = scale_log2;
  FwdMaps maps;
  if (!encode_fwd_maps<CHUNK_D>(&maps, batch, chunk, keys, heads, kv_heads,
                                View{q, q_sb, q_sr, q_sh},
                                View{k, k_sb, k_sr, k_sh},
                                View{v, v_sb, v_sr, v_sh}))
    return TMA_ENCODE_FAILED;
  const ChunkMask::Params mp{start};
  return launch_fwd<CHUNK_D, false, ChunkMask>(
      maps, p, mp, batch, static_cast<cudaStream_t>(stream));
}

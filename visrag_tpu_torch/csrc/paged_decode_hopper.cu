// Paged decode attention for Hopper (sm_90a), K5, on the tensor cores.
//
// Replaces the TPU kernel `_paged_kernel` in visrag_tpu/serving/paged_kv.py
// (launched by paged_decode_attention; bf16 pools and `quantized=True`).
// One query token per engine slot attends the slot's cached keys, which live
// in a pool of head-major blocks (n_blocks, kv_heads, BS, D) reached through
// a block table (slots, max_blk):
//
//   o[s, h] = softmax_t(q[s, h] . k[t] * scale : t < len[s]) . v
//
// with k/v of kv head h / REP, token t in pool block table[s, t / BS], row
// t % BS. Every token row is addressed through its own table entry, so one
// code path serves every power-of-two block size from 1 to 128; only the
// rows below the length are read, and a table entry past them is never
// touched. D is 64 or 128; REP = heads / kv_heads is 1 to 8.
//
// Arithmetic, bf16 pools: q * scale in fp32, rounded to bf16; scores bf16 x
// bf16 summed in fp32; online softmax with the natural exp; P rounded to
// bf16 for P.V, summed in fp32; o = acc / max(l, 1e-30). int8 pools (the
// TPU kernel's order): int8 converted exactly to bf16; each score times its
// token's k scale after the dot; the sum l from the unscaled P; P times the
// token's v scale before the bf16 rounding. k_scale / v_scale are fp32
// (n_blocks, kv_heads, BS), the JAX package's row-form scales in the same
// order.
//
// What bounds it: the bytes of K and V at the slots' real lengths (about 2
// operations a byte). The design:
//
//  * The split follows the lengths, on the device. The grid (splits,
//    kv_heads, slots) depends on shapes only. Block (split, g, s) reads
//    len[s] and takes an equal share, in whole 64-token tiles, of the slot's
//    ceil(len / 64) tiles, so every block of a slot holds work while the
//    slot has as many tiles as splits.
//  * Tiles in flight. Each of the block's 4 warps owns 16 tokens of every
//    64-token tile and runs its own cp.async ring of (16 K rows, 16 V
//    rows[, their scales]), the next sub-tiles in flight while one is
//    computed, with no block barrier inside the loop: two stages at bf16
//    (3 blocks an SM at d 128, 96 KB in flight an SM), three at int8;
//    these measured faster than deeper rings with fewer blocks. A row is gathered with 16-byte cp.async through its own table
//    entry (zero-filled past the length, so stale pool rows never reach the
//    products); the next sub-tile's table entries are read one step ahead.
//  * Tensor cores, tokens as the long dimension: S^T (16 tokens x 8 heads)
//    = K (16 x D) . q^T with mma.sync m16n8k16 (the group's REP query heads
//    fill n = 8), then O^T (D x 8) += V^T . P^T: P leaves the score
//    fragment through movmatrix.trans straight into the B operand. bf16 K
//    and V reach the A operand through ldmatrix (.trans for V) from tiles
//    whose 16-byte chunks are XOR-swizzled by row; int8 K and V are read
//    with 16-byte shared loads in an order chosen so that the contraction
//    runs over a fixed permutation of d (K, matched in q's fragment) and
//    the output rows over a fixed permutation of d (V), and converted to
//    bf16 in registers, exactly (x + 128 as the low byte of 2^23, minus
//    2^23 + 128, rounded to bf16).
//  * One launch, the splits merged on chip. The blocks of a (slot, kv head)
//    form one thread-block cluster (the split count is the cluster size,
//    at most 16). The warps' (m, l, acc) merge in shared memory into the
//    block's partial; block r of the cluster owns a share of the outputs,
//    and every block stores its partial's slice of each share straight
//    into the owner's shared memory (mapa + st.shared::cluster), with its
//    (m, l) per head. After one cluster barrier each block merges its
//    share from its own shared memory and writes o. No partial goes to
//    device memory: no scratch, no fence, no counter. With one split the
//    block writes o directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int SUB = 16;             // tokens a warp takes a step: the MMA's m
constexpr int TILE = SUB * WARPS;   // tokens a block takes a step
constexpr int NH = 8;               // query heads of a group: the MMA's n
constexpr int MAX_SPLITS = 16;      // blocks of a cluster (non-portable > 8)
constexpr unsigned FULL = 0xffffffffu;

template <int D, bool QUANT>
struct Cfg {
  static constexpr int E = QUANT ? 1 : 2;            // bytes an element
  static constexpr int ROW = D * E;                  // bytes a token row
  static constexpr int CPR = ROW / 16;               // 16-byte chunks a row
  static constexpr int KV = SUB * ROW;               // a warp's K (or V)
  static constexpr int SC = QUANT ? SUB * 4 : 0;     // a warp's k (or v) scales
  static constexpr int STAGE = 2 * KV + 2 * SC;
  // bf16: two stages a warp (one sub-tile in flight while one is
  // computed) and 3 blocks an SM at d 128 measured faster than 3, 4 or 6
  // stages at every shape of the port's paths; int8, whose conversions
  // lengthen the compute, three
  static constexpr int STAGES = QUANT ? 3 : 2;
  static constexpr int RING = WARPS * STAGES * STAGE;
  static constexpr int ACC_PITCH = D + 4;            // fp32, per (warp, head)
  // after the ring, in its place: the warps' acc, m and l
  static constexpr int MERGE = (WARPS * NH * ACC_PITCH + 2 * WARPS * NH) * 4;
  static constexpr int WORK = RING > MERGE ? RING : MERGE;
  // beside it, written by the cluster's other blocks: their partials'
  // slices of this block's items (splits x ceil(NH * D / 4 / splits)
  // float4), then their m and l per head
  static constexpr int RECV_ACC = (NH * D / 4 + MAX_SPLITS) * 16;
  static constexpr int SMEM = WORK + RECV_ACC + MAX_SPLITS * NH * 8;
  static_assert(CPR == 4 || CPR == 8 || CPR == 16, "row of 64-256 bytes");
};

struct Params {
  const __nv_bfloat16* q;       // (slots, H, D)
  const char* k_pool;           // (n_blocks, kvh, BS, D) bf16 or int8
  const char* v_pool;
  const float* k_scale;         // (n_blocks, kvh, BS), int8 pools only
  const float* v_scale;
  const int* table;             // (slots, max_blk)
  const int* lengths;           // (slots,)
  __nv_bfloat16* o;             // (slots, H, D)
  int kvh, rep, max_blk, splits, log2_bs;
  float scale;
};

// The XOR swizzle of a row's 16-byte chunks: rows 2m and 2m + 1 differ in
// bit 2 (16-chunk and 8-chunk rows), rows 2m, 2m + 2, 2m + 4, 2m + 6 in bits
// 0-1. Each 8-row ldmatrix, the int8 K loads (rows g, g + 1) and the int8 V
// loads (rows 2t + b) then meet 8 distinct bank groups.
template <int CPR>
__device__ __forceinline__ int swz(int r) {
  return CPR >= 8 ? (((r & 1) << 2) | ((r >> 1) & 3)) : ((r >> 1) & 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile(
      "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(dst),
      "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// every thread of the cluster: release this block's shared-memory writes,
// acquire the other blocks'
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a shared-memory address of this block → the same address in block rank's
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// the first half of a cluster barrier at the kernel's start (this block
// runs), and its second half before the first store into another block
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void st_cluster4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void st_cluster2(uint32_t addr, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n"
               :: "r"(addr), "f"(x), "f"(y) : "memory");
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte b of x, an int8 code held as code + 128 (x = word ^ 0x80808080),
// exactly as fp32: 2^23 + (code + 128) built in the bits, minus 2^23 + 128
__device__ __forceinline__ float i8f(uint32_t x, int b) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 + b)) -
         8388736.f;
}

// 4 consecutive outputs x * scale as bf16, one 8-byte store
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x,
                                       float scale) {
  uint2 v;
  v.x = pack_bf16(x.x * scale, x.y * scale);
  v.y = pack_bf16(x.z * scale, x.w * scale);
  *reinterpret_cast<uint2*>(dst) = v;
}

// Gather one warp's sub-tile: lane r < 16 holds `row` = the pool row of
// token r of the sub-tile (-1 past the length: zero-filled, nothing read).
// An instruction covers 32 / CPR whole rows, one 16-byte chunk a lane (a
// lane pair a row, alternate chunks, measured 1.5x slower: 32-byte pieces
// of 16 rows an instruction).
template <int D, bool QUANT>
__device__ __forceinline__ void issue(const Params& p, unsigned char* st,
                                      int row, int lane) {
  using C = Cfg<D, QUANT>;
  constexpr int RPI = 32 / C::CPR;
  const int c = lane % C::CPR, rsub = lane / C::CPR;
  const uint32_t sk = smem_u32(st), sv = sk + C::KV;
#pragma unroll
  for (int i = 0; i < SUB / RPI; ++i) {
    const int r = i * RPI + rsub;
    const int pr = __shfl_sync(FULL, row, r);
    const long long src = pr < 0 ? 0 : static_cast<long long>(pr) * C::ROW
                                           + c * 16;
    const uint32_t off = r * C::ROW + ((c ^ swz<C::CPR>(r)) * 16);
    cp_async16(sk + off, p.k_pool + src, pr < 0 ? 0 : 16);
    cp_async16(sv + off, p.v_pool + src, pr < 0 ? 0 : 16);
  }
  if constexpr (QUANT) {
    const int r = lane & 15;
    const int pr = __shfl_sync(FULL, row, r);
    const float* src = (lane < 16 ? p.k_scale : p.v_scale) + (pr < 0 ? 0 : pr);
    cp_async4(sk + 2 * C::KV + (lane < 16 ? 0 : C::SC) + r * 4, src,
              pr < 0 ? 0 : 4);
  }
}

// The pool row of token `tok` (lane r < 16 of a sub-tile starting at tok0),
// -1 at or past `end`.
__device__ __forceinline__ int pool_row(const Params& p, const int* trow,
                                        int g, int tok, int end) {
  if (tok >= end) return -1;
  const int bs_mask = (1 << p.log2_bs) - 1;
  const int blk = __ldg(trow + (tok >> p.log2_bs));
  return ((blk * p.kvh + g) << p.log2_bs) + (tok & bs_mask);
}

template <int D, bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const Params p) {
  using C = Cfg<D, QUANT>;
  constexpr int KS = D / 16;           // k-steps of the score product
  extern __shared__ __align__(128) unsigned char smem[];
  if (p.splits > 1) cluster_arrive_relaxed();   // this block runs

  const int split = blockIdx.x, g = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;   // fragment row group, column pair
  const int H = p.kvh * p.rep;
  const int* trow = p.table + static_cast<long long>(s) * p.max_blk;

  // this block's tokens: an equal share of the slot's 64-token tiles
  const int len = min(p.lengths[s], p.max_blk << p.log2_bs);
  const int ntiles = len > 0 ? (len + TILE - 1) / TILE : 0;
  const int t0 = static_cast<int>(static_cast<long long>(split) * ntiles /
                                  p.splits);
  const int t1 = static_cast<int>(static_cast<long long>(split + 1) * ntiles /
                                  p.splits);
  const int end = min(t1 * TILE, len);
  // this warp's sub-tiles: tokens t0 * TILE + warp * SUB + k * TILE
  const int first = t0 * TILE + warp * SUB;
  const int nk = first < end ? (end - first + TILE - 1) / TILE : 0;

  // q's B fragments (n = query head gq of the group, k = d), q * scale
  // rounded to bf16; heads past rep are zero. The int8 path contracts over
  // the permutation of d that its K loads give (see below).
  uint32_t qb[KS][2];
  {
    const bool live = gq < p.rep;
    const __nv_bfloat16* qh =
        p.q + (static_cast<long long>(s) * H + g * p.rep + (live ? gq : 0)) * D;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        int d0;
        if constexpr (QUANT)
          d0 = 16 * (4 * (ks >> 2) + tq) + 4 * (ks & 3) + 2 * half;
        else
          d0 = 16 * ks + 8 * half + 2 * tq;
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(qh + d0);
        const float2 f = __bfloat1622float2(v);
        qb[ks][half] = live ? pack_bf16(f.x * p.scale, f.y * p.scale) : 0u;
      }
    }
  }

  float acc[KS][4];
#pragma unroll
  for (int i = 0; i < KS; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  unsigned char* ring = smem + warp * C::STAGES * C::STAGE;
  // the ring's prologue, then the pool rows of the next sub-tile to issue
  int row = -1;
#pragma unroll
  for (int k = 0; k < C::STAGES - 1; ++k) {
    if (k < nk) {
      row = lane < SUB ? pool_row(p, trow, g, first + k * TILE + lane, end)
                       : -1;
      issue<D, QUANT>(p, ring + k * C::STAGE, row, lane);
    }
    cp_commit();
  }
  {
    const int k = C::STAGES - 1;
    row = (k < nk && lane < SUB)
              ? pool_row(p, trow, g, first + k * TILE + lane, end) : -1;
  }

  // ldmatrix row addresses: K (non-trans) matrices (rows 0-7 | 8-15) x
  // (chunk 2ks | 2ks + 1); V (.trans) (chunk 2i | 2i + 1) x (rows 0-7 | 8-15)
  const int k_r = (lane & 7) + ((lane >> 3) & 1) * 8, k_c = lane >> 4;
  const int v_r = (lane & 7) + ((lane >> 4) & 1) * 8, v_c = (lane >> 3) & 1;

  for (int k = 0; k < nk; ++k) {
    cp_wait<C::STAGES - 2>();
    __syncwarp();   // sub-tile k is in place; sub-tile k - 1 is read
    {
      const int kn = k + C::STAGES - 1;
      if (kn < nk) issue<D, QUANT>(p, ring + (kn % C::STAGES) * C::STAGE,
                                   row, lane);
      cp_commit();
      const int kr = kn + 1;   // read the table for the step after
      row = (kr < nk && lane < SUB)
                ? pool_row(p, trow, g, first + kr * TILE + lane, end) : -1;
    }
    const unsigned char* st = ring + (k % C::STAGES) * C::STAGE;
    const uint32_t sk = smem_u32(st), sv = sk + C::KV;
    const int tok0 = first + k * TILE;

    // scores S^T: rows = tokens (gq, gq + 8), columns = heads (2tq, 2tq + 1)
    // bf16: two chains of products (even and odd k-steps), summed at the
    // end; int8: one chain, its products spaced by the conversions
    float sc[4] = {0.f, 0.f, 0.f, 0.f}, sc2[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (!QUANT) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, sk + k_r * C::ROW + (((2 * ks + k_c) ^ swz<C::CPR>(k_r)) * 16));
        mma(ks & 1 ? sc2 : sc, a, qb[ks][0], qb[ks][1]);
      }
    } else {
      // rows gq and gq + 8, chunks 4j + tq: chunk j's word w holds d
      // 16 (4j + tq) + 4w + 0..3, which k-step 4j + w contracts
#pragma unroll
      for (int j = 0; j < C::CPR / 4; ++j) {
        const int c = 4 * j + tq;
        const uint4 r0 = *reinterpret_cast<const uint4*>(
            st + gq * C::ROW + ((c ^ swz<C::CPR>(gq)) * 16));
        const uint4 r1 = *reinterpret_cast<const uint4*>(
            st + (gq + 8) * C::ROW + ((c ^ swz<C::CPR>(gq + 8)) * 16));
        const uint32_t w0[4] = {r0.x ^ 0x80808080u, r0.y ^ 0x80808080u,
                                r0.z ^ 0x80808080u, r0.w ^ 0x80808080u};
        const uint32_t w1[4] = {r1.x ^ 0x80808080u, r1.y ^ 0x80808080u,
                                r1.z ^ 0x80808080u, r1.w ^ 0x80808080u};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          uint32_t a[4];
          a[0] = pack_bf16(i8f(w0[w], 0), i8f(w0[w], 1));
          a[1] = pack_bf16(i8f(w1[w], 0), i8f(w1[w], 1));
          a[2] = pack_bf16(i8f(w0[w], 2), i8f(w0[w], 3));
          a[3] = pack_bf16(i8f(w1[w], 2), i8f(w1[w], 3));
          mma(sc, a, qb[4 * j + w][0], qb[4 * j + w][1]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[e] += sc2[e];
    float ks0 = 1.f, ks1 = 1.f, vs0 = 1.f, vs1 = 1.f;
    if constexpr (QUANT) {
      const float* kscl = reinterpret_cast<const float*>(st + 2 * C::KV);
      ks0 = kscl[gq];
      ks1 = kscl[gq + 8];
      vs0 = kscl[SUB + gq];
      vs1 = kscl[SUB + gq + 8];
      sc[0] *= ks0;
      sc[1] *= ks0;
      sc[2] *= ks1;
      sc[3] *= ks1;
    }
    if (tok0 + gq >= end) sc[0] = sc[1] = -INFINITY;
    if (tok0 + gq + 8 >= end) sc[2] = sc[3] = -INFINITY;

    // online softmax per head column: the max over the warp's 16 tokens
    float x0 = fmaxf(sc[0], sc[2]), x1 = fmaxf(sc[1], sc[3]);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      x0 = fmaxf(x0, __shfl_xor_sync(FULL, x0, o));
      x1 = fmaxf(x1, __shfl_xor_sync(FULL, x1, o));
    }
    const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
    const float r0 = n0 == -INFINITY ? 0.f : n0;
    const float r1 = n1 == -INFINITY ? 0.f : n1;
    const float c0 = __expf(m0 - r0), c1 = __expf(m1 - r1);
    m0 = n0;
    m1 = n1;
    const float p0 = __expf(sc[0] - r0), p1 = __expf(sc[1] - r1);
    const float p2 = __expf(sc[2] - r0), p3 = __expf(sc[3] - r1);
    l0 = l0 * c0 + (p0 + p2);   // this lane's tokens; summed over lanes last
    l1 = l1 * c1 + (p1 + p3);
    if (__any_sync(FULL, c0 != 1.f || c1 != 1.f)) {   // a head's max moved
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        acc[i][0] *= c0;
        acc[i][1] *= c1;
        acc[i][2] *= c0;
        acc[i][3] *= c1;
      }
    }
    // P^T as P.V's B operand: each 8 x 8 half (tokens x heads) transposed
    const uint32_t pb0 = movmatrix_t(pack_bf16(p0 * vs0, p1 * vs0));
    const uint32_t pb1 = movmatrix_t(pack_bf16(p2 * vs1, p3 * vs1));

    // O^T (d x heads) += V^T . P^T
    if constexpr (!QUANT) {
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        uint32_t a[4];
        ldsm_x4_t(a, sv + v_r * C::ROW + (((2 * i + v_c) ^ swz<C::CPR>(v_r)) * 16));
        mma(acc[i], a, pb0, pb1);
      }
    } else {
      // token rows 2tq, 2tq + 1, 2tq + 8, 2tq + 9; this lane's output rows
      // are D / 8 consecutive d (vdim below), u = 2i (row gq of m-tile i)
      // and 2i + 1 (row gq + 8)
      constexpr int NW = D / 32;   // words of the lane's d range a row
      const unsigned char* vb = st + C::KV;
      uint32_t w[4][NW];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int r = 2 * tq + (rr & 1) + 8 * (rr >> 1);
        if constexpr (C::CPR == 8) {
          const int c = ((gq & 1) << 2) | (gq >> 1);
          const uint4 v = *reinterpret_cast<const uint4*>(
              vb + r * C::ROW + ((c ^ swz<C::CPR>(r)) * 16));
          w[rr][0] = v.x ^ 0x80808080u;
          w[rr][1] = v.y ^ 0x80808080u;
          w[rr][2] = v.z ^ 0x80808080u;
          w[rr][3] = v.w ^ 0x80808080u;
        } else {
          const int c = gq >> 1;
          const uint2 v = *reinterpret_cast<const uint2*>(
              vb + r * C::ROW + ((c ^ swz<C::CPR>(r)) * 16) + (gq & 1) * 8);
          w[rr][0] = v.x ^ 0x80808080u;
          w[rr][1] = v.y ^ 0x80808080u;
        }
      }
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        const int u0 = 2 * i, u1 = 2 * i + 1;
        uint32_t a[4];
        a[0] = pack_bf16(i8f(w[0][u0 >> 2], u0 & 3), i8f(w[1][u0 >> 2], u0 & 3));
        a[1] = pack_bf16(i8f(w[0][u1 >> 2], u1 & 3), i8f(w[1][u1 >> 2], u1 & 3));
        a[2] = pack_bf16(i8f(w[2][u0 >> 2], u0 & 3), i8f(w[3][u0 >> 2], u0 & 3));
        a[3] = pack_bf16(i8f(w[2][u1 >> 2], u1 & 3), i8f(w[3][u1 >> 2], u1 & 3));
        mma(acc[i], a, pb0, pb1);
      }
    }
  }
  cp_wait<0>();

  // the warp's l over its lanes (the max is already warp-uniform)
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    l0 += __shfl_xor_sync(FULL, l0, o);
    l1 += __shfl_xor_sync(FULL, l1, o);
  }
  __syncthreads();   // every warp is done with its ring: reuse it

  // merge the 4 warps: acc[w][h][d] (row pitch D + 4), m and l [w][h]
  float* sAcc = reinterpret_cast<float*>(smem);
  float* sM = sAcc + WARPS * NH * C::ACC_PITCH;
  float* sL = sM + WARPS * NH;
  {
    float* wa = sAcc + warp * NH * C::ACC_PITCH;
    const int h0 = 2 * tq, h1 = 2 * tq + 1;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      int d0, d1;
      if constexpr (QUANT) {
        const int base = C::CPR == 8 ? 16 * (((gq & 1) << 2) | (gq >> 1))
                                     : 16 * (gq >> 1) + 8 * (gq & 1);
        d0 = base + 2 * i;
        d1 = base + 2 * i + 1;
      } else {
        d0 = 16 * i + gq;
        d1 = 16 * i + gq + 8;
      }
      wa[h0 * C::ACC_PITCH + d0] = acc[i][0];
      wa[h1 * C::ACC_PITCH + d0] = acc[i][1];
      wa[h0 * C::ACC_PITCH + d1] = acc[i][2];
      wa[h1 * C::ACC_PITCH + d1] = acc[i][3];
    }
    if (gq == 0) {
      sM[warp * NH + h0] = m0;
      sM[warp * NH + h1] = m1;
      sL[warp * NH + h0] = l0;
      sL[warp * NH + h1] = l1;
    }
  }
  __syncthreads();

  // each warp's weight e^(m_w - M) and the block's M, L, per head
  __shared__ float sWw[WARPS][NH], sBm[NH], sBl[NH];
  if (tid < NH) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sM[w * NH + tid]);
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = mx == -INFINITY ? 0.f : expf(sM[w * NH + tid] - mx);
      sWw[w][tid] = e;
      den += e * sL[w * NH + tid];
    }
    sBm[tid] = mx;
    sBl[tid] = den;
  }
  __syncthreads();
  constexpr int D4 = D / 4;
  const int n4 = p.rep * D4;   // (head, 4 columns) items
  __nv_bfloat16* out = p.o + (static_cast<long long>(s) * H + g * p.rep) * D;
  // block r of the cluster merges items [r per, (r + 1) per): the others
  // store their partials' slices into its shared memory
  const int per = (n4 + p.splits - 1) / p.splits;   // <= 128 items
  float4* recv = reinterpret_cast<float4*>(smem + C::WORK);   // (splits, per)
  float2* recv_ml = reinterpret_cast<float2*>(smem + C::WORK + C::RECV_ACC);
  if (p.splits > 1) cluster_wait();   // every block of the cluster runs
  for (int idx = tid; idx < n4; idx += THREADS) {
    const int h = idx / D4, d4 = idx % D4;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = sWw[w][h];
      const float4 a = *reinterpret_cast<const float4*>(
          sAcc + (w * NH + h) * C::ACC_PITCH + 4 * d4);
      num.x += e * a.x;
      num.y += e * a.y;
      num.z += e * a.z;
      num.w += e * a.w;
    }
    if (p.splits == 1) {
      store4(out + h * D + 4 * d4, num, 1.f / fmaxf(sBl[h], 1e-30f));
    } else {
      const int r = idx / per;
      st_cluster4(map_rank(recv + split * per + (idx - r * per), r), num);
    }
  }
  if (p.splits == 1) return;
  // (m, l) of every head to every block: thread (rank, head)
  for (int t = tid; t < p.splits * NH; t += THREADS) {
    const int r = t / NH, h = t % NH;
    st_cluster2(map_rank(recv_ml + split * NH + h, r), sBm[h], sBl[h]);
  }
  cluster_sync();   // every block's slices and (m, l) are in place

  // o = sum_j e^(m_j - M) acc_j / sum_j e^(m_j - M) l_j over the splits
  const int idx = split * per + tid;
  if (tid < per && idx < n4) {
    const int h = idx / D4, d4 = idx % D4;
    float2 ml[MAX_SPLITS];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      ml[j] = j < p.splits ? recv_ml[j * NH + h]
                           : make_float2(-INFINITY, 0.f);
      mx = fmaxf(mx, ml[j].x);
    }
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    float den = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int j = 0; j < MAX_SPLITS; ++j) {
        if (j >= p.splits || ml[j].x == -INFINITY) continue;
        const float e = expf(ml[j].x - mx);
        const float4 a = recv[j * per + tid];
        den += e * ml[j].y;
        num.x += e * a.x;
        num.y += e * a.y;
        num.z += e * a.z;
        num.w += e * a.w;
      }
    }
    store4(out + h * D + 4 * d4, num, 1.f / fmaxf(den, 1e-30f));
  }
}

template <int D, bool QUANT>
cudaError_t prepare() {
  static bool done = false;   // the attributes are per function, set once
  if (done) return cudaSuccess;
  auto kernel = paged_decode_kernel<D, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<D, QUANT>::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done = err == cudaSuccess;
  return err;
}

template <int D, bool QUANT>
cudaLaunchConfig_t config(int splits, int kvh, int slots, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, kvh, slots);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Cfg<D, QUANT>::SMEM;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int D, bool QUANT>
cudaError_t launch(const Params& p, int slots, cudaStream_t st) {
  cudaError_t err = prepare<D, QUANT>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config<D, QUANT>(p.splits, p.kvh, slots, st, &attr);
  err = cudaLaunchKernelEx(&cfg, paged_decode_kernel<D, QUANT>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D, bool QUANT>
int clusters(int size) {
  if (prepare<D, QUANT>() != cudaSuccess) return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<D, QUANT>(size, 1, 1, 0, &attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, paged_decode_kernel<D, QUANT>,
                                     &cfg) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// Clusters of `size` blocks (1..16) of the kernel for head_dim (64 or 128)
// and pool type (quant: int8) the card holds at once, for the wrapper's
// split count; -1 on an error.
extern "C" int visrag_paged_decode_hopper_clusters(int head_dim, int quant,
                                                   int size) {
  if (size < 1 || size > MAX_SPLITS) return -1;
  if (head_dim == 64) return quant ? clusters<64, true>(size)
                                   : clusters<64, false>(size);
  if (head_dim == 128) return quant ? clusters<128, true>(size)
                                    : clusters<128, false>(size);
  return -1;
}

// Plain C entry point for ctypes. head_dim 64 or 128; block_size a power of
// two up to 128; heads / kv_heads in 1..8; splits (the cluster size) in
// 1..16. k_pool/v_pool bf16, or int8 when k_scale and v_scale (fp32
// (n_blocks, kv_heads, block_size)) are given (null for bf16). Returns a
// cudaError_t (0 = launched).
extern "C" int visrag_paged_decode_hopper(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const int* table,
    const int* lengths, void* o, int slots, int heads, int kv_heads,
    int head_dim, int block_size, int max_blk, int splits, float scale,
    void* stream) {
  if (kv_heads <= 0 || heads % kv_heads || heads / kv_heads > NH ||
      (head_dim != 64 && head_dim != 128) || block_size <= 0 ||
      block_size > 128 || (block_size & (block_size - 1)) || max_blk <= 0 ||
      splits <= 0 || splits > MAX_SPLITS ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return int(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k_pool = static_cast<const char*>(k_pool);
  p.v_pool = static_cast<const char*>(v_pool);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.table = table;
  p.lengths = lengths;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.kvh = kv_heads;
  p.rep = heads / kv_heads;
  p.max_blk = max_blk;
  p.splits = splits;
  p.log2_bs = __builtin_ctz(static_cast<unsigned>(block_size));
  p.scale = scale;
  if (slots <= 0) return int(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool quant = k_scale != nullptr;
  if (head_dim == 64)
    return int(quant ? launch<64, true>(p, slots, st)
                     : launch<64, false>(p, slots, st));
  return int(quant ? launch<128, true>(p, slots, st)
                   : launch<128, false>(p, slots, st));
}

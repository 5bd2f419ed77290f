"""Paged KV cache: a pool of head-major blocks, a block table per slot, and
the decode attention kernel that reads through it (K5).

Counterpart of visrag_tpu/serving/paged_kv.py. K/V live in a block pool of
shape (layers, n_blocks, kv_heads, block_size, d), head-major inside a
block, and each slot owns a list of block ids handed out by
`BlockAllocator`. The JAX package keeps one pool per layer only so that XLA
updates them in place; here every write is an in-place index write into the
one preallocated tensor, and a layer's pool is the view `pool[layer]`.

A pool is a bf16 tensor or a `KVQuant` (Engine(cache_dtype="int8")): int8
data of the same shape plus one fp32 scale per (token, kv head), quantized
on write (`quantize_kv`) and dequantized on read. The helpers here
(`pool_write_rows`, `pool_gather`, `write_prefill`, `write_token`,
`paged_decode_attention`) take either.

`paged_decode_attention` launches csrc/paged_decode_hopper.cu on a CUDA
tensor (one launch: each block takes an equal share of its slot's
64-token tiles, read from the length on the device; a cp.async ring a
warp; the products on the tensor cores; the splits of a (slot, kv head)
one thread-block cluster that merges them in distributed shared memory;
bf16 or int8 pools, head dim 64 or 128, 1-8 query heads a kv head, any
power-of-two block size up to 128; the launch counters `launches` and
`int8_launches` count calls) or raises. `legacy=True` launches the first
kernel, csrc/paged_decode.cu (d = block size = 128; counted in
`legacy_launches`), for timing the two in turns; no path passes it. A CPU
tensor takes `paged_decode_reference`, the plain PyTorch version: the JAX
package's `_xla_paged_decode` for bf16 pools, and for int8 pools the TPU
kernel's own arithmetic (the scales folded into the scores and the
probabilities). `split_bounds` and `paged_decode_schedule_reference` mirror
the kernel's schedule on the host.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List

import torch

SOURCE = "visrag_tpu_torch/csrc/paged_decode_hopper.cu"
LEGACY_SOURCE = "visrag_tpu_torch/csrc/paged_decode.cu"
KERNEL_HEAD_DIMS = (64, 128)     # MiniCPM-2B; Qwen2.5-VL 3B / 7B
KERNEL_BLOCK_SIZES = tuple(2 ** i for i in range(8))   # every gcd(128, ...)
MAX_REP = 8                      # query heads a kv head: the MMA's n
TILE = 64                        # tokens a kernel block takes a step
MAX_SPLITS = 16                  # the blocks of a cluster merge the splits
LEGACY_TARGET_BLOCKS = 264       # csrc/paged_decode.cu: 2 blocks per SM

launches = 0          # K5 on bf16 pools
int8_launches = 0     # K5's int8 variant, on KVQuant pools
legacy_launches = 0   # csrc/paged_decode.cu, reached only with legacy=True


def reset_launch_counts() -> None:
    global launches, int8_launches, legacy_launches
    launches = int8_launches = legacy_launches = 0


class BlockAllocator:
    """Host-side free list over the pool's block ids, with refcounts so
    prompt blocks can be shared read-only across the n decode forks of one
    prompt group."""

    def __init__(self, n_blocks: int):
        self.free: List[int] = list(range(n_blocks - 1, -1, -1))
        self.ref = [0] * n_blocks

    def alloc(self, n: int) -> List[int]:
        if n > len(self.free):
            raise RuntimeError(
                f"KV pool exhausted: need {n} blocks, {len(self.free)} free")
        out = [self.free.pop() for _ in range(n)]
        for b in out:
            self.ref[b] = 1
        return out

    def retain(self, blocks: List[int]) -> None:
        """Add one reference to each block (sharing an allocation)."""
        for b in blocks:
            assert self.ref[b] > 0, f"retain of free block {b}"
            self.ref[b] += 1

    def release(self, blocks: List[int]) -> None:
        """Drop one reference; blocks return to the free list at zero."""
        for b in blocks:
            assert self.ref[b] > 0, f"double release of block {b}"
            self.ref[b] -= 1
            if self.ref[b] == 0:
                self.free.append(b)


@dataclasses.dataclass
class KVQuant:
    """An int8 pool: `data` (..., n_blocks, kvh, bs, d) int8 with
    data[b, g, t] ≈ real / scale, and `scale` (..., n_blocks, kvh, bs) fp32,
    the absmax / 127 of that token's row in kv head g. The JAX package
    stores one layer's scales in row form (n_blocks, 1, kvh * bs); this
    layout holds the same numbers in the same order, and a leading layer
    axis stacks the layers. Indexing and index assignment act on both leaves
    at once, so `pool[layer]` is one layer's KVQuant view and a block copy
    `pool[:, dst] = pool[:, src]` carries the scales with the data."""

    data: torch.Tensor
    scale: torch.Tensor

    def __getitem__(self, idx):
        return KVQuant(self.data[idx], self.scale[idx])

    def __setitem__(self, idx, value: "KVQuant") -> None:
        self.data[idx] = value.data
        self.scale[idx] = value.scale

    @property
    def shape(self):
        return self.data.shape

    @property
    def device(self):
        return self.data.device

    def nbytes(self) -> int:
        return self.data.numel() + 4 * self.scale.numel()


def quantize_kv(x):
    """x (..., d) float → (int8 data, fp32 scale (...,)), per-row absmax /
    127. A zero row gets scale 1 (data all zero), so dequant stays exact."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127,
                    127).to(torch.int8)
    return q, scale


def pool_shape(n_blocks: int, block_size: int, kvh: int, d: int) -> tuple:
    """One layer's pool shape (head-major blocks)."""
    return (n_blocks, kvh, block_size, d)


def tp_head_layout(h: int, kvh: int, tp: int, rank: int):
    """The heads rank `rank` of a tensor-parallel group of `tp` holds:
    (first q head, q heads, first kv head, kv heads). Its q heads are a
    contiguous h / tp; its pools hold the kv heads those q heads read:
    kvh / tp of them where tp divides kvh (the JAX shard_map route), the
    one kv head its q heads share where kvh divides tp (ranks r·kvh/tp ..
    share head r // (tp / kvh); the JAX engine replicates the pools
    there). Any other layout raises ValueError."""
    if tp <= 1:
        return 0, h, 0, kvh
    if h % tp or h % kvh or (kvh % tp and tp % kvh):
        raise ValueError(
            f"tensor parallelism over {tp} ranks needs tp to divide the "
            f"{h} query heads and tp and the {kvh} kv heads to divide one "
            f"another (h={h}, kvh={kvh}, tp={tp})")
    hq = h // tp
    if kvh % tp == 0:
        return rank * hq, hq, rank * (kvh // tp), kvh // tp
    return rank * hq, hq, rank // (tp // kvh), 1


def quant_pool_shapes(n_blocks: int, block_size: int, kvh: int, d: int):
    """(data shape, scale shape) of one layer's KVQuant pool."""
    return (n_blocks, kvh, block_size, d), (n_blocks, kvh, block_size)


def _store(pool, idx, x) -> None:
    """pool[idx] = x (…, d), quantized on write for a KVQuant pool."""
    if isinstance(pool, KVQuant):
        pool[idx] = KVQuant(*quantize_kv(x))
    else:
        pool[idx] = x.to(pool.dtype)


def pool_write_rows(pool, rows, xb) -> None:
    """Write whole head-major blocks xb (nr, kvh, bs, d) at pool rows (nr,)
    of one layer's pool, in place."""
    _store(pool, rows, xb)


def pool_gather(pool, rows, dtype=torch.bfloat16):
    """Pool rows (nr,) of one layer → (nr, kvh, bs, d) in `dtype`,
    dequantized for a KVQuant pool."""
    if isinstance(pool, KVQuant):
        return (pool.data[rows].float()
                * pool.scale[rows][..., None]).to(dtype)
    return pool[rows].to(dtype)


def write_prefill(k_pool, v_pool, k, v, rows, bucket: int) -> None:
    """Scatter prompt K/V into pool blocks, in place. k_pool/v_pool (L,
    n_blocks, kvh, bs, d); k/v (L, K, bucket, kvh, d) from model.prefill;
    rows (K, bucket // bs) or (bucket // bs,) pool block ids."""
    layers, bs = k_pool.shape[0], k_pool.shape[3]
    nb = bucket // bs
    rows = torch.as_tensor(rows, device=k_pool.device).reshape(-1).long()
    kk = k.shape[1]
    for pool, x in ((k_pool, k), (v_pool, v)):
        xb = x.reshape(layers, kk * nb, bs, *x.shape[3:]).transpose(2, 3)
        _store(pool, (slice(None), rows), xb)


def write_token(pool, table, pos, x) -> None:
    """Write one token per slot into one layer's pool (n_blocks, kvh, bs,
    d), in place: x (slots, kvh, d) at logical positions pos (slots,)."""
    bs = pool.shape[2]
    blk = torch.gather(table, 1, (pos // bs)[:, None].to(table.dtype))[:, 0]
    _store(pool, (blk.long(), slice(None), (pos % bs).long()), x)


def _gather_heads(pool, idx):
    """Table rows idx (s, mb) of one layer → (s, kvh, mb*bs, d) data and,
    for KVQuant, (s, kvh, mb*bs) scales."""
    s, mb = idx.shape
    data = pool.data if isinstance(pool, KVQuant) else pool
    _, kvh, bs, d = data.shape
    g = data[idx].transpose(1, 2).reshape(s, kvh, mb * bs, d)
    if not isinstance(pool, KVQuant):
        return g, None
    return g, pool.scale[idx].transpose(1, 2).reshape(s, kvh, mb * bs)


def paged_decode_reference(q, k_pool, v_pool, table, lengths, sm_scale):
    """Plain PyTorch version → (slots, H, d) in q's dtype. bf16 pools: the
    JAX package's `_xla_paged_decode` (fp32 scores, mask at the length,
    softmax, P rounded to the pool's dtype, fp32 accumulation). KVQuant
    pools: the TPU kernel's arithmetic, which K5's int8 variant follows:
    q * sm_scale rounded to bf16, scores of the int8 keys times their k
    scales, the softmax's sum from the unscaled probabilities, the
    probabilities times their v scales rounded to bf16 for P.V."""
    s, h, d = q.shape
    mb = table.shape[1]
    idx = table.long()
    kg, ks = _gather_heads(k_pool, idx)
    vg, vs = _gather_heads(v_pool, idx)
    kvh = kg.shape[1]
    qg = q.reshape(s, kvh, h // kvh, d)
    mask = (torch.arange(mb * k_pool.shape[2], device=q.device)[None, :]
            < lengths.to(q.device)[:, None])[:, None, None, :]
    if ks is None:
        scores = torch.einsum("sgrd,sgld->sgrl", qg.float(),
                              kg.float()) * sm_scale
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        p = torch.softmax(scores, dim=-1)
        o = torch.einsum("sgrl,sgld->sgrd", p.to(vg.dtype).float(),
                         vg.float())
        return o.reshape(s, h, d).to(q.dtype)
    qs = (qg.float() * sm_scale).to(torch.bfloat16).float()
    scores = torch.einsum("sgrd,sgld->sgrl", qs, kg.float()) \
        * ks[:, :, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True)) * mask
    pv = (p * vs[:, :, None, :]).to(torch.bfloat16).float()
    o = torch.einsum("sgrl,sgld->sgrd", pv, vg.float()) \
        / p.sum(dim=-1, keepdim=True)
    return o.reshape(s, h, d).to(q.dtype)




def split_plan(slots: int, kvh: int, max_blk: int, block_size: int,
               clusters) -> int:
    """The kernel's split count, which is its cluster size: the largest c
    up to MAX_SPLITS and one split a TILE-token tile of the table's
    capacity such that the slots * kvh clusters of c blocks run at once
    (`clusters[c - 1]`: how many clusters of c blocks the card holds), so
    the grid is one wave; 1 if none is. It depends on shapes only (never on
    the lengths), so the grid does too."""
    tiles = -(-max_blk * block_size // TILE)
    for c in range(min(MAX_SPLITS, tiles, len(clusters)), 1, -1):
        if slots * kvh <= clusters[c - 1]:
            return c
    return 1


def split_bounds(lengths, max_blk: int, block_size: int, splits: int):
    """The kernel's schedule on the host: (slots, splits, 2) int64 token
    bounds [lo, hi) of each split. A slot's valid tokens (its length,
    clamped to the table's capacity) form ceil(len / TILE) tiles; split j
    takes tiles [j n / splits, (j + 1) n / splits), cut at the length."""
    lens = torch.clamp(torch.as_tensor(lengths).long(), 0,
                       max_blk * block_size)
    n = -(-lens // TILE)
    j = torch.arange(splits + 1)
    edge = (j[None, :] * n[:, None]) // splits * TILE
    edge = torch.minimum(edge, lens[:, None])
    return torch.stack([edge[:, :-1], edge[:, 1:]], dim=-1)


def paged_decode_schedule_reference(q, k_pool, v_pool, table, lengths,
                                    sm_scale, splits: int):
    """Plain mirror of the kernel's schedule over float pools: each split's
    (m, l, acc) in fp32 over its tokens of `split_bounds`, every token read
    through its own table entry (table[s, t // bs], row t % bs), then the
    merge the cluster of a (slot, kv head) does: w_j = e^(m_j - M) / L.
    → (out (slots, H, d) fp32, m (slots, kvh, splits, rep), l (same), acc
    (slots, kvh, splits, rep, d))."""
    s, h, d = q.shape
    _, kvh, bs, _ = k_pool.shape
    rep = h // kvh
    bounds = split_bounds(lengths, table.shape[1], bs, splits)
    m = torch.full((s, kvh, splits, rep), -math.inf)
    l = torch.zeros((s, kvh, splits, rep))
    acc = torch.zeros((s, kvh, splits, rep, d))
    qg = q.float().reshape(s, kvh, rep, d)
    for i in range(s):
        for j in range(splits):
            lo, hi = (int(x) for x in bounds[i, j])
            if hi <= lo:
                continue
            tok = torch.arange(lo, hi)
            blk = table[i, tok // bs].long()
            kr = k_pool[blk, :, tok % bs].float()      # (n, kvh, d)
            vr = v_pool[blk, :, tok % bs].float()
            sc = torch.einsum("grd,ngd->grn", qg[i], kr) * sm_scale
            mj = sc.amax(dim=-1)
            p = torch.exp(sc - mj[..., None])
            m[i, :, j], l[i, :, j] = mj, p.sum(-1)
            acc[i, :, j] = torch.einsum("grn,ngd->grd", p, vr)
    big = m.amax(dim=2, keepdim=True)
    w = torch.where(m == -math.inf, torch.zeros_like(m),
                    torch.exp(m - torch.where(big == -math.inf,
                                              torch.zeros_like(big), big)))
    den = (w * l).sum(dim=2, keepdim=True)
    w = w / torch.clamp(den, min=1e-30)
    out = (w[..., None] * acc).sum(dim=2).reshape(s, h, d)
    return out, m, l, acc


def _check_args(q, k_pool, v_pool, table, lengths):
    """Shapes, dtypes, contiguity and device of a CUDA call; raises on what
    no kernel takes. → (pointers of k, v, k scale, v scale)."""
    quant = isinstance(k_pool, KVQuant)
    pool_dtype = torch.int8 if quant else torch.bfloat16
    tensors = [("q", q, torch.bfloat16)]
    if quant:
        tensors += [("k_pool.data", k_pool.data, pool_dtype),
                    ("v_pool.data", v_pool.data, pool_dtype),
                    ("k_pool.scale", k_pool.scale, torch.float32),
                    ("v_pool.scale", v_pool.scale, torch.float32)]
    else:
        tensors += [("k_pool", k_pool, pool_dtype),
                    ("v_pool", v_pool, pool_dtype)]
    tensors += [("table", table, torch.int32),
                ("lengths", lengths, torch.int32)]
    for name, t, dtype in tensors:
        if t.dtype != dtype or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                             f"{q.device}")
    if quant:
        return (k_pool.data.data_ptr(), v_pool.data.data_ptr(),
                k_pool.scale.data_ptr(), v_pool.scale.data_ptr())
    return k_pool.data_ptr(), v_pool.data_ptr(), None, None


@functools.lru_cache(maxsize=None)
def _hopper_fn():
    """The kernel's C entry point, its ctypes signature set once."""
    from ..ops._build import load_library
    fn = load_library("paged_decode_hopper").visrag_paged_decode_hopper
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _legacy_fn():
    from ..ops._build import load_library
    fn = load_library("paged_decode").visrag_paged_decode
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _occupancy(device_index: int, d: int, quant: bool):
    """How many clusters of 1..MAX_SPLITS kernel blocks the device holds at
    once, read once per (device, head dim, pool type)."""
    from ..ops._build import load_library
    query = load_library("paged_decode_hopper") \
        .visrag_paged_decode_hopper_clusters
    query.restype = ctypes.c_int
    query.argtypes = [ctypes.c_int] * 3
    with torch.cuda.device(device_index):
        out = tuple(query(d, int(quant), c) for c in range(1, MAX_SPLITS + 1))
    if min(out) < 0:
        raise RuntimeError("paged decode kernel: occupancy query failed")
    return out


def _legacy_split_plan(slots: int, kvh: int, max_blk: int):
    """(splits, blocks_per_split) of csrc/paged_decode.cu: the table's
    columns cut into equal runs so that slots * kvh * splits partial blocks
    come near LEGACY_TARGET_BLOCKS."""
    want = max(1, min(max_blk,
                      -(-LEGACY_TARGET_BLOCKS // (slots * kvh))))
    per = -(-max_blk // want)
    return -(-max_blk // per), per


def _launch_legacy(q, k_pool, v_pool, table, lengths, sm_scale, ptrs):
    """csrc/paged_decode.cu: d = block size = 128, at most 8 query heads a
    kv head; two kernels (partials, then their combine)."""
    global legacy_launches
    s, h, d = q.shape
    _, kvh, bs, _ = k_pool.shape
    if d != 128 or bs != 128 or h // kvh > MAX_REP:
        raise ValueError(f"the legacy paged decode kernel takes head_dim "
                         f"128, block size 128 and at most {MAX_REP} query "
                         f"heads per kv head; got d={d}, bs={bs}, "
                         f"{h}/{kvh} heads")
    mb, rep = table.shape[1], h // kvh
    splits, per = _legacy_split_plan(s, kvh, mb)
    part_o = torch.empty((s, kvh, splits, rep, d), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((s, kvh, splits, rep, 2), dtype=torch.float32,
                          device=q.device)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _legacy_fn()(q.data_ptr(), *ptrs, table.data_ptr(),
                          lengths.data_ptr(), part_o.data_ptr(),
                          part_ml.data_ptr(), o.data_ptr(), s, h, kvh, d, bs,
                          mb, splits, per, float(sm_scale),
                          torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"legacy paged decode kernel launch failed: CUDA "
                           f"error {rc}")
    legacy_launches += 1
    return o


def paged_decode_attention(q, k_pool, v_pool, table, lengths, sm_scale=None,
                           *, legacy: bool = False):
    """q (slots, H, d); k_pool/v_pool one layer's (n_blocks, kvh, bs, d)
    pools, bf16 or KVQuant; table (slots, max_blk) int32 pool rows; lengths
    (slots,) int32 INCLUDING the current token (>= 1). → (slots, H, d).
    `legacy` launches csrc/paged_decode.cu instead, for timing the two in
    turns; nothing on a path passes it."""
    s, h, d = q.shape
    _, kvh, bs, dk = k_pool.shape
    quant = isinstance(k_pool, KVQuant)
    if quant != isinstance(v_pool, KVQuant):
        raise ValueError("k_pool and v_pool must both be KVQuant or neither")
    if v_pool.shape != k_pool.shape or dk != d or h % kvh \
            or table.shape[0] != s or lengths.shape != (s,):
        raise ValueError(f"paged decode shapes: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)} {tuple(v_pool.shape)}, "
                         f"table {tuple(table.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pool, v_pool, table, lengths,
                                      sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k_pool, v_pool, table, lengths, sm_scale, legacy)


def _launch(q, k_pool, v_pool, table, lengths, sm_scale, legacy=False):
    """The CUDA side of paged_decode_attention (shapes already checked):
    the argument checks, the split plan, one launch. Raises on what the
    kernel does not take; never falls back."""
    global launches, int8_launches
    s, h, d = q.shape
    _, kvh, bs, _ = k_pool.shape
    quant = isinstance(k_pool, KVQuant)
    ptrs = _check_args(q, k_pool, v_pool, table, lengths)
    if legacy:
        return _launch_legacy(q, k_pool, v_pool, table, lengths, sm_scale,
                              ptrs)
    if d not in KERNEL_HEAD_DIMS or bs not in KERNEL_BLOCK_SIZES \
            or h // kvh > MAX_REP or table.shape[1] < 1:
        raise ValueError(f"the paged decode kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, a power-of-two block size up "
                         f"to 128 and at most {MAX_REP} query heads per kv "
                         f"head; got d={d}, bs={bs}, {h}/{kvh} heads, table "
                         f"{tuple(table.shape)}")
    dev = q.device
    splits = split_plan(s, kvh, table.shape[1], bs,
                        _occupancy(dev.index, d, quant))
    o = torch.empty_like(q)
    with torch.cuda.device(dev):
        rc = _hopper_fn()(
            q.data_ptr(), *ptrs, table.data_ptr(), lengths.data_ptr(),
            o.data_ptr(), s, h, kvh, d, bs, table.shape[1], splits,
            float(sm_scale), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged decode kernel launch failed: CUDA error "
                           f"{rc}")
    if quant:
        int8_launches += 1
    else:
        launches += 1
    return o

"""Segment-id flash attention (K4), the public `flash_attention`, and the
chunked-prefill attention (K8).

Counterpart of visrag_tpu/ops/attention.py.

  * K4 replaces the TPU kernels `_fwd_kernel`, `_dq_kernel` and
    `_dkv_kernel` (`_flash_core` and its custom VJP) and the library detour
    `_flash_library_segment`: one forward kernel that also writes the
    log-sum-exp, one dq kernel (it also stores delta = rowsum(o*do)) and one
    dk/dv kernel, launched in that order. At every head dim the port runs
    (64, 80, 128) all three are csrc/attention_segment_hopper.cu (wgmma
    from shared memory that TMA fills, one producer warp and two consumer
    warpgroups; 128-row forward and dq tiles; dk/dv in 64-key blocks whose
    warpgroups split dV and dK at d 64 / 128, in 128-key blocks of a
    warpgroup a 64-key tile at d 80; tile pairs classed skipped / unmasked
    / masked by a pre-pass). csrc/attention_segment.cu (mma.sync, 64-row
    tiles, cp.async), the first kernels, is reached only with
    `legacy=True`, to time one against the other. Both are CUDA C++ for
    sm_90a bound with ctypes. With `sorted_ids` (K3's backward: ascending
    runs, pad after them) dq and dk/dv find the band of tiles a block can
    meet by a search over the pre-pass's classes instead of walking every
    tile. Scores and accumulators
    stay in registers; K/V (or Q/dO) stream through shared memory, so any
    length runs and the JAX package's `_pick_blocks` and 4096-key bound
    have no counterpart here. Grouped kv heads are read through strides,
    and dk/dv sum over a group inside one block, without atomics.
  * `flash_attention` has the JAX function's dispatch: `lengths` goes to
    the valid-length kernels (ops/attention_lengths.py, K1/K2), segment ids
    go to K4; no ids at a head dim K4 does not compile (d = 72, Sq == Sk)
    go to K1/K2 with full lengths.
  * `chunk_attention` (`xla_chunk_attention`): the chunked-prefill
    attention, a chunk's queries at a global offset over the gathered
    prefix. The JAX package runs it as plain XLA, not as a Pallas kernel;
    on the card it is K8, csrc/attention_chunk_hopper.cu, the Hopper
    forward body with a closed-form mask at the query offset
    (`chunk_pair_classes_reference` is its tile classes' plain version),
    and `chunk_attention_reference` is its plain version.

The segment contract. q (B, Sq, H, D), k/v (B, Sk, H_kv, D) with H_kv
dividing H, ids (B, Sq) and (B, Sk) ints in any order. A (query, key) pair
is visible iff the ids are equal AND POSITIVE (and, when causal, key index
<= query index). Ids <= 0 mark padding and match nothing, on either side:
their output rows are exactly 0, their LSE is LSE_PAD, and their dq, dk
and dv are exactly 0 whatever `do` holds. The same holds for a positive-id
row that sees no key. On valid rows the result equals the JAX function's;
the JAX oracle `mha_reference` lets id-0 rows attend id-0 keys instead
(finite values that every caller masks).

A CPU tensor takes `segment_attention_reference`, the plain PyTorch
version, and autograd through it is the plain backward. A CUDA tensor
launches the kernels or raises; there is no fallback. Launch counters, one
per kernel: `seg_fwd_launches`, `seg_dq_launches`, `seg_dkv_launches`;
`route_counts()` splits each kernel's launches by source; `chunk_launches`
counts K8's.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from .attention_lengths import KERNEL_HEAD_DIMS, LOG2E, LSE_PAD, \
    _check_cuda, _stream, _strides, _wants_grad

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
SEG_HEAD_DIMS = (64, 80, 128)   # MiniCPM LM, Qwen vision tower, Qwen text
HOPPER_HEAD_DIMS = (64, 80, 128)   # forward, dq and dk/dv on wgmma + TMA
SOURCE = "visrag_tpu_torch/csrc/attention_segment.cu"
HOPPER_SOURCE = "visrag_tpu_torch/csrc/attention_segment_hopper.cu"
# (query rows, keys) per tile of each kernel's classes; the pre-pass classes
# tiles of these sizes (dq's 128-row blocks class each 64-row half, so dq
# and dk/dv take the same classes)
HOPPER_TILES = {"fwd": (128, 128), "dq": (64, 64), "dkv": (64, 64)}
LEGACY_TILES = (64, 64)
_LEGACY_ENTRY = {"fwd": "visrag_segment_attention_fwd",
                 "dq": "visrag_segment_attention_bwd_dq",
                 "dkv": "visrag_segment_attention_bwd_dkv"}
SKIP, MASKED, UNMASKED = 0, 1, 2    # classes of a (query tile, key tile) pair
CHUNK_SOURCE = "visrag_tpu_torch/csrc/attention_chunk_hopper.cu"
CHUNK_HEAD_DIMS = (128,)            # K8: the Qwen2.5 text stack
CHUNK_TILES = (128, 128)            # K8's (query rows, keys) per tile

seg_fwd_launches = 0    # K4 forward, by segment_fwd
seg_dq_launches = 0     # K4 dq, by segment_bwd_dq
seg_dkv_launches = 0    # K4 dk/dv, by segment_bwd_dkv
chunk_launches = 0      # K8, by chunk_attention on a CUDA tensor
_routes = {kind: {"hopper": 0, "legacy": 0} for kind in _LEGACY_ENTRY}


def reset_launch_counts() -> None:
    global seg_fwd_launches, seg_dq_launches, seg_dkv_launches, \
        chunk_launches
    seg_fwd_launches = seg_dq_launches = seg_dkv_launches = 0
    chunk_launches = 0
    for counts in _routes.values():
        counts["hopper"] = counts["legacy"] = 0


def launch_counts() -> dict:
    return {"seg_fwd": seg_fwd_launches, "seg_dq": seg_dq_launches,
            "seg_dkv": seg_dkv_launches}


def route_counts() -> dict:
    """The wrappers' launches of each K4 kernel ("fwd", "dq", "dkv") by
    source: "hopper" (csrc/attention_segment_hopper.cu) or "legacy" (the
    mma.sync csrc/attention_segment.cu, which no caller of the port
    reaches)."""
    return {kind: dict(counts) for kind, counts in _routes.items()}


def _group(q, kvh):
    """(B, S, H, D) → (B, S, kvh, H // kvh, D): query head h belongs to kv
    head h // (H // kvh)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, kvh, h // kvh, d)


def _visible(q_seg, kv_seg, causal, r0=0, r1=None):
    """(B, r1 - r0, Sk) bool for query rows [r0, r1): equal positive ids,
    key index <= query index when causal."""
    r1 = q_seg.shape[1] if r1 is None else r1
    qs = q_seg[:, r0:r1, None]
    allow = (qs == kv_seg[:, None, :]) & (qs > 0)
    if causal:
        sk = kv_seg.shape[1]
        allow = allow & (torch.arange(r0, r1, device=q_seg.device)[:, None]
                         >= torch.arange(sk, device=q_seg.device)[None, :])
    return allow


def segment_attention_reference(q, k, v, q_seg=None, kv_seg=None, *,
                                causal=False, sm_scale=None,
                                rows: int = 1024):
    """Plain PyTorch version of K4's forward: q (B, Sq, H, D), k/v (B, Sk,
    H_kv, D); a pair attends iff the ids are equal and positive (and, when
    causal, key <= query). Rows that see no key are zeros. fp32 math, → q's
    dtype. Queries go `rows` at a time, so the score buffer stays (B, H,
    rows, Sk). Differentiable: autograd through it is the plain backward."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    q_seg = _ids(q_seg, b, sq, q.device)
    kv_seg = _ids(kv_seg, b, sk, q.device)
    kf, vf = k.float(), v.float()
    out = []
    for r0 in range(0, sq, rows):
        allow = _visible(q_seg, kv_seg, causal, r0, min(r0 + rows, sq))
        scores = torch.einsum("bqgrd,bkgd->bgrqk",
                              _group(q[:, r0:r0 + rows].float(), kvh),
                              kf) * sm_scale
        scores = scores.masked_fill(~allow[:, None, None], MASK_VALUE)
        p = torch.softmax(scores, dim=-1)
        p = p * allow.any(-1)[:, None, None, :, None]
        out.append(torch.einsum("bgrqk,bkgd->bqgrd", p, vf)
                   .reshape(b, -1, h, d))
    return torch.cat(out, dim=1).to(q.dtype)


def segment_backward_reference(q, k, v, do, q_seg, kv_seg, causal: bool,
                               sm_scale: float, rows: int = 1024,
                               sorted_ids: bool = False):
    """Plain PyTorch version of K4's backward, written out (the formulas of
    the kernels' header, fp32, `rows` queries at a time) so that a long row
    never holds a (Sq, Sk) plane per head: → (dq, dk, dv) fp32. Equal to
    autograd through `segment_attention_reference`. `sorted_ids` (ascending
    runs, pad after them) takes each chunk's keys from the kernels' sorted
    walk (`sorted_walk_reference` over 64-row tiles) instead of all Sk:
    the same result, since the keys it leaves out are invisible."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    dq = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    if sorted_ids:
        tile = HOPPER_TILES["dq"][1]
        first, end = sorted_walk_reference(
            segment_tile_classes_reference(q_seg, tile),
            segment_tile_classes_reference(kv_seg, tile))
        rows = -(-rows // tile) * tile
    for r0 in range(0, sq, rows):
        r1 = min(r0 + rows, sq)
        k0, k1 = 0, sk
        if sorted_ids:
            walk = end[:, r0 // tile:-(-r1 // tile)] > 0
            if not bool(walk.any()):
                continue
            k0 = int(first[:, r0 // tile:-(-r1 // tile)][walk].min()) * tile
            k1 = min(sk, int(end[:, r0 // tile:-(-r1 // tile)].max()) * tile)
        allow = _visible(q_seg, kv_seg, causal, r0, r1)[:, None, None, :,
                                                          k0:k1]
        kb, vb = kf[:, k0:k1], vf[:, k0:k1]
        qg = _group(q[:, r0:r1].float(), kvh)               # (B,q,g,r,D)
        dog = _group(do[:, r0:r1].float(), kvh)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kb) * sm_scale
        s = s.masked_fill(~allow, float("-inf"))
        p = torch.softmax(s, dim=-1).nan_to_num(0.0)        # no key: zeros
        o = torch.einsum("bgrqk,bkgd->bqgrd", p, vb)
        delta = (o * dog).sum(-1).permute(0, 2, 3, 1)       # (B,g,r,q)
        dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, vb)
        ds = p * (dp - delta[..., None])
        dq[:, r0:r1] = (torch.einsum("bgrqk,bkgd->bqgrd", ds, kb)
                        * sm_scale).reshape(b, r1 - r0, h, d)
        dk[:, k0:k1] += torch.einsum("bgrqk,bqgrd->bkgd", ds, qg) * sm_scale
        dv[:, k0:k1] += torch.einsum("bgrqk,bqgrd->bkgd", p, dog)
    return dq, dk, dv


def chunk_attention_reference(q, k_all, v_all, start, *, sm_scale=None,
                              kv_block: int = 1024):
    """Plain PyTorch version of K8: q (B, C, H, D) at global positions
    start + arange(C) (start (B,) int); k_all/v_all (B, L, H_kv, D) cover
    [0, L) with this chunk already written. Mask: key <= start + query.
    fp32 scores and online softmax over kv_block-key blocks; P rounded to
    the cache's dtype for P.V with fp32 accumulation. → (B, C, H, D)."""
    b, cq, h, d = q.shape
    L, kvh = k_all.shape[1], k_all.shape[2]
    rep = h // kvh
    if sm_scale is None:
        sm_scale = d ** -0.5
    q32 = _group(q.float() * sm_scale, kvh)                 # (B,C,g,r,D)
    qpos = start.to(q.device).long()[:, None] \
        + torch.arange(cq, device=q.device)[None]           # (B, C)
    m = torch.full((b, kvh, rep, cq), float("-inf"), device=q.device)
    l = torch.zeros((b, kvh, rep, cq), device=q.device)
    acc = torch.zeros((b, kvh, rep, cq, d), device=q.device)
    for base in range(0, L, kv_block):
        kb = k_all[:, base:base + kv_block]
        vb = v_all[:, base:base + kv_block]
        s = torch.einsum("bqgrd,bkgd->bgrqk", q32, kb.float())
        ki = base + torch.arange(kb.shape[1], device=q.device)
        allow = (ki[None, None, :] <= qpos[:, :, None])[:, None, None]
        s = torch.where(allow, s, torch.full_like(s, MASK_VALUE))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(allow, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]          # (B,g,r,C,D)
    return o.permute(0, 3, 1, 2, 4).reshape(b, cq, h, d).to(q.dtype)


def chunk_pair_classes_reference(start, c: int, L: int, bq: int, bk: int):
    """Plain version of K8's tile classes: start (B,) int → (B, ceil(c /
    bq), ceil(L / bk)) int32, per (query tile at q0, key tile at k0) SKIP
    when k0 > start + q0 + bq - 1, UNMASKED when k0 + bk - 1 <= start + q0
    and k0 + bk <= L, MASKED otherwise (the kernel masks those per element
    on key <= start + query and key < L)."""
    st = torch.as_tensor(start).long()[:, None, None]
    q0 = torch.arange(0, c, bq)[None, :, None]
    k0 = torch.arange(0, L, bk)[None, None, :]
    skip = k0 > st + q0 + bq - 1
    full = (k0 + bk - 1 <= st + q0) & (k0 + bk <= L)
    out = torch.full(skip.shape, MASKED, dtype=torch.int32)
    out[full] = UNMASKED
    out[skip] = SKIP
    return out


def _launch_chunk(q, k_all, v_all, starts, o, sm_scale):
    """K8 into `o`: q / o (B, C, H, D), k_all / v_all (B, L, H_kv, D), bf16
    views with a contiguous head dim and 16-byte-aligned strides; starts
    (B,) int32 on the card. Raises unless the kernel launched."""
    from ._build import load_library
    for name, t in (("q", q), ("k_all", k_all), ("v_all", v_all), ("o", o)):
        _check_cuda(name, t)
    b, cq, h, d = q.shape
    L, kvh = k_all.shape[1], k_all.shape[2]
    fn = load_library("attention_chunk_hopper").visrag_chunk_hopper_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
                o.data_ptr(), starts.data_ptr(), b, cq, L, h, kvh, d,
                *_strides(q, k_all, v_all, o), float(sm_scale) * LOG2E,
                _stream(q))
    if rc == -1:
        raise RuntimeError(f"attention_chunk_hopper: the driver refused a "
                           f"TMA tensor map for q {tuple(q.shape)} strides "
                           f"{q.stride()}, k {tuple(k_all.shape)} strides "
                           f"{k_all.stride()}")
    if rc != 0:
        raise RuntimeError(f"attention_chunk_hopper launch failed: CUDA "
                           f"error {rc}")


def chunk_attention(q, k_all, v_all, start, *, sm_scale=None):
    """Chunked-prefill attention: q (B, C, H, D) at global positions
    start + arange(C) (start (B,) int); k_all/v_all (B, L, H_kv, D) cover
    [0, L) with this chunk already written (L >= start + C). Key j is
    visible to query i iff j <= start + i; query head h reads kv head
    h // (H / H_kv). → (B, C, H, D) in q's dtype.

    A CPU tensor takes `chunk_attention_reference`; a CUDA tensor launches
    K8 (bf16, d 128) or raises. Under a profiler each call records the
    counter `attention.chunk` (heads, kv heads, d, C, L, starts), the
    starts as an int32 copy of its own."""
    if q.dim() != 4 or k_all.dim() != 4 or v_all.shape != k_all.shape \
            or k_all.shape[0] != q.shape[0] or k_all.shape[3] != q.shape[3] \
            or k_all.shape[2] == 0 or q.shape[2] % k_all.shape[2]:
        raise ValueError(f"q (B, C, H, D) and k/v (B, L, H_kv, D) with H_kv "
                         f"dividing H expected, got {tuple(q.shape)} "
                         f"{tuple(k_all.shape)} {tuple(v_all.shape)}")
    b, cq, h, d = q.shape
    L, kvh = k_all.shape[1], k_all.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    starts = torch.as_tensor(start).reshape(-1)
    if starts.shape != (b,):
        raise ValueError(f"start {tuple(starts.shape)} != ({b},)")
    if profiling.recording():
        # a copy, on the device: recorded() reads it after the sync, and a
        # caller may reuse its own start buffer meanwhile
        profiling.count("attention.chunk", (h, kvh, d, cq, L, starts.to(
            device=q.device, dtype=torch.int32, copy=True)))
    if q.device.type == "cpu":
        return chunk_attention_reference(q, k_all, v_all, starts,
                                          sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if d not in CHUNK_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not compiled into the chunk kernel "
                         f"(have {CHUNK_HEAD_DIMS})")
    global chunk_launches
    starts = starts.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty((b, cq, h, d), dtype=q.dtype, device=q.device)
    _launch_chunk(q, k_all, v_all, starts, o, sm_scale)
    chunk_launches += 1
    return o


def segment_lse_reference(q, k, q_seg, kv_seg, causal: bool, sm_scale: float):
    """Plain version of K4's LSE: (B, H, Sq) fp32 natural-log log-sum-exp of
    each row's visible scores; LSE_PAD for a row that sees no key."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    allow = _visible(q_seg, kv_seg, causal)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", _group(q.float(), kvh),
                          k.float()).reshape(b, h, sq, -1) * sm_scale
    scores = scores.masked_fill(~allow[:, None], float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    return torch.where(allow.any(-1)[:, None], lse,
                       torch.full_like(lse, LSE_PAD))


def _route(kind, d, legacy=False):
    """→ (library, entry point, (query rows, keys) per tile) of K4's `kind`
    kernel ("fwd", "dq", "dkv") at head dim d: the wgmma kernels at d in
    HOPPER_HEAD_DIMS, else the mma.sync ones. `legacy` selects the mma.sync
    kernel at any d (to time one against the other); the port's callers
    never set it."""
    if d in HOPPER_HEAD_DIMS and not legacy:
        return ("attention_segment_hopper", f"visrag_segment_hopper_{kind}",
                HOPPER_TILES[kind])
    return "attention_segment", _LEGACY_ENTRY[kind], LEGACY_TILES


def segment_tile_classes_reference(seg, tile: int):
    """Plain version of the kernels' pre-pass: seg (B, S) int → (B,
    ceil(S / tile), 3) int32 rows (lo, hi, uniform): the least and greatest
    positive id of each tile of `tile` rows ((2**31 - 1, 0) when it has
    none) and 1 when every row holds the same positive id (rows past S
    count as pad)."""
    b, s = seg.shape
    n = -(-s // tile)
    ids = torch.zeros((b, n * tile), dtype=torch.int64, device=seg.device)
    ids[:, :s] = seg
    ids = ids.reshape(b, n, tile)
    pos = ids > 0
    big = torch.iinfo(torch.int32).max
    lo = torch.where(pos, ids, torch.full_like(ids, big)).amin(-1)
    hi = torch.where(pos, ids, torch.zeros_like(ids)).amax(-1)
    uniform = pos.all(-1) & (lo == hi)
    return torch.stack([lo, hi, uniform.long()], -1).to(torch.int32)


def segment_pair_classes_reference(q_cls, k_cls, bq: int, bk: int,
                                   causal: bool):
    """(B, nq, nk) class of each (query tile, key tile) pair from the tile
    classes of segment_tile_classes_reference at bq and bk rows: SKIP when
    the id ranges cannot meet or (causal) the key tile lies wholly after the
    query tile; UNMASKED when both tiles are uniform with the same id and
    (causal) the key tile ends at or before the query tile's first row;
    MASKED otherwise. The kernels' `pair_class` is the same."""
    qc, kc = q_cls[:, :, None].long(), k_cls[:, None, :].long()
    q0 = torch.arange(q_cls.shape[1], device=q_cls.device)[:, None] * bq
    k0 = torch.arange(k_cls.shape[1], device=q_cls.device)[None, :] * bk
    meet = (qc[..., 0] <= kc[..., 1]) & (kc[..., 0] <= qc[..., 1])
    full = (qc[..., 2] == 1) & (kc[..., 2] == 1) & (qc[..., 0] == kc[..., 0])
    if causal:
        meet = meet & (k0 <= q0 + bq - 1)
        full = full & (k0 + bk - 1 <= q0)
    out = torch.full(meet.shape, MASKED, dtype=torch.int32,
                     device=q_cls.device)
    out[full] = UNMASKED
    out[~meet] = SKIP
    return out


def segment_dq_pair_classes_reference(q_seg, kv_seg, causal: bool):
    """Plain version of the Hopper dq kernel's walk: (B, ceil(Sq / 128), 2,
    ceil(Sk / 64)) int32, the class that warpgroup w of the 128-row query
    block gives 64-key tile t, SKIP past the block's walk. Each warpgroup
    classes its 64 rows as segment_pair_classes_reference does at the
    pre-pass's 64 / 64 tiles (rows past Sq are pad); a block whose rows all
    hold ids <= 0 walks nothing (it stores zeros); a causal block walks the
    key tiles below ceil(min(q0 + 128, Sq) / 64). A key tile both
    warpgroups skip is not loaded."""
    b, sq = q_seg.shape
    bq, bk = HOPPER_TILES["dq"]
    q_cls = segment_tile_classes_reference(q_seg, bq)
    cls = segment_pair_classes_reference(
        q_cls, segment_tile_classes_reference(kv_seg, bk), bq, bk, causal)
    nblk, nk = -(-sq // (2 * bq)), cls.shape[2]
    out = torch.full((b, 2 * nblk, nk), SKIP, dtype=torch.int32,
                     device=cls.device)
    out[:, :cls.shape[1]] = cls
    out = out.reshape(b, nblk, 2, nk)
    live = torch.zeros((b, 2 * nblk), dtype=torch.bool, device=cls.device)
    live[:, :q_cls.shape[1]] = q_cls[..., 1] > 0
    out[~live.reshape(b, nblk, 2).any(-1)] = SKIP
    if causal:
        for j in range(nblk):
            end = min((j + 1) * 2 * bq, sq)
            out[:, j, :, -(-end // bk):] = SKIP
    return out


def sorted_walk_reference(q_cls, k_cls):
    """Plain version of the Hopper dq's and dk/dv's walk on sorted ids
    (`locate` in csrc/attention_segment_hopper.cu): from the pre-pass's
    classes of the walking side's tiles (q_cls (B, n, 3): lo, hi, uniform)
    and of the walked side's (k_cls (B, m, 3)), → two (B, n) int64 tensors,
    each walking tile's first walked tile (those whose hi is positive and
    below its lo come before it) and the tile after its last (those whose
    lo is within its hi). On ascending runs with pad after them both are
    prefix counts, which the kernels find by a 32-way search. A pad tile
    ((2**31 - 1, 0)) walks nothing: (m_real, 0)."""
    lo, hi = q_cls[..., 0].long(), q_cls[..., 1].long()
    klo, khi = k_cls[..., 0].long(), k_cls[..., 1].long()
    first = ((khi[:, None, :] > 0) & (khi[:, None, :] < lo[:, :, None])).sum(2)
    end = (klo[:, None, :] <= hi[:, :, None]).sum(2)
    return first, end


def segment_tile_classes(seg, tile: int):
    """The kernels' pre-pass on its own: seg (B, S) int32 → (B, ceil(S /
    tile), 3) int32 as segment_tile_classes_reference, which a CPU tensor
    runs. Launches no attention kernel and counts nothing."""
    if seg.device.type == "cpu":
        return segment_tile_classes_reference(seg, tile)
    from ._build import load_library
    if seg.dtype != torch.int32 or not seg.is_contiguous() or seg.dim() != 2:
        raise ValueError("segment ids must be a contiguous (B, S) int32 "
                         "tensor")
    b, s = seg.shape
    out = torch.empty((b, -(-s // tile), 4), dtype=torch.int32,
                      device=seg.device)
    fn = load_library("attention_segment_hopper").visrag_segment_tile_classes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    with torch.cuda.device(seg.device):
        rc = fn(seg.data_ptr(), b, s, tile, out.data_ptr(), _stream(seg))
    if rc != 0:
        raise RuntimeError(f"segment_tile_classes launch failed: CUDA error "
                           f"{rc}")
    return out[..., :3]


def _check_segment(q, k, v, q_seg, kv_seg):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"q (B, Sq, H, D) and k/v (B, Sk, H_kv, D) with H_kv "
                         f"dividing H expected, got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    b, sq = q.shape[:2]
    if tuple(q_seg.shape) != (b, sq) or tuple(kv_seg.shape) != (b, k.shape[1]):
        raise ValueError(f"segment ids {tuple(q_seg.shape)} / "
                         f"{tuple(kv_seg.shape)} do not match q "
                         f"{tuple(q.shape)} and k {tuple(k.shape)}")


def _launch_segment(kind, q, k, v, q_seg, kv_seg, causal, sm_scale, *,
                    o=None, do=None, dq=None, dk=None, dv=None, lse=None,
                    delta=None, legacy=False, sorted_ids=False):
    """One K4 kernel, `kind` "fwd", "dq" or "dkv", routed by `_route`. The
    tensors a kernel does not use stay None; the strides of the ones it
    does are (batch, row, head) in elements. The wgmma kernels read q, k,
    v and do through TMA, which needs 16-byte-aligned bases and strides
    (`_check_cuda` raises otherwise). `sorted_ids`: the ids are ascending
    runs with pad after them (K3's), and the Hopper dq and dk/dv walk only
    the band; the forward and the mma.sync kernels ignore it. Raises unless
    the kernel launched."""
    from ._build import load_library
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if d not in SEG_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not compiled into the segment kernels "
                         f"(have {SEG_HEAD_DIMS})")
    bf16 = {"q": q, "k": k, "v": v, "o": o, "do": do, "dq": dq, "dk": dk,
            "dv": dv}
    for name, t in bf16.items():
        if t is not None:
            _check_cuda(name, t)
    for name, t, shape in (("q_seg", q_seg, (b, sq)),
                           ("kv_seg", kv_seg, (b, sk))):
        if t.device != q.device or t.dtype != torch.int32 \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a contiguous {shape} int32 "
                             f"tensor on {q.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (b, h, sq)
                              or not t.is_contiguous()
                              or t.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 {(b, h, sq)} "
                             f"on {q.device}")
    library, entry, (bq, bk) = _route(kind, d, legacy)
    # the pre-pass's tile classes: (lo, hi, uniform, -) per query tile, then
    # per key tile
    classes = torch.empty((4 * b * (-(-sq // bq) + -(-sk // bk)),),
                          dtype=torch.int32, device=q.device)
    order = (q, k, v, o, do, dq, dk, dv)
    ptrs = (ctypes.c_void_p * 13)(*(
        None if t is None else t.data_ptr()
        for t in (*order, lse, delta, q_seg, kv_seg, classes)))
    strides = (ctypes.c_longlong * 24)(*(
        x for t in order
        for x in ((0, 0, 0) if t is None else _strides(t))))
    dims = (ctypes.c_int * 8)(b, sq, sk, h, kvh, d, int(causal),
                              int(sorted_ids))
    fn = getattr(load_library(library), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(q.device):
        rc = fn(ctypes.cast(ptrs, ctypes.c_void_p),
                ctypes.cast(dims, ctypes.c_void_p),
                ctypes.cast(strides, ctypes.c_void_p), float(sm_scale),
                _stream(q))
    if rc == -1:
        raise RuntimeError(f"{library} ({entry}): the driver refused a TMA "
                           f"tensor map for q {tuple(q.shape)} strides "
                           f"{q.stride()}, k {tuple(k.shape)} strides "
                           f"{k.stride()}")
    if rc != 0:
        raise RuntimeError(f"{library} ({entry}) launch failed: CUDA error "
                           f"{rc}")


def _count(kind, d):
    """One wrapper launch of `kind` at head dim d, on the route it took."""
    hopper = _route(kind, d)[0] == "attention_segment_hopper"
    _routes[kind]["hopper" if hopper else "legacy"] += 1


def segment_fwd(q, k, v, q_seg, kv_seg, causal: bool, sm_scale: float, o,
                lse=None):
    """K4 forward on (B, S, H, D) views (any strides with a contiguous head
    dim) into `o`, and the LSE (B, H, Sq) fp32 into `lse` if given. CUDA
    only."""
    global seg_fwd_launches
    _launch_segment("fwd", q, k, v, q_seg, kv_seg, causal, sm_scale, o=o,
                    lse=lse)
    seg_fwd_launches += 1
    _count("fwd", q.shape[3])
    return o


def segment_bwd_dq(q, k, v, o, do, lse, delta, q_seg, kv_seg, causal: bool,
                   sm_scale: float, dq, sorted_ids=False):
    """K4's dq kernel: writes dq and delta (B, H, Sq) fp32 = rowsum(o*do)
    (0 on pad rows), which segment_bwd_dkv reads. CUDA only."""
    global seg_dq_launches
    _launch_segment("dq", q, k, v, q_seg, kv_seg, causal, sm_scale, o=o,
                    do=do, dq=dq, lse=lse, delta=delta,
                    sorted_ids=sorted_ids)
    seg_dq_launches += 1
    _count("dq", q.shape[3])
    return dq


def segment_bwd_dkv(q, k, v, do, lse, delta, q_seg, kv_seg, causal: bool,
                    sm_scale: float, dk, dv, sorted_ids=False):
    """K4's dk/dv kernel (dk, dv shaped like k: one block sums each kv head's
    group of query heads); run after segment_bwd_dq on the same stream (it
    reads the delta that one writes). CUDA only."""
    global seg_dkv_launches
    _launch_segment("dkv", q, k, v, q_seg, kv_seg, causal, sm_scale, do=do,
                    dk=dk, dv=dv, lse=lse, delta=delta,
                    sorted_ids=sorted_ids)
    seg_dkv_launches += 1
    _count("dkv", q.shape[3])
    return dk, dv


def segment_backward(q, k, v, o, do, lse, q_seg, kv_seg, causal, sm_scale,
                     sorted_ids=False):
    """dq, dk, dv of segment attention from the forward's o and LSE, through
    K4's two backward kernels. Also the backward of the banded kernel K3
    (ops/attention_kvgrid.py), which is the same function on sorted ids:
    `sorted_ids` (q_seg and kv_seg ascending runs, pad after them) lets the
    kernels walk only the band. The result does not depend on it."""
    b, sq, h, d = q.shape
    do = do.contiguous()
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk, dv = torch.empty_like(k, memory_format=torch.contiguous_format), \
        torch.empty_like(v, memory_format=torch.contiguous_format)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    segment_bwd_dq(q, k, v, o, do, lse, delta, q_seg, kv_seg, causal,
                   sm_scale, dq, sorted_ids)
    segment_bwd_dkv(q, k, v, do, lse, delta, q_seg, kv_seg, causal, sm_scale,
                    dk, dv, sorted_ids)
    return dq, dk, dv


class _SegmentAttention(torch.autograd.Function):
    """q (B, Sq, H, D), k/v (B, Sk, H_kv, D) → o: K4 forward with the LSE,
    backward dq then dk/dv."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, sm_scale):
        b, sq, h, d = q.shape
        o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        segment_fwd(q, k, v, q_seg, kv_seg, causal, sm_scale, o, lse)
        ctx.save_for_backward(q, k, v, o, lse, q_seg, kv_seg)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
        dq, dk, dv = segment_backward(q, k, v, o, do, lse, q_seg, kv_seg,
                                      ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def _ids(seg, b, s, device):
    if seg is None:
        return torch.ones((b, s), dtype=torch.int32, device=device)
    return seg.to(device=device, dtype=torch.int32).contiguous()


def flash_attention(q, k, v, q_seg=None, kv_seg=None, *, lengths=None,
                    causal=False, sm_scale=None):
    """Flash attention in the (B, S, H, D) layout with grouped kv heads and
    two masking modes, as the JAX function of the same name:

      lengths (B,) int — contiguous right-padding, Sq == Sk: the
        valid-length kernels (K1, and K2 for the gradient);
      q_seg / kv_seg (B, S) int — segment ids of packed rows: K4 (None: one
        segment). See the module docstring for the contract on ids <= 0.
        Without ids and with Sq == Sk, a head dim that K1 takes and K4 does
        not (72) runs K1 (K2) at full length: the same function.
    """
    b, sq, h, d = q.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    if lengths is not None:
        if q_seg is not None or kv_seg is not None or k.shape[1] != sq:
            raise ValueError("lengths excludes segment ids and needs "
                             "Sq == Sk")
        from .attention_lengths import flash_fwd_lengths
        return flash_fwd_lengths(
            q, k, v, lengths.to(device=q.device, dtype=torch.int32), causal,
            sm_scale)
    if q_seg is None and kv_seg is None and k.shape[1] == sq \
            and d not in SEG_HEAD_DIMS and d in KERNEL_HEAD_DIMS:
        from .attention_lengths import flash_fwd_lengths
        return flash_fwd_lengths(
            q, k, v, torch.full((b,), sq, dtype=torch.int32, device=q.device),
            causal, sm_scale)
    q_seg = _ids(q_seg, b, sq, q.device)
    kv_seg = _ids(kv_seg, b, k.shape[1], q.device)
    _check_segment(q, k, v, q_seg, kv_seg)
    if q.device.type == "cpu":
        return segment_attention_reference(q, k, v, q_seg, kv_seg,
                                           causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if _wants_grad(q, k, v):
        return _SegmentAttention.apply(q, k, v, q_seg, kv_seg, causal,
                                       sm_scale)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    return segment_fwd(q, k, v, q_seg, kv_seg, causal, sm_scale, o)

"""Banded segment attention (K3): the Qwen2.5-VL vision tower's window and
full-attention layers.

Counterpart of visrag_tpu/ops/attention_kvgrid.py (`flash_attention_kvgrid`,
its TPU kernel `_fwd_kernel_banded` and the band bounds `_band_bounds`).
Every K3 launch on a CUDA tensor runs csrc/attention_kvgrid_hopper.cu: a
persistent kernel on the Hopper forward body's tile step and epilogue
(csrc/hopper_attention_fwd.cuh: wgmma, TMA, a producer warp and two
consumer warpgroups), a block an SM walking the 128-row query tiles of
every head, its producer finding each tile's key band from the sorted ids
and running ahead across tiles. Only the band's 128-key tiles are walked,
and tile pairs that both hold one id skip the per-element mask.
csrc/attention_kvgrid.cu, the first (mma.sync) kernel, is reached
only with `legacy=True`, to time one against the other; it counts no
launch. Both are CUDA C++ for sm_90a bound with ctypes; a refused tensor
map or launch raises and never falls back.

Contract: q (B, S, H, D), k/v (B, S, H_kv, D) with H_kv dividing H,
non-causal; segment ids (B, S) int are CONTIGUOUS ascending runs over the
real tokens (1, 1, ..., 2, 2, ...) with padding (<= 0) only after them. A
(query, key) pair attends iff the ids are equal and > 0. Rows with id <= 0
are exact zeros. Unlike the JAX wrapper, no `max_seg_len` is taken: the band
is exact, so nothing can be cut.

A CPU tensor takes `flash_attention_kvgrid_reference`, the plain PyTorch
version, and autograd through it is the plain backward; a CUDA tensor
launches the kernel or raises. The plain versions of the kernel's walk:
`band_bounds` (each query tile's band, in keys), `band_tile_range_reference`
(in key tiles, as the JAX `_band_bounds`) and `band_pair_classes_reference`
(the class of each tile pair). When a gradient is wanted the kernel also
writes the log-sum-exp (a template flag) and the backward runs K4's dq and
dk/dv (ops/attention.py) with q_seg = kv_seg = seg, non-causal, as the JAX
package's VJP of the banded kernel does, told that the ids are sorted, so
that they too walk only the band. Launch counters: `launches` (without the
LSE) and `lse_launches` (with it); `route_counts()` splits them by source.
"""

from __future__ import annotations

import ctypes

import torch

from .attention import MASKED, SKIP, UNMASKED
from .attention_lengths import LOG2E, _check_cuda, _repeat_kv, _stream, \
    _strides, _wants_grad

KERNEL_HEAD_DIM = 80      # every Qwen2.5-VL vision tower: 1280 / 16
SOURCE = "visrag_tpu_torch/csrc/attention_kvgrid_hopper.cu"
LEGACY_SOURCE = "visrag_tpu_torch/csrc/attention_kvgrid.cu"
TILE = 128                # the kernel's query rows and keys per tile

launches = 0        # K3 without the LSE
lse_launches = 0    # K3 with the LSE (a gradient is wanted)
_routes = {kind: {"hopper": 0, "legacy": 0} for kind in ("fwd", "fwd_lse")}


def reset_launch_counts() -> None:
    global launches, lse_launches
    launches = lse_launches = 0
    for counts in _routes.values():
        counts["hopper"] = counts["legacy"] = 0


def route_counts() -> dict:
    """The wrapper's K3 launches without ("fwd") and with ("fwd_lse") the
    LSE by source: "hopper" (csrc/attention_kvgrid_hopper.cu) or "legacy"
    (csrc/attention_kvgrid.cu, which no caller of the port reaches)."""
    return {kind: dict(counts) for kind, counts in _routes.items()}


def _route(legacy=False):
    """→ (library, entry point) of K3: the Hopper kernel, or with `legacy`
    the first one (to time one against the other; the port's callers never
    set it)."""
    if legacy:
        return "attention_kvgrid", "visrag_kvgrid_attention_fwd"
    return "attention_kvgrid_hopper", "visrag_kvgrid_hopper_fwd"


def band_bounds(seg, block: int = TILE):
    """Per-query-tile [start, end) key range from contiguous ascending ids:
    seg (B, S) → two (B, ceil(S/block)) int64 tensors, in keys (not key
    tiles). start = #keys with 0 < id < the tile's least real id, end =
    #keys with 0 < id <= its greatest; a tile with no real row gets an
    empty band (0, 0). The kernel's `BandMask::locate` computes the same
    per 128-row tile."""
    b, s = seg.shape
    nq = -(-s // block)
    pad = nq * block - s
    segp = torch.nn.functional.pad(seg.long(), (0, pad), value=0)
    tiles = segp.view(b, nq, block)
    real = tiles > 0
    big = torch.iinfo(torch.int64).max
    lo = torch.where(real, tiles, torch.full_like(tiles, big)).amin(dim=2)
    hi = torch.where(real, tiles, torch.zeros_like(tiles)).amax(dim=2)
    keys = seg.long()
    kreal = keys > 0
    start = ((keys[:, None, :] < lo[:, :, None]) & kreal[:, None, :]).sum(2)
    end = ((keys[:, None, :] <= hi[:, :, None]) & kreal[:, None, :]).sum(2)
    empty = ~real.any(dim=2)
    return start.masked_fill(empty, 0), end.masked_fill(empty, 0)


def band_tile_range_reference(seg, bq: int = TILE, bk: int = TILE):
    """The kernel's walk in key tiles: seg (B, S) sorted ids → two (B,
    ceil(S / bq)) int32 tensors, the first key tile of each bq-row query
    tile's band (`first()`: start // bk) and the tile after its last
    (`ntiles()`: ceil(end / bk)). A query tile with no real row walks
    nothing; it gets (the number of key tiles holding a real id, 0), the
    JAX `_band_bounds`'s empty band, so that the two agree everywhere."""
    start, end = band_bounds(seg, bq)
    first = torch.div(start, bk, rounding_mode="floor")
    last = torch.div(end + bk - 1, bk, rounding_mode="floor")
    n_real = (seg > 0).sum(1, keepdim=True).long()
    dead = end == 0
    first = torch.where(dead, torch.div(n_real + bk - 1, bk,
                                        rounding_mode="floor"), first)
    return first.int(), last.masked_fill(dead, 0).int()


def band_pair_classes_reference(seg, bq: int = TILE, bk: int = TILE):
    """The kernel's class of each (query tile, key tile) pair: seg (B, S)
    sorted ids → (B, ceil(S / bq), ceil(S / bk)) int32. SKIP outside the
    query tile's band (and everywhere for a tile with no real row);
    UNMASKED when the query tile's bq rows hold one id (rows past S are pad)
    and the key tile lies wholly inside the band, whose keys then all hold
    that id; MASKED, masked per element by id equality, otherwise."""
    b, s = seg.shape
    nq, nk = -(-s // bq), -(-s // bk)
    start, end = band_bounds(seg, bq)
    first, last = band_tile_range_reference(seg, bq, bk)
    ids = torch.zeros((b, nq * bq), dtype=torch.int64)
    ids[:, :s] = seg
    ids = ids.view(b, nq, bq)
    uniform = (ids > 0).all(2) & (ids.amin(2) == ids.amax(2))
    t = torch.arange(nk)[None, None, :]
    k0 = t * bk
    inside = (t >= first[..., None]) & (t < last[..., None])
    whole = uniform[..., None] & (k0 >= start[..., None]) \
        & (k0 + bk <= end[..., None])
    out = torch.full((b, nq, nk), MASKED, dtype=torch.int32)
    out[whole] = UNMASKED
    out[~inside] = SKIP
    return out


def flash_attention_kvgrid_reference(q, k, v, seg, sm_scale=None,
                                     rows: int = 1024):
    """Plain PyTorch version: fp32 scores and softmax over the keys of the
    row's own segment; rows with id <= 0 (or no key) are zeros. → (B, S, H,
    D) in q's dtype. Queries go `rows` at a time against every key, so the
    score buffer stays (B, H, rows, S) at the vision tower's 18k patches.
    Differentiable: autograd through it is the plain backward."""
    b, s, h, d = q.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    kf, vf = _repeat_kv(k, h).float(), _repeat_kv(v, h).float()
    qs = ks = seg.to(q.device).long()
    out = []
    for r0 in range(0, s, rows):
        qr = qs[:, r0:r0 + rows]
        allow = (qr[:, :, None] == ks[:, None, :]) & (qr[:, :, None] > 0)
        scores = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:r0 + rows].float(),
                              kf) * sm_scale
        scores = scores.masked_fill(~allow[:, None], float("-inf"))
        p = torch.softmax(scores, dim=-1)
        p = torch.where(allow.any(-1)[:, None, :, None], p,
                        torch.zeros_like(p))
        out.append(torch.einsum("bhqk,bkhd->bqhd", p, vf))
    return torch.cat(out, dim=1).to(q.dtype)


def _launch(q, k, v, seg, sm_scale, lse=None, legacy=False):
    """One K3 launch into a new o (and `lse` if given) on the route
    `_route(legacy)` picks; counts nothing. Raises unless it launched."""
    from ._build import load_library
    b, s, h, d = q.shape
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"head_dim {d} not compiled into the kernel "
                         f"(have {KERNEL_HEAD_DIM})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda(name, t)
    if seg.device != q.device or seg.dtype != torch.int32 \
            or not seg.is_contiguous() or tuple(seg.shape) != (b, s):
        raise ValueError("segment ids must be a contiguous (B, S) int32 "
                         "tensor on the same device as q")
    if lse is not None and (lse.dtype != torch.float32
                            or tuple(lse.shape) != (b, h, s)
                            or not lse.is_contiguous()
                            or lse.device != q.device):
        raise ValueError(f"lse must be contiguous fp32 {(b, h, s)} on "
                         f"{q.device}")
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    library, entry = _route(legacy)
    fn = getattr(load_library(library), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12 + [ctypes.c_float,
                                                  ctypes.c_void_p])
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if lse is None else lse.data_ptr(), seg.data_ptr(),
                b, s, h, k.shape[2], d,
                *_strides(q, k, v, o), float(sm_scale * LOG2E), _stream(q))
    if rc == -1:
        raise RuntimeError(f"{library} ({entry}): the driver refused a TMA "
                           f"tensor map for q {tuple(q.shape)} strides "
                           f"{q.stride()}, k strides {k.stride()}, v strides "
                           f"{v.stride()}")
    if rc != 0:
        raise RuntimeError(f"{library} ({entry}) launch failed: CUDA error "
                           f"{rc}")
    return o


class _BandedAttention(torch.autograd.Function):
    """K3 with the LSE; backward K4's dq then dk/dv on the same ids, which
    walk only the band (`sorted_ids`)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, sm_scale):
        global lse_launches
        b, s, h, d = q.shape
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        o = _launch(q, k, v, seg, sm_scale, lse)
        lse_launches += 1
        _routes["fwd_lse"]["hopper"] += 1
        ctx.save_for_backward(q, k, v, o, lse, seg)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        from .attention import segment_backward
        q, k, v, o, lse, seg = ctx.saved_tensors
        dq, dk, dv = segment_backward(q, k, v, o, do, lse, seg, seg, False,
                                      ctx.sm_scale, sorted_ids=True)
        return dq, dk, dv, None, None


def flash_attention_kvgrid(q, k, v, seg, *, sm_scale=None):
    """Banded segment attention, (B, S, H, D) layout, non-causal, one
    (B, S) id row for queries and keys; see the module docstring."""
    global launches
    b, s, h, d = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"q (B, S, H, D) and k/v (B, S, H_kv, D) expected, "
                         f"got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if tuple(seg.shape) != (b, s):
        raise ValueError(f"segment ids shape {tuple(seg.shape)} != "
                         f"({b}, {s})")
    if sm_scale is None:
        sm_scale = d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_kvgrid_reference(q, k, v, seg, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _on_card(q, k, v, seg, sm_scale)


def _on_card(q, k, v, seg, sm_scale):
    """K3 on the card, counted: with the LSE (and the backward) when a
    gradient is wanted."""
    global launches
    if _wants_grad(q, k, v):
        return _BandedAttention.apply(q, k, v, seg, sm_scale)
    o = _launch(q, k, v, seg, sm_scale)
    launches += 1
    _routes["fwd"]["hopper"] += 1
    return o

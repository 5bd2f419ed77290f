"""Valid-length (right-padded) flash attention, forward and backward.

Counterpart of visrag_tpu/ops/attention_lengths.py. The kernels are CUDA
C++ for sm_90a, bound with ctypes:

  * K1, csrc/attention_lengths_hopper.cu, replaces the TPU kernel
    `_fwd_kernel_grid`, with or without the log-sum-exp (LSE) that the
    backward needs: the Hopper forward shared with K4
    (csrc/hopper_attention_fwd.cuh: wgmma, TMA, one producer warp and two
    consumer warpgroups, 128-row tiles) with a valid-length mask whose tile
    classes are closed-form in the length (`lengths_pair_classes_reference`
    is their plain version). A head dim of 72 is read as a 64-column and a
    16-column piece (`column_plan`). `_route` sends every K1 launch on the
    card there, by head dim alone; `legacy=True` reaches the first, mma.sync
    kernel, csrc/attention_lengths.cu, which only chip_smoke.py and tools
    set, to time the two in turns;
  * K2, csrc/attention_lengths_bwd_hopper.cu, replaces `_dq_kernel` and
    `_dkv_kernel`: one kernel for dq (it also computes delta = rowsum(o·do)
    and stores it) and one for dk/dv, launched in that order, on the
    Hopper backward bodies of csrc/hopper_attention_bwd.cuh (dk/dv at
    d 128 the one K4's dk/dv shares, at d 64 / 72 a warpgroup a 64-key
    tile), with closed-form classes at 64 x 64 tiles
    (`lengths_bwd_pair_classes_reference`) and K1's column plan.
    `_bwd_route` sends every K2 launch on the card there;
    `legacy=True` reaches the mma.sync kernels, csrc/attention_lengths_bwd.cu,
    which only chip_smoke.py and tools set, to time the two in turns.

Two public forms:

  * stacked, `flash_fwd_lengths`: q/o (B, S, H, D), k/v (B, S, H_kv, D)
    with H_kv dividing H — the MiniCPM LM (H_kv = H) and the Qwen2.5-VL
    text prefill (grouped-query attention, d = 128), causal over
    right-padded prompts. K/V are not repeated: query head h reads kv head
    h // (H / H_kv) inside the kernel;
  * flat, `flash_fwd_lengths_flat`: the fused qkv GEMM output
    (n*S, 3*H*D) → o (n*S, H*D) — the SigLIP ViT, bidirectional; its
    gradient is one (n*S, 3*H*D) buffer.

Every kernel takes (batch, row, head) element strides, so neither form is
relaid out, forward or backward. Valid rows (< length) hold the masked
softmax attention; rows at or past the length are outside the contract and
every caller masks them, but K1 writes there what the plain version
writes: zeros, and LSE_PAD as their LSE (the legacy mma.sync kernel
writes attention over the valid keys there). Their gradient is zero: the
backward ignores the caller's `do` on pad rows and writes zero dq there,
and pad keys get zero dk and dv.

A CPU tensor takes `lengths_attention_reference`, the plain PyTorch
version, and autograd through it is the plain backward. A CUDA tensor
launches the kernels or raises; there is no fallback. When a gradient is
wanted (grad mode on and an input that requires grad) the call goes
through a `torch.autograd.Function` whose forward is K1 with the LSE and
whose backward is K2; otherwise K1 runs without the LSE. K2 takes d in
BWD_HEAD_DIMS and grouped kv heads (H_kv dividing H: query head h reads kv
head h // (H / H_kv), and dk/dv sum over the group inside the kernel, with
no repeat in memory), and raises for anything else.

Launch counters, one per kernel entry point (each launch covers all rows
and heads): `flat_launches` and `stacked_launches` (K1 without the LSE, by
form), `fwd_lse_launches` (K1 with the LSE, either form), `dq_launches`
and `dkv_launches` (K2); one per K1 route (`route_counts()`):
`hopper_launches` and `legacy_launches`; and one per K2 route
(`bwd_route_counts()`: `bwd_hopper_launches`, `bwd_legacy_launches`, each
dq and each dk/dv launch counting one), with the Hopper ones by kernel and
head dim (`bwd_head_dim_counts()`), so that a run can show that no K1 or
K2 launch of its path went to a legacy kernel, and which forms it ran.
"""

from __future__ import annotations

import ctypes
import functools

import torch

LOG2E = 1.4426950408889634
LSE_PAD = 0.7 * 3.4028234663852886e38   # LSE of a row with no valid key
KERNEL_HEAD_DIMS = (64, 72, 128)   # MiniCPM LM, SigLIP ViT, Qwen2.5 text
BWD_HEAD_DIMS = (64, 72, 128)      # K2: retriever training, the RL update
SOURCE = "visrag_tpu_torch/csrc/attention_lengths_hopper.cu"
BWD_SOURCE = "visrag_tpu_torch/csrc/attention_lengths_bwd_hopper.cu"
HOPPER_TILE = (128, 128)   # (query rows, keys) per tile of the Hopper K1
# (query rows, keys) of the Hopper K2's tile classes: 64 keys of dk/dv
# against 64-row query tiles, a dq warpgroup's 64 rows against 64-key tiles
BWD_TILE = (64, 64)
_ROUTES = {False: ("attention_lengths_hopper", "visrag_lengths_hopper_fwd"),
           True: ("attention_lengths", "visrag_lengths_attention_fwd")}
_BWD_ROUTES = {
    False: ("attention_lengths_bwd_hopper",
            {"dq": "visrag_lengths_hopper_bwd_dq",
             "dkv": "visrag_lengths_hopper_bwd_dkv"}),
    True: ("attention_lengths_bwd",
           {"dq": "visrag_lengths_attention_bwd_dq",
            "dkv": "visrag_lengths_attention_bwd_dkv"})}
SKIP, MASKED, UNMASKED = 0, 1, 2   # classes of a (query tile, key tile) pair

flat_launches = 0      # K1 without the LSE, by flash_fwd_lengths_flat
stacked_launches = 0   # K1 without the LSE, by flash_fwd_lengths
fwd_lse_launches = 0   # K1 with the LSE, by flash_fwd_lse
dq_launches = 0        # K2 dq, by flash_bwd_dq
dkv_launches = 0       # K2 dk/dv, by flash_bwd_dkv
hopper_launches = 0    # K1 launches on attention_lengths_hopper.cu
legacy_launches = 0    # K1 launches on attention_lengths.cu (legacy=True)
bwd_hopper_launches = 0   # K2 launches on attention_lengths_bwd_hopper.cu
bwd_legacy_launches = 0   # K2 launches on attention_lengths_bwd.cu
_bwd_by_head_dim = {}     # (kind, d) → Hopper K2 launches


def reset_launch_counts() -> None:
    global flat_launches, stacked_launches, fwd_lse_launches
    global dq_launches, dkv_launches, hopper_launches, legacy_launches
    global bwd_hopper_launches, bwd_legacy_launches
    flat_launches = stacked_launches = fwd_lse_launches = 0
    dq_launches = dkv_launches = 0
    hopper_launches = legacy_launches = 0
    bwd_hopper_launches = bwd_legacy_launches = 0
    _bwd_by_head_dim.clear()


def launch_counts() -> dict:
    return {"flat": flat_launches, "stacked": stacked_launches,
            "fwd_lse": fwd_lse_launches, "dq": dq_launches,
            "dkv": dkv_launches}


def route_counts() -> dict:
    """K1 launches by route since the last reset: "hopper" + "legacy" ==
    flat + stacked + fwd_lse of launch_counts() when only the public
    functions launched."""
    return {"hopper": hopper_launches, "legacy": legacy_launches}


def bwd_route_counts() -> dict:
    """K2 launches by route since the last reset (a dq and a dk/dv launch
    count one each): "hopper" + "legacy" == dq + dkv of launch_counts()
    when only the public functions launched."""
    return {"hopper": bwd_hopper_launches, "legacy": bwd_legacy_launches}


def bwd_head_dim_counts() -> dict:
    """Hopper K2 launches since the last reset by kernel and head dim:
    {"dq": {d: n}, "dkv": {d: n}} over BWD_HEAD_DIMS (the forms: the ViT's
    d 72, the MiniCPM LM's d 64, the Qwen text model's d 128)."""
    return {kind: {d: _bwd_by_head_dim.get((kind, d), 0)
                   for d in BWD_HEAD_DIMS} for kind in ("dq", "dkv")}


def column_plan(d: int):
    """How the Hopper K1 reads a head dim of d: (first column, width,
    swizzle bytes) per piece. TMA's 128-byte swizzle takes at most 64 bf16
    columns and a wgmma k-step is 16, so d is cut into 64-column pieces
    (128-byte swizzle) and, where 64 does not divide it, one 16-column piece
    (32-byte swizzle) whose columns past d read as zeros: d 72 →
    ((0, 64, 128), (64, 16, 32)). The wrapper passes it to the kernel, which
    refuses a plan other than the one it was compiled with."""
    if d <= 0 or d % 8 or d % 64 > 16:
        raise ValueError(f"head_dim {d} has no column plan (64 k, or 64 k + "
                         "8 or + 16)")
    plan = tuple((64 * i, 64, 128) for i in range(d // 64))
    if d % 64:
        plan += ((64 * (d // 64), 16, 32),)
    return plan


def lengths_pair_classes_reference(lengths, s: int, bq: int, bk: int,
                                   causal: bool):
    """Plain version of the Hopper K1's tile classes: lengths (B,) int →
    (B, ceil(s / bq), ceil(s / bk)) int32, per (query tile at q0, key tile
    at k0) SKIP when k0 >= len or (causal) k0 > q0 + bq - 1, UNMASKED when
    k0 + bk <= len and (causal) k0 + bk - 1 <= q0, MASKED otherwise (the
    kernel masks those per element on key < len and key <= query when
    causal). A query tile with q0 >= len is skipped whole: the kernel
    writes its rows as zeros and LSE_PAD."""
    ln = torch.as_tensor(lengths).long().clamp(0, s)[:, None, None]
    q0 = torch.arange(0, s, bq)[None, :, None]
    k0 = torch.arange(0, s, bk)[None, None, :]
    skip = (k0 >= ln) | (q0 >= ln)
    full = (k0 + bk <= ln).expand(skip.shape)
    if causal:
        skip = skip | (k0 > q0 + bq - 1)
        full = full & (k0 + bk - 1 <= q0)
    out = torch.full(skip.shape, MASKED, dtype=torch.int32)
    out[full] = UNMASKED
    out[skip] = SKIP
    return out


def lengths_bwd_pair_classes_reference(lengths, s: int, bq: int, bk: int,
                                       causal: bool):
    """Plain version of the Hopper K2's tile classes: lengths (B,) int →
    (B, ceil(s / bq), ceil(s / bk)) int32, per (query tile at q0, key tile
    at k0) SKIP when q0 >= len, k0 >= len or (causal) k0 > q0 + bq - 1,
    UNMASKED when q0 + bq <= len, k0 + bk <= len and (causal) k0 + bk - 1
    <= q0, MASKED otherwise (the kernels mask those per element on query <
    len, key < len and key <= query when causal). Unlike the forward's
    classes (`lengths_pair_classes_reference`), a pair that holds a query
    row at or past the length is never unmasked: the caller's `do` there is
    garbage, so the backward masks those rows out of P and dS."""
    ln = torch.as_tensor(lengths).long().clamp(0, s)[:, None, None]
    q0 = torch.arange(0, s, bq)[None, :, None]
    k0 = torch.arange(0, s, bk)[None, None, :]
    skip = (k0 >= ln) | (q0 >= ln)
    full = (k0 + bk <= ln) & (q0 + bq <= ln)
    if causal:
        skip = skip | (k0 > q0 + bq - 1)
        full = full & (k0 + bk - 1 <= q0)
    out = torch.full(skip.shape, MASKED, dtype=torch.int32)
    out[full] = UNMASKED
    out[skip] = SKIP
    return out


def _route(d: int, legacy: bool = False):
    """→ (library, entry point) of K1 at head dim d: the Hopper kernel for
    every d in KERNEL_HEAD_DIMS; `legacy` selects the mma.sync kernel
    (to time one against the other); the port's callers never set it."""
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not compiled into the kernel "
                         f"(have {KERNEL_HEAD_DIMS})")
    return _ROUTES[bool(legacy)]


def _bwd_route(d: int, legacy: bool = False):
    """→ (library, {"dq": entry point, "dkv": entry point}) of K2 at head
    dim d: the Hopper kernels for every d in BWD_HEAD_DIMS; `legacy`
    selects the mma.sync kernels (to time one against the other); the
    port's callers never set it."""
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not compiled into the backward "
                         f"kernels (have {BWD_HEAD_DIMS})")
    return _BWD_ROUTES[bool(legacy)]


def _allowed(s, lengths, causal, device):
    pos = torch.arange(s, device=device)
    allow = pos[None, None, None, :] < lengths.to(device)[:, None, None, None]
    if causal:
        allow = allow & (pos[:, None] >= pos[None, :])[None, None]
    return allow


def _repeat_kv(t, heads):
    """(B, S, H_kv, D) → (B, S, H, D): kv head j serves query heads
    j*rep .. j*rep + rep - 1."""
    return t if t.shape[2] == heads else \
        t.repeat_interleave(heads // t.shape[2], dim=2)


def lengths_attention_reference(q, k, v, lengths, causal: bool,
                                sm_scale: float):
    """Plain PyTorch version: q (B, S, H, D), k/v (B, S, H_kv, D) → (B, S,
    H, D) in q's dtype. fp32 scores and softmax; rows at or past each length
    are zeros. Differentiable: autograd through it is the plain backward."""
    b, s, h, d = q.shape
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    scores = scores.masked_fill(~_allowed(s, lengths, causal, q.device),
                                -1e30)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1),
                     v.float())
    valid = torch.arange(s, device=q.device)[None, :] \
        < lengths.to(q.device)[:, None]
    return (o * valid[:, :, None, None]).to(q.dtype)


def lengths_lse_reference(q, k, lengths, causal: bool, sm_scale: float):
    """Plain version of K1's LSE: (B, H, S) fp32 natural-log log-sum-exp of
    each row's masked scores; LSE_PAD at or past the length."""
    b, s, h, d = q.shape
    k = _repeat_kv(k, h)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    scores = scores.masked_fill(~_allowed(s, lengths, causal, q.device),
                                float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    valid = torch.arange(s, device=q.device)[None, None, :] \
        < lengths.to(q.device)[:, None, None]
    return torch.where(valid, lse, torch.full_like(lse, LSE_PAD))


def _check_cuda(name, t):
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got "
                        f"{t.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: head dim must be contiguous, strides "
                         f"{t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
    if any(st % 8 for st in t.stride()[:-1]):
        raise ValueError(f"{name}: strides {t.stride()} leave rows or heads "
                         "off 16-byte alignment")


def _check_launch(q, lengths, *fp32, head_dims=KERNEL_HEAD_DIMS):
    b, s, h, d = q.shape
    if d not in head_dims:
        raise ValueError(f"head_dim {d} not compiled into the kernel "
                         f"(have {head_dims})")
    if lengths.device != q.device or lengths.dtype != torch.int32 \
            or not lengths.is_contiguous() or lengths.shape != (b,):
        raise ValueError("lengths must be a contiguous (B,) int32 tensor on "
                         "the same device as q")
    for t in fp32:
        if t.dtype != torch.float32 or t.shape != (b, h, s) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"lse/delta must be contiguous fp32 "
                             f"{(b, h, s)} on {q.device}")


def _strides(*tensors):
    return [int(x) for t in tensors for x in t.stride()[:3]]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd_lse(q, k, v, lengths, causal: bool, sm_scale: float, o):
    """K1 with the LSE on (B, S, H, D) views (any strides with a contiguous
    head dim) into `o`; → lse (B, H, S) fp32. CUDA only."""
    global fwd_lse_launches
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        _check_cuda(name, t)
    b, s, h, d = q.shape
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _fwd(q, k, v, o, lse, lengths, causal, sm_scale)
    fwd_lse_launches += 1
    return lse


@functools.lru_cache(maxsize=None)
def _entry(legacy: bool):
    """The C entry point of K1 on one route with its argument types, set
    once: the Hopper one also takes the column plan."""
    from ._build import load_library
    library, entry = _ROUTES[legacy]
    fn = getattr(load_library(library), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_float]
                   + ([] if legacy else [ctypes.c_void_p, ctypes.c_int])
                   + [ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _plan_args(d: int):
    """column_plan(d) as the (int array, piece count) the kernel takes."""
    plan = [x for piece in column_plan(d) for x in piece]
    return (ctypes.c_int * len(plan))(*plan), len(plan) // 3


def _fwd(q, k, v, o, lse, lengths, causal, sm_scale, legacy=False):
    """Launches K1 on the route `_route` picks; lse None for the inference
    variant. Raises unless the kernel launched."""
    global hopper_launches, legacy_launches
    _check_launch(q, lengths, *([lse] if lse is not None else []))
    b, s, h, d = q.shape
    legacy = bool(legacy)
    library, _ = _route(d, legacy)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), lengths.data_ptr(),
            b, s, h, k.shape[2], d, *_strides(q, k, v, o), int(causal),
            float(sm_scale * LOG2E), *(() if legacy else _plan_args(d)))
    with torch.cuda.device(q.device):
        rc = _entry(legacy)(*args, _stream(q))
    if rc == -1:
        raise RuntimeError(f"{library}: cuTensorMapEncodeTiled refused a TMA "
                           f"tensor map for q {tuple(q.shape)} strides "
                           f"{q.stride()}, k {tuple(k.shape)} strides "
                           f"{k.stride()}")
    if rc != 0:
        raise RuntimeError(f"{library} kernel launch failed: CUDA error {rc}")
    if legacy:
        legacy_launches += 1
    else:
        hopper_launches += 1
    return o


@functools.lru_cache(maxsize=None)
def _bwd_entry(kind: str, legacy: bool):
    """The C entry point of K2's `kind` kernel ("dq" or "dkv") on one route
    with its argument types, set once: the Hopper ones also take the column
    plan."""
    from ._build import load_library
    library, entries = _BWD_ROUTES[legacy]
    fn = getattr(load_library(library), entries[kind])
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
                   + ([] if legacy else [ctypes.c_void_p, ctypes.c_int])
                   + [ctypes.c_void_p])
    return fn


def _bwd(kind, q, k, v, o, do, lse, delta, lengths, causal, sm_scale,
         dq, dk, dv, legacy=False):
    """Launches K2's `kind` kernel ("dq" or "dkv") on the route `_bwd_route`
    picks. Raises unless the kernel launched."""
    global bwd_hopper_launches, bwd_legacy_launches
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do),
                    ("dq", dq), ("dk", dk), ("dv", dv)):
        _check_cuda(name, t)
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2] \
            or dq.shape != q.shape or dk.shape != k.shape \
            or dv.shape != k.shape:
        raise ValueError("the backward kernels take q/dq (B, S, H, D) and "
                         "k/v/dk/dv (B, S, H_kv, D) with H_kv dividing H, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(dq.shape)} "
                         f"{tuple(dk.shape)}")
    _check_launch(q, lengths, lse, delta, head_dims=BWD_HEAD_DIMS)
    b, s, h, d = q.shape
    legacy = bool(legacy)
    library, entries = _bwd_route(d, legacy)
    strides = (ctypes.c_longlong * 24)(*_strides(q, k, v, o, do, dq, dk, dv))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), lengths.data_ptr(),
            b, s, h, k.shape[2], d, ctypes.cast(strides, ctypes.c_void_p),
            int(causal), float(sm_scale),
            *(() if legacy else _plan_args(d)))
    with torch.cuda.device(q.device):
        rc = _bwd_entry(kind, legacy)(*args, _stream(q))
    if rc == -1:
        raise RuntimeError(f"{library} ({entries[kind]}): "
                           f"cuTensorMapEncodeTiled refused a TMA tensor map "
                           f"for q {tuple(q.shape)} strides {q.stride()}, k "
                           f"{tuple(k.shape)} strides {k.stride()}")
    if rc != 0:
        raise RuntimeError(f"{library} ({entries[kind]}) launch failed: CUDA "
                           f"error {rc}")
    if legacy:
        bwd_legacy_launches += 1
    else:
        bwd_hopper_launches += 1
        _bwd_by_head_dim[kind, d] = _bwd_by_head_dim.get((kind, d), 0) + 1


def flash_bwd_dq(q, k, v, o, do, lse, delta, lengths, causal: bool,
                 sm_scale: float, dq):
    """K2's dq kernel on (B, S, H, D) views: writes dq and delta
    (B, H, S) fp32 = rowsum(o·do), which flash_bwd_dkv reads. CUDA only."""
    global dq_launches
    _bwd("dq", q, k, v, o, do, lse, delta, lengths, causal, sm_scale, dq, k,
         v)   # dq writes no dk/dv
    dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, o, do, lse, delta, lengths, causal: bool,
                  sm_scale: float, dk, dv):
    """K2's dk/dv kernel; run after flash_bwd_dq on the same stream (it
    reads the delta that one writes). CUDA only."""
    global dkv_launches
    _bwd("dkv", q, k, v, o, do, lse, delta, lengths, causal, sm_scale, q,
         dk, dv)  # dk/dv writes no dq
    dkv_launches += 1
    return dk, dv


def _backward(q, k, v, o, do, lse, lengths, causal, sm_scale, dq, dk, dv):
    b, s, h, d = q.shape
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    flash_bwd_dq(q, k, v, o, do, lse, delta, lengths, causal, sm_scale, dq)
    flash_bwd_dkv(q, k, v, o, do, lse, delta, lengths, causal, sm_scale,
                  dk, dv)


class _StackedAttention(torch.autograd.Function):
    """q/k/v (B, S, H, D) → o (B, S, H, D): K1 with the LSE, backward K2."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal, sm_scale):
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        lse = flash_fwd_lse(q, k, v, lengths, causal, sm_scale, o)
        ctx.save_for_backward(q, k, v, o, lse, lengths)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, lengths = ctx.saved_tensors
        do = do.contiguous()
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        dk, dv = (torch.empty(k.shape, dtype=k.dtype, device=k.device)
                  for _ in range(2))
        _backward(q, k, v, o, do, lse, lengths, ctx.causal, ctx.sm_scale,
                  dq, dk, dv)
        return dq, dk, dv, None, None, None


def _flat_views(t, n, seq, parts, heads, d):
    """(n*seq, parts*heads*d) → `parts` (n, seq, heads, d) strided views."""
    return t.unflatten(0, (n, seq)).unflatten(2, (parts, heads, d)).unbind(2)


class _FlatAttention(torch.autograd.Function):
    """qkv (n*S, 3*H*D) → o (n*S, H*D): K1 with the LSE, backward K2 into
    one (n*S, 3*H*D) buffer."""

    @staticmethod
    def forward(ctx, qkv, lengths, n, seq, heads, d, causal, sm_scale):
        q, k, v = _flat_views(qkv, n, seq, 3, heads, d)
        o = torch.empty((n * seq, heads * d), dtype=qkv.dtype,
                        device=qkv.device)
        lse = flash_fwd_lse(q, k, v, lengths, causal, sm_scale,
                            o.view(n, seq, heads, d))
        ctx.save_for_backward(qkv, o, lse, lengths)
        ctx.shape = (n, seq, heads, d)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse, lengths = ctx.saved_tensors
        n, seq, heads, d = ctx.shape
        dqkv = torch.empty((n * seq, 3 * heads * d), dtype=qkv.dtype,
                           device=qkv.device)
        _backward(*_flat_views(qkv, n, seq, 3, heads, d),
                  o.view(n, seq, heads, d),
                  do.contiguous().view(n, seq, heads, d), lse, lengths,
                  ctx.causal, ctx.sm_scale,
                  *_flat_views(dqkv, n, seq, 3, heads, d))
        return dqkv, None, None, None, None, None, None, None


def _device_kind(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _wants_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_fwd_lengths(q, k, v, lengths, causal: bool, sm_scale: float):
    """Stacked form: q (B, S, H, D), k/v (B, S, H_kv, D) with H_kv dividing
    H, lengths (B,) int → o (B, S, H, D)."""
    global stacked_launches
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"q (B, S, H, D) and k/v (B, S, H_kv, D) with H_kv "
                         f"dividing H expected, got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    b, s, h, d = q.shape
    if lengths.shape != (b,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({b},)")
    if _device_kind(q) == "cpu":
        return lengths_attention_reference(q, k, v, lengths, causal, sm_scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda(name, t)
    if _wants_grad(q, k, v):
        if d not in BWD_HEAD_DIMS:
            raise ValueError(f"no backward kernel for q {tuple(q.shape)}, "
                             f"k {tuple(k.shape)}: K2 takes d in "
                             f"{BWD_HEAD_DIMS}")
        return _StackedAttention.apply(q, k, v, lengths, causal, sm_scale)
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    _fwd(q, k, v, o, None, lengths, causal, sm_scale)
    stacked_launches += 1
    return o


def flash_fwd_lengths_flat(qkv, lengths, n: int, seq: int, heads: int,
                           d: int, causal: bool, sm_scale: float):
    """Flat form: qkv (n*seq, 3*heads*d) with columns [q heads | k heads |
    v heads], lengths (n,) → o (n*seq, heads*d)."""
    global flat_launches
    hd = heads * d
    if tuple(qkv.shape) != (n * seq, 3 * hd):
        raise ValueError(f"qkv shape {tuple(qkv.shape)} != "
                         f"({n * seq}, {3 * hd})")
    if lengths.shape != (n,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({n},)")
    if _device_kind(qkv) == "cpu":
        q, k, v = _flat_views(qkv, n, seq, 3, heads, d)
        o = lengths_attention_reference(q, k, v, lengths, causal, sm_scale)
        return o.reshape(n * seq, hd)
    _check_cuda("qkv", qkv)
    if _wants_grad(qkv):
        return _FlatAttention.apply(qkv, lengths, n, seq, heads, d, causal,
                                    sm_scale)
    o = torch.empty((n * seq, hd), dtype=qkv.dtype, device=qkv.device)
    q, k, v = _flat_views(qkv, n, seq, 3, heads, d)
    _fwd(q, k, v, o.view(n, seq, heads, d), None, lengths, causal, sm_scale)
    flat_launches += 1
    return o

"""Valid-length (right-padded) flash attention forward.

Counterpart of visrag_tpu/ops/attention_lengths.py. The kernel is
csrc/attention_lengths.cu (CUDA C++ for sm_90a, bound with ctypes); it
replaces the TPU kernel `_fwd_kernel_grid` in both of its forms:

  * stacked, `flash_fwd_lengths`: q/k/v/o (B, S, H, D) — the MiniCPM LM,
    causal over right-padded prompts;
  * flat, `flash_fwd_lengths_flat`: the fused qkv GEMM output
    (n*S, 3*H*D) → o (n*S, H*D) — the SigLIP ViT, bidirectional.

Both go to the same kernel with other strides, so there is no relayout on
either side. Valid rows (< length) hold the masked softmax attention; rows
at or past the length are outside the contract (the plain version writes
zeros there, the kernel attention over the valid keys) and every caller
masks them.

A CPU tensor takes `lengths_attention_reference`, the plain PyTorch
version. A CUDA tensor launches the kernel or raises; there is no fallback.
`flat_launches` and `stacked_launches` count each wrapper's kernel launches
(one per call, covering all rows and heads).
"""

from __future__ import annotations

import ctypes

import torch

LOG2E = 1.4426950408889634
KERNEL_HEAD_DIMS = (64, 72)     # the LM's and the ViT's
SOURCE = "visrag_tpu_torch/csrc/attention_lengths.cu"

flat_launches = 0      # kernel launches by flash_fwd_lengths_flat
stacked_launches = 0   # kernel launches by flash_fwd_lengths


def lengths_attention_reference(q, k, v, lengths, causal: bool,
                                sm_scale: float):
    """Plain PyTorch version: (B, S, H, D) → (B, S, H, D) in q's dtype.
    fp32 scores and softmax; rows at or past each length are zeros."""
    b, s, h, d = q.shape
    pos = torch.arange(s, device=q.device)
    lengths = lengths.to(q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    allow = pos[None, None, None, :] < lengths[:, None, None, None]
    if causal:
        allow = allow & (pos[:, None] >= pos[None, :])[None, None]
    scores = scores.masked_fill(~allow, -1e30)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1),
                     v.float())
    valid = pos[None, :] < lengths[:, None]
    return (o * valid[:, :, None, None]).to(q.dtype)


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


def _launch(q, k, v, o, lengths, *, seq, heads, head_dim, strides, causal,
            sm_scale):
    """strides: four (batch, row, head) element-stride triples for q, k, v,
    o. Tensors are already checked. Raises unless the kernel launched."""
    from ._build import load_library
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not compiled into the kernel "
                         f"(have {KERNEL_HEAD_DIMS})")
    if lengths.device != q.device or lengths.dtype != torch.int32 \
            or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous int32 tensor on the "
                         "same device as q")
    fn = load_library("attention_lengths").visrag_lengths_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    flat_strides = [int(x) for triple in strides for x in triple]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lengths.data_ptr(), lengths.shape[0], seq, heads, head_dim,
                *flat_strides, int(causal), float(sm_scale * LOG2E), stream)
    if rc != 0:
        raise RuntimeError(f"attention_lengths kernel launch failed: CUDA "
                           f"error {rc}")
    return o


def _device_kind(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def flash_fwd_lengths(q, k, v, lengths, causal: bool, sm_scale: float):
    """Stacked form: q/k/v (B, S, H, D), lengths (B,) int → o (B, S, H, D)."""
    global stacked_launches
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one (B, S, H, D) shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if lengths.shape != (b,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({b},)")
    if _device_kind(q) == "cpu":
        return lengths_attention_reference(q, k, v, lengths, causal, sm_scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda(name, t)
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    strides = [(t.stride(0), t.stride(1), t.stride(2)) for t in (q, k, v, o)]
    _launch(q, k, v, o, lengths, seq=s, heads=h, head_dim=d, strides=strides,
            causal=causal, sm_scale=sm_scale)
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
        parts = qkv.view(n, seq, 3, heads, d)
        o = lengths_attention_reference(parts[:, :, 0], parts[:, :, 1],
                                        parts[:, :, 2], lengths, causal,
                                        sm_scale)
        return o.reshape(n * seq, hd)
    _check_cuda("qkv", qkv)
    o = torch.empty((n * seq, hd), dtype=qkv.dtype, device=qkv.device)
    row = qkv.stride(0)
    in_strides = (seq * row, row, d)
    strides = [in_strides, in_strides, in_strides, (seq * hd, hd, d)]
    _launch(qkv, qkv[:, hd:], qkv[:, 2 * hd:], o, lengths, seq=seq,
            heads=heads, head_dim=d, strides=strides, causal=causal,
            sm_scale=sm_scale)
    flat_launches += 1
    return o

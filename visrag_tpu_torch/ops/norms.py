"""Fused row norms (K7): RMSNorm and LayerNorm over the last dimension.

Counterpart of visrag_tpu/ops/norms.py. The kernel is CUDA C++ for sm_90a,
csrc/norms.cu, bound with ctypes; it replaces the TPU kernels `_rms_kernel`
and `_ln_kernel` (launched by `_run_rows_kernel`):

    rmsnorm:   x · rsqrt(mean(x²) + eps) · w
    layernorm: (x − μ) · rsqrt(mean((x − μ)²) + eps) · w + b

in fp32, cast back to x's dtype, with one read of x and one write of y.
x is bf16 or fp32, w and b bf16 or fp32 in their own dtype (b is cast to
w's where the two differ); any row count, any D up to what one block holds
in registers (MAX_WIDTH: 16-byte vectors, or elements where D is not a
multiple of the vector width or a pointer is not aligned to it). The JAX
wrapper's rule that D be a multiple of 128 and the rows of 8 does not
apply here.

`rms_route` picks RMSNorm's kernel by shape alone: D <= WARP_MAX_WIDTH and
a multiple of 8 (with aligned pointers) at WARP_MIN_ROWS rows or more goes
to the warp-per-row kernel (`visrag_rmsnorm_warp`); wider or ragged D, and
fewer rows, to the block-per-row kernel or its scalar variant. LayerNorm
always takes the block-per-row kernel.
`legacy=True` reaches the block-per-row RMSNorm at any D, to time the two
in turns; the port's callers never set it.

A CPU tensor takes `rmsnorm_reference` / `layernorm_reference`, the plain
versions, and autograd through them is the plain backward. A CUDA tensor
launches the kernel or raises; there is no fallback. On the card, when a
gradient is wanted, the call goes through a `torch.autograd.Function`
whose forward is the kernel and whose backward recomputes through the
plain version, as the JAX package's custom VJPs do; under
torch.utils.checkpoint (non-reentrant) the recompute of the forward
launches the kernel again. `launch_counts()` counts kernel
launches by kind.
"""

from __future__ import annotations

import ctypes
import functools

import torch

SOURCE = "visrag_tpu_torch/csrc/norms.cu"
REPLACES = {"rmsnorm": "visrag_tpu/ops/norms.py:30",
            "layernorm": "visrag_tpu/ops/norms.py:37"}
# chunks a thread x threads: 4 x 512 vectors, or 8 x 1024 elements (scalar)
MAX_WIDTH = {True: 4 * 512, False: 8 * 1024}
WARP_MAX_WIDTH = 4096   # the warp-per-row RMSNorm: D / 256 vectors a lane
# rows that give each of an H100's 132 SMs one block of the warp-per-row
# kernel (8 warps x 2 rows); below that the block-per-row kernel, a block a
# row, spreads the rows over more SMs and measured faster (PERF.md)
WARP_MIN_ROWS = 132 * 8 * 2
_IS_FP32 = {torch.float32: 1, torch.bfloat16: 0}
_ENTRY = {"warp": "visrag_rmsnorm_warp", "block": "visrag_rmsnorm",
          "block_scalar": "visrag_rmsnorm", "layernorm": "visrag_layernorm"}

rms_launches = 0
ln_launches = 0
rms_warp_launches = 0    # of rms_launches, on the warp-per-row kernel


def reset_launch_counts() -> None:
    global rms_launches, ln_launches, rms_warp_launches
    rms_launches = ln_launches = rms_warp_launches = 0


def launch_counts() -> dict:
    return {"rmsnorm": rms_launches, "layernorm": ln_launches}


def route_counts() -> dict:
    """RMSNorm launches by kernel since the last reset."""
    return {"rms_warp": rms_warp_launches,
            "rms_block": rms_launches - rms_warp_launches}


def rms_route(dtype, d: int, rows: int, aligned: bool = True,
              legacy: bool = False):
    """The RMSNorm kernel for `rows` rows of x of `dtype` and width d:
    "warp" (a warp per row) for bf16 or fp32 at d <= WARP_MAX_WIDTH and a
    multiple of 8, rows >= WARP_MIN_ROWS, with 16-byte-aligned pointers;
    else "block" (a block per row on 16-byte vectors) or "block_scalar"
    (its scalar variant: d not a multiple of the vector or a pointer not
    aligned to it). `legacy` skips the warp kernel."""
    if dtype not in _IS_FP32:
        raise TypeError(f"the norm kernel takes bfloat16 or float32, got "
                        f"{dtype}")
    vec = aligned and d % (16 // (4 if dtype == torch.float32 else 2)) == 0
    if vec and not legacy and d % 8 == 0 and d <= WARP_MAX_WIDTH \
            and rows >= WARP_MIN_ROWS:
        return "warp"
    return "block" if vec else "block_scalar"


def rmsnorm_reference(x, w, eps: float):
    """Plain RMSNorm: fp32 math, output in x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def layernorm_reference(x, w, b, eps: float):
    """Plain LayerNorm: fp32 math, two-pass, output in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel(entry: str):
    """The C entry point with its argument types, set once (this call runs
    57 times per 7B decode step, where host time is the step's time)."""
    from ._build import load_library
    fn = getattr(load_library("norms"), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (4 if entry == "visrag_layernorm"
                                       else 3) \
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float] \
        + [ctypes.c_int] * (2 if entry == "visrag_rmsnorm_warp" else 3) \
        + [ctypes.c_void_p]
    return fn


def _launch(x, w, b, eps: float, legacy: bool = False):
    """K7 on a CUDA tensor: RMSNorm when b is None (on the kernel
    `rms_route` picks), else LayerNorm. → y shaped like x. Raises unless the
    kernel launched."""
    global rms_launches, ln_launches, rms_warp_launches
    d = x.shape[-1]
    params = (w,) if b is None else (w, b.to(w.dtype))
    if x.dtype not in _IS_FP32 or w.dtype not in _IS_FP32:
        raise TypeError(f"the norm kernel takes bfloat16 or float32, got x "
                        f"{x.dtype}, w {w.dtype}")
    for t in params:
        if t.shape != (d,) or t.device != x.device:
            raise ValueError(f"norm parameter {tuple(t.shape)} on {t.device} "
                             f"for x {tuple(x.shape)} on {x.device}")
    if d == 0:
        raise ValueError("the norm kernel takes D >= 1")
    x2 = x.contiguous()
    params = tuple(t.contiguous() for t in params)
    y = torch.empty_like(x2)
    vec = 16 // x2.element_size()
    use_vec = d % vec == 0 and all(
        t.data_ptr() % (vec * t.element_size()) == 0
        for t in (x2, y, *params))
    width = d // vec if use_vec else d
    if width > MAX_WIDTH[use_vec]:
        unit = "16-byte vectors" if use_vec else "elements"
        raise ValueError(f"D = {d} is wider than the norm kernel holds "
                         f"({MAX_WIDTH[use_vec]} {unit})")
    rows = x2.numel() // d
    if rows == 0:
        return y
    route = "layernorm" if b is not None \
        else rms_route(x2.dtype, d, rows, use_vec, legacy)
    fn = _kernel(_ENTRY[route])
    args = (x2.data_ptr(), *(t.data_ptr() for t in params), y.data_ptr(),
            rows, d, float(eps), _IS_FP32[x2.dtype],
            _IS_FP32[params[0].dtype],
            *(() if route == "warp" else (int(use_vec),)),
            torch.cuda.current_stream(x2.device).cuda_stream)
    if x2.device.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(x2.device):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"norm kernel launch failed: CUDA error {rc}")
    if b is None:
        rms_launches += 1
        rms_warp_launches += route == "warp"
    else:
        ln_launches += 1
    return y


class _RowNorm(torch.autograd.Function):
    """Forward: K7. Backward: autograd through the plain version on the
    saved inputs (the JAX custom VJPs' recompute)."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        ctx.save_for_backward(x, w, b)
        ctx.eps = eps
        return _launch(x, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) if t is not None else None
                   for t, n in zip((x, w, b), need)]
            y = rmsnorm_reference(ins[0], ins[1], ctx.eps) if b is None \
                else layernorm_reference(ins[0], ins[1], ins[2], ctx.eps)
            wanted = [t for t, n in zip(ins, need) if n]
            grads = iter(torch.autograd.grad(y, wanted, g))
        return tuple(next(grads) if n else None for n in need) + (None,)


def _dispatch(x, w, b, eps):
    if x.device.type == "cpu":
        return rmsnorm_reference(x, w, eps) if b is None \
            else layernorm_reference(x, w, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        return _RowNorm.apply(x, w, b, eps)
    return _launch(x, w, b, eps)


def rmsnorm(x, w, eps: float = 1e-5):
    """(..., D) RMSNorm; w (D,)."""
    return _dispatch(x, w, None, eps)


def layernorm(x, w, b, eps: float = 1e-6):
    """(..., D) LayerNorm; w, b (D,)."""
    return _dispatch(x, w, b, eps)

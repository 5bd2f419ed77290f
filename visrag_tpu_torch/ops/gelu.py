"""Exact-erf GELU, correctly rounded to bf16.

Counterpart of visrag_tpu/ops/gelu.py (fast_gelu), the activation of the
SigLIP ViT's MLP (timm nn.GELU: the erf form, not the tanh one). The JAX
function evaluates a minimax polynomial in fp32 whose every bf16 result
equals float64 erf-GELU rounded to bf16. F.gelu in bf16 does not: it
computes 0.5·x·(1 + erf(x/√2)) in fp32, which cancels in the negative
tail (x below about -3) and overflows for |x| near the fp32 maximum, and
so differs from the JAX function on 334 of the 65,536 bf16 patterns
(tests/test_torch_port_utils.py). The port's ViT therefore runs this
function.

A bf16 input has only 65,536 values, so the bf16 path is a lookup: a
table of every pattern's GELU, computed once per device in float64 as
0.5·x·erfc(-x/√2) (no cancellation on either side) and rounded once to
bf16, indexed by the input's bits. That is exact by construction on
every input, and it moves fewer bytes than an fp32 evaluation (an int32
index and a gather, against five fp32 passes). Other dtypes are
computed in fp32 by the same erfc formula and rounded once to the input
dtype. Specials: +inf → +inf, -inf → -0, nan → nan, as the JAX function
gives them.

The gradient is the exact gelu'(x) = Φ(x) + x·φ(x), F.gelu's backward
(the JAX function's is its polynomial's derivative, within 1e-4 relative
of it). Plain PyTorch: the JAX function is plain XLA, not a Pallas
kernel.
"""

from __future__ import annotations

import functools
import math

import torch

INV_SQRT2 = 0.7071067811865476


def gelu_fp32(x):
    """0.5·x·erfc(-x/√2) in fp32, rounded once to x's dtype."""
    xf = x.float()
    return (xf * 0.5 * torch.special.erfc(xf * -INV_SQRT2)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def bf16_table(device) -> torch.Tensor:
    """(65536,) bf16: the GELU of every bf16 bit pattern at the pattern's
    index (its bits as a uint16), from float64."""
    bits = torch.arange(65536, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).double()
    y = x * 0.5 * torch.special.erfc(x * -INV_SQRT2)
    y = torch.where(x == -math.inf, torch.full_like(y, -0.0), y)
    return y.float().bfloat16().to(device)


def _lookup(x):
    """The table's entries at x's bit patterns: one int32 index pass and
    one index_select (which takes int32 indices as they are)."""
    idx = x.view(torch.uint16).to(torch.int32).reshape(-1)
    return torch.index_select(bf16_table(x.device), 0, idx).reshape(x.shape)


class _BF16Gelu(torch.autograd.Function):
    """The table forward; the backward is F.gelu's own (one fused pass,
    grad · (Φ(x) + x·φ(x)) in fp32)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _lookup(x)

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        return torch.ops.aten.gelu_backward(grad, x)


def fast_gelu(x):
    """Exact-erf GELU: bf16 through the table (correctly rounded), other
    dtypes in fp32 rounded once to x.dtype; differentiable."""
    if x.dtype != torch.bfloat16:
        return gelu_fp32(x)
    if torch.is_grad_enabled() and x.requires_grad:
        return _BF16Gelu.apply(x)
    return _lookup(x)

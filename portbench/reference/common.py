"""Plain PyTorch building blocks of the references, in float32.

Nothing here imports the program. Matrix products run with TF32 off
(`fp32_matmuls`). `linear` can also run a control in a precision below
bf16: activations quantized per row and weights per output channel,
symmetric, to int8 or fp8 e4m3, then dequantized and multiplied in
float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def fp32_matmuls():
    """TF32 off for matmuls and convolutions while the block runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def quant_rows(x: torch.Tensor, low: str = "int8") -> torch.Tensor:
    """Symmetric round trip of each row of x (last dim) through int8
    (±127) or fp8 e4m3 (±448), scaled to the row's largest magnitude."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12)
    if low == "fp8":
        scale = amax / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    scale = amax / 127.0
    return torch.round(x / scale).clamp(-127, 127) * scale


class Weights:
    """Float32 views of the benchmark's weights, converted on use.
    `low` ("int8" or "fp8") runs every linear layer as the control: its
    activations (per row) and weights (per output channel) rounded to that
    type, the product in float32."""

    def __init__(self, state: dict, device, low: str = None):
        self.state = state
        self.device = device
        self.low = low

    def __call__(self, name: str) -> torch.Tensor:
        return self.state[name].to(self.device, torch.float32)

    def has(self, name: str) -> bool:
        return name in self.state

    def linear(self, x, prefix: str, quant: bool = True):
        """x @ W.T + b of the layer `prefix` (its bias where it has one)."""
        w = self(prefix + ".weight")
        b = self(prefix + ".bias") if self.has(prefix + ".bias") else None
        if self.low and quant:
            x = quant_rows(x, self.low)
            w = quant_rows(w, self.low)
        return F.linear(x, w, b)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def rotate_half(x):
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def masked_attention(q, k, v, allow, scale):
    """q (H, Sq, D), k/v (H, Sk, D), allow (Sq, Sk) bool → (Sq, H, D).
    Scores and softmax in float32; query blocks keep the score matrix
    under a gigabyte."""
    h, sq, d = q.shape
    block = max(1, int(2 ** 28 // max(1, h * k.shape[1])))
    out = []
    for lo in range(0, sq, block):
        s = torch.einsum("hqd,hkd->hqk", q[:, lo:lo + block], k) * scale
        s = s.masked_fill(~allow[None, lo:lo + block], float("-inf"))
        out.append(torch.einsum("hqk,hkd->qhd", torch.softmax(s, -1), v))
    return torch.cat(out, dim=0)

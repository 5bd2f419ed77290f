"""Analytic FLOPs and model FLOPs utilization (MFU).

Counterpart of visrag_tpu/utils/flops.py (the reference's FlopsCounter):
dense ≈ 2·N per token forward and 6·N training, attention from Σ seq²,
and a peak table keyed by the card's name, torch.cuda.get_device_name().
The JAX table holds TPU generations and falls back to v5e for an unknown
one; this one raises for a card it does not hold.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# dense bf16 TFLOP/s of one device, without sparsity (NVIDIA's data sheet,
# at the card's full power limit; "cpu" is a placeholder for CPU runs)
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,
    "cpu": 1.0,
}


def detect_peak_tflops(name: Optional[str] = None) -> float:
    """The peak of `name` (default: torch.cuda.get_device_name(), or "cpu"
    without a card); raises for a device the table does not hold."""
    if name is None:
        name = torch.cuda.get_device_name() if torch.cuda.is_available() \
            else "cpu"
    if name not in PEAK_TFLOPS:
        raise KeyError(f"no peak TFLOP/s for device {name!r} (have "
                       f"{sorted(PEAK_TFLOPS)})")
    return PEAK_TFLOPS[name]


@dataclasses.dataclass
class ModelDims:
    num_params: float                     # dense params (count)
    hidden_size: int
    num_layers: int
    num_heads: int

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


def forward_flops(dims: ModelDims, total_tokens: int,
                  sum_seq_sq: Optional[float] = None) -> float:
    """2·N·tokens dense + 4·Σseq²·hidden·layers attention (forward)."""
    dense = 2.0 * dims.num_params * total_tokens
    attn = 0.0
    if sum_seq_sq:
        attn = 4.0 * sum_seq_sq * dims.hidden_size * dims.num_layers
    return dense + attn


def training_flops(dims: ModelDims, total_tokens: int,
                   sum_seq_sq: Optional[float] = None) -> float:
    """6·N·tokens dense + 12·Σseq²·d·h·L attention."""
    dense = 6.0 * dims.num_params * total_tokens
    attn = 0.0
    if sum_seq_sq:
        attn = 12.0 * sum_seq_sq * dims.head_dim * dims.num_heads \
            * dims.num_layers
    return dense + attn


def mfu(flops: float, seconds: float, n_chips: int = 1,
        peak_tflops: Optional[float] = None) -> float:
    peak = (peak_tflops or detect_peak_tflops()) * 1e12
    return flops / max(seconds, 1e-9) / (peak * n_chips)

"""Random weights, made by the benchmark on the device from the seed.

All leaves of a model live in one flat buffer in the type they are served
in, filled by one `normal_` draw from a `torch.Generator` on the device and
scaled family by family (a family's leaves are contiguous, so each is one
call). The program gets them as its parameters (views of the buffer, each
256-byte aligned); the plain reference reads the same tensors by name.

Families: 2-D weights N(0, 1/in) truncated at 2σ (the LM head and the
embeddings at 0.02), 1-D norm weights 1 + 0.02·N, biases and other 1-D
leaves 0.02·N; the ViT's position table and the resampler's queries
0.02·N; the resampler's query position table the fixed 2-D sin-cos table
of MiniCPM-V.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

ALIGN = 128          # elements between leaf starts


def sincos_2d(embed_dim: int, grid: int) -> np.ndarray:
    """MAE 2-D sin-cos table (grid², embed_dim): the first half encodes the
    column, the second the row."""
    def one_dim(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64)
                                / (dim / 2.0))
        out = pos.reshape(-1).astype(np.float64)[:, None] * omega[None]
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)
    rows, cols = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    return np.concatenate([one_dim(embed_dim // 2, cols),
                           one_dim(embed_dim // 2, rows)], axis=1)


def family(name: str, shape: Tuple[int, ...], owner: nn.Module):
    """→ (kind, scale) of one leaf."""
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("resampler.pos_embed"):
        return "sincos", 0.0
    if leaf in ("pos_embed", "query") or isinstance(owner, nn.Embedding):
        return "normal", 0.02
    if name.endswith("lm_head.weight"):
        return "normal", 0.02
    if len(shape) == 2:
        return "trunc", round(shape[1] ** -0.5, 8)
    if "norm" in type(owner).__name__.lower() and leaf == "weight":
        return "one", 0.02
    return "normal", 0.02


def make_weights(model: nn.Module, seed: int, device, dtype):
    """Fill `model` (built on the meta device) with the seed's weights, in
    place: every parameter becomes a view of one flat buffer on `device`
    (kept as model.portbench_flat). → the model, in eval mode."""
    leaves = []
    for mod_name, mod in model.named_modules():
        for pname, p in mod._parameters.items():
            if p is None:
                continue
            full = f"{mod_name}.{pname}" if mod_name else pname
            leaves.append((family(full, tuple(p.shape), mod), full, mod,
                           pname, tuple(p.shape)))
    leaves.sort(key=lambda t: (t[0][0], t[0][1]))
    offsets, total = [], 0
    for _, _, _, _, shape in leaves:
        offsets.append(total)
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat.normal_(generator=gen)
    spans: Dict[tuple, list] = {}
    for (fam, _, _, _, shape), off in zip(leaves, offsets):
        lo, hi = spans.setdefault(fam, [off, off])
        spans[fam] = [min(lo, off), max(hi, off + math.prod(shape))]
    with torch.no_grad():
        for (kind, scale), (lo, hi) in spans.items():
            part = flat[lo:hi]
            if kind == "trunc":
                part.mul_(scale).clamp_(-2 * scale, 2 * scale)
            elif kind == "one":
                part.mul_(scale).add_(1.0)
            else:
                part.mul_(scale)
    for (fam, full, mod, pname, shape), off in zip(leaves, offsets):
        view = flat[off:off + math.prod(shape)].view(shape)
        if fam[0] == "sincos":
            grid = int(round(shape[0] ** 0.5))
            view.copy_(torch.from_numpy(sincos_2d(shape[1], grid)))
        mod._parameters[pname] = nn.Parameter(view, requires_grad=False)
    model.eval()
    model.portbench_flat = flat
    return model


def fingerprint(model: nn.Module) -> int:
    """An exact checksum of the weights make_weights gave `model` (the sum
    of their bit patterns): the reference judges only a program that left
    them as they were made."""
    flat = model.portbench_flat
    bits = flat.view(torch.int16 if flat.element_size() == 2 else torch.int32)
    block = 1 << 26
    return sum(int(bits[lo:lo + block].sum(dtype=torch.int64))
               for lo in range(0, bits.numel(), block))


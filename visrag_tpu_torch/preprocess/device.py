"""Device-side finish of raw encode batches.

Counterpart of visrag_tpu/preprocess/device.py. The host stops at uint8
patch pixels and per-slice grid dims
(`preprocess.pipeline.build_encode_batch(..., device_mode=True)`);
this module uploads them and, on the device,

  * normalises pixels: (x / 255 - 0.5) / 0.5 in fp32;
  * builds each slice's bicubic pos-resample operator from the
    `transform.bicubic_table` constant: A[p] = T[gh, p // gw],
    B[p] = T[gw, p % gw], operator = A ⊗ B, shape (N, P, G²).

`finish_vision_batch` does the same for the vision part alone, for the
generation composites: MiniCPM-V 2.6's prompts ship uint8 pixels, since at
its 70² pos grid a host-built dense operator is about 23 MB fp32 a slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.visrag_ret import EncodeBatch
from ..utils import profiling
from .transform import bicubic_table


_TABLE_CACHE = {}


def cached_bicubic_table(src_grid: int) -> np.ndarray:
    """Per-process cache of the bicubic operator stack (18 MB at grid 70);
    treat the returned array as immutable."""
    if src_grid not in _TABLE_CACHE:
        _TABLE_CACHE[src_grid] = bicubic_table(src_grid)
    return _TABLE_CACHE[src_grid]


def pos_table_tensor(src_grid: int, device) -> torch.Tensor:
    """The bicubic table as a device tensor; upload it once per run and pass
    it to every finish_encode_batch / finish_vision_batch call."""
    return torch.from_numpy(cached_bicubic_table(src_grid)).to(device)


def _put(x, device):
    x = torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else x
    return x.to(device, non_blocking=True)


def finish_encode_batch(raw: dict, pos_table: torch.Tensor) -> EncodeBatch:
    """raw: numpy dict from build_encode_batch(device_mode=True) (or tensors).
    pos_table: pos_table_tensor(src_grid, device). → EncodeBatch on the
    table's device. While traced, counts the batch's fill from the raw
    masks: `preprocess.tokens` (valid tokens, token slots) and
    `preprocess.patches` (valid patches, slice slots x patch bucket)."""
    device = pos_table.device

    def put(name):
        return _put(raw[name], device)

    if profiling.recording():
        profiling.count("preprocess.tokens", _fill(raw["attention_mask"]))
        profiling.count("preprocess.patches", _fill(raw["patch_mask"]))
    with profiling.span("preprocess.finish"):
        pixels = put("pixels")
        grid_h, grid_w = put("grid_h"), put("grid_w")
        patches = (pixels.float() / 255.0 - 0.5) / 0.5
        pos_matrix = _pos_operators(pos_table, grid_h, grid_w,
                                    pixels.shape[1])
        return EncodeBatch(
            input_ids=put("input_ids"), attention_mask=put("attention_mask"),
            patches=patches, patch_mask=put("patch_mask"),
            pos_matrix=pos_matrix, grid_h=grid_h, grid_w=grid_w,
            slot_map=put("slot_map"))


def _fill(mask) -> tuple:
    """(nonzero entries, entries) of a mask, numpy or tensor."""
    n = int(np.count_nonzero(mask)) if isinstance(mask, np.ndarray) \
        else int(torch.count_nonzero(mask))
    return n, int(np.prod(mask.shape))


def _pos_operators(table, gh, gw, p: int):
    """(N,) grids → dense (N, p, G²) pos-resample operators; rows past
    gh*gw are zero."""
    maxd, g = table.shape[1], table.shape[2]
    gh, gw = gh.long(), gw.long()
    rows = torch.arange(p, device=table.device)
    gw_safe = gw.clamp(min=1)[:, None]
    ih = torch.clamp(torch.div(rows[None, :], gw_safe, rounding_mode="floor"),
                     max=maxd - 1)
    iw = torch.clamp(rows[None, :] % gw_safe, max=maxd - 1)
    valid = rows[None, :] < (gh * gw)[:, None]
    pos_a = table[gh[:, None], ih] * valid[..., None]
    pos_b = table[gw[:, None], iw]
    return torch.einsum("npa,npb->npab", pos_a, pos_b).reshape(
        pos_a.shape[0], p, g * g)


def finish_vision_batch(raw: dict, pos_table: torch.Tensor) -> dict:
    """Vision-only finish: raw {pixels uint8, patch_mask, grid_h, grid_w}
    (numpy or tensors) → {patches fp32, patch_mask, pos_matrix, grid_h,
    grid_w} on the table's device; the same math as finish_encode_batch."""
    device = pos_table.device
    pixels = _put(raw["pixels"], device)
    grid_h, grid_w = _put(raw["grid_h"], device), _put(raw["grid_w"], device)
    return {"patches": (pixels.float() / 255.0 - 0.5) / 0.5,
            "patch_mask": _put(raw["patch_mask"], device),
            "pos_matrix": _pos_operators(pos_table, grid_h, grid_w,
                                         pixels.shape[1]),
            "grid_h": grid_h, "grid_w": grid_w}

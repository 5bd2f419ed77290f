"""Adaptive page-image slicing (MiniCPM-V scheme).

Exact behavioral parity with the reference slicing math
(reference src/openmatch/modeling/modeling_minicpmv/modeling_minicpmv.py:482-609)
— the grid choice and the rounded resize sizes define the token layout and
therefore the embeddings, so the arithmetic (int truncation, round-half-even,
log-ratio argmin with strict '<') is replicated exactly.

Pure geometry here: these functions compute *plans* (sizes, grids, crop boxes);
pixel work happens in transform.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

Size = Tuple[int, int]  # (width, height) — PIL convention


def ensure_divide(length: float, patch_size: int) -> int:
    # round() is Python banker's rounding, same as the reference
    return max(round(length / patch_size) * patch_size, patch_size)


def find_best_resize(original_size: Size, scale_resolution: int,
                     patch_size: int, allow_upscale: bool = False) -> Size:
    width, height = original_size
    if (width * height > scale_resolution * scale_resolution) or allow_upscale:
        r = width / height
        height = int(scale_resolution / math.sqrt(r))
        width = int(height * r)
    return (ensure_divide(width, patch_size), ensure_divide(height, patch_size))


def get_refine_size(original_size: Size, grid: Tuple[int, int],
                    scale_resolution: int, patch_size: int,
                    allow_upscale: bool = False) -> Size:
    width, height = original_size
    grid_x, grid_y = grid
    refine_width = ensure_divide(width, grid_x)
    refine_height = ensure_divide(height, grid_y)
    cell = find_best_resize((refine_width / grid_x, refine_height / grid_y),
                            scale_resolution, patch_size,
                            allow_upscale=allow_upscale)
    return (cell[0] * grid_x, cell[1] * grid_y)


@dataclasses.dataclass
class SlicePlan:
    """Resize/crop plan for one page image."""
    source_size: Size                      # resized overview image
    grid: Optional[Tuple[int, int]]        # (cols, rows) or None if unsliced
    refine_size: Optional[Size]            # full refined image size pre-crop
    crop_boxes: List[Tuple[int, int, int, int]]  # (left, top, right, bottom)

    @property
    def num_slices(self) -> int:
        """Total ViT forward passes: 1 source (+ grid cells)."""
        return 1 + len(self.crop_boxes)


def plan_slices(original_size: Size, max_slice_nums: int = 9,
                scale_resolution: int = 448, patch_size: int = 14,
                never_split: bool = False) -> SlicePlan:
    width, height = original_size
    log_ratio = math.log(width / height)
    ratio = width * height / (scale_resolution * scale_resolution)
    multiple = min(math.ceil(ratio), max_slice_nums)

    if multiple <= 1 or never_split:
        best = find_best_resize(original_size, scale_resolution, patch_size,
                                allow_upscale=True)
        return SlicePlan(source_size=best, grid=None, refine_size=None,
                         crop_boxes=[])

    candidate_nums = [i for i in (multiple - 1, multiple, multiple + 1)
                      if i != 1 and i <= max_slice_nums]
    source_size = find_best_resize(original_size, scale_resolution, patch_size)

    candidate_grids: List[Tuple[int, int]] = []
    for n in candidate_nums:
        m = 1
        while m <= n:
            if n % m == 0:
                candidate_grids.append((m, n // m))
            m += 1

    best_grid, min_error = (1, 1), float("inf")
    for grid in candidate_grids:
        error = abs(log_ratio - math.log(grid[0] / grid[1]))
        if error < min_error:   # strict '<': first-best wins ties, like ref
            best_grid, min_error = grid, error

    refine_size = get_refine_size(original_size, best_grid, scale_resolution,
                                  patch_size, allow_upscale=True)
    # row-major crop boxes over an exact grid (reference split_to_patches)
    gx, gy = best_grid
    cw, ch = refine_size[0] // gx, refine_size[1] // gy
    boxes = [(j * cw, i * ch, (j + 1) * cw, (i + 1) * ch)
             for i in range(gy) for j in range(gx)]
    return SlicePlan(source_size=source_size, grid=best_grid,
                     refine_size=refine_size, crop_boxes=boxes)


def max_patches_bound(max_slice_nums: int = 9, scale_resolution: int = 448,
                      patch_size: int = 14) -> int:
    """Static upper bound on patches per slice for buffer sizing. The resize
    targets ~scale_resolution² pixels; rounding can push each dim up by up to
    patch_size/2, so bound = (grid+1)² where grid = scale_resolution/patch."""
    g = scale_resolution // patch_size  # 32
    return (g + 2) * (g + 2)  # generous: 1156 for 448/14


# Canonical static buffer size: 9×128 lanes. Fits every slice produced by the
# slicing math for aspect ratios up to 48:1 (scanned max = 1116 patches);
# prepare_page clamps more extreme degenerate aspects before planning, a
# documented deviation from the reference that only affects >48:1 images.
MAX_PATCHES = 1152
MAX_ASPECT_RATIO = 48.0


def page_patch_need(size: Size, max_slice_nums: int = 9,
                    scale_resolution: int = 448, patch_size: int = 14,
                    slice_mode: bool = True) -> int:
    """Largest per-slice patch count this page will produce (after the
    prepare_page aspect clamp). Pure geometry — used to pick a per-batch
    patch-buffer bucket smaller than the 48:1 worst case MAX_PATCHES."""
    w, h = size
    ratio = w / h
    if ratio > MAX_ASPECT_RATIO:
        w = int(h * MAX_ASPECT_RATIO)
    elif ratio < 1.0 / MAX_ASPECT_RATIO:
        h = int(w * MAX_ASPECT_RATIO)
    plan = plan_slices((w, h), max_slice_nums, scale_resolution, patch_size,
                       never_split=not slice_mode)
    sw, sh = plan.source_size
    need = (sw // patch_size) * (sh // patch_size)
    if plan.crop_boxes:
        l, t, r, b = plan.crop_boxes[0]   # all grid cells share one size
        need = max(need, ((r - l) // patch_size) * ((b - t) // patch_size))
    return need

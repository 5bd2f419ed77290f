"""Host-side pixel pipeline: resize → normalize → patchify → pos-interp matrix.

Replaces the reference's torchvision transform + timm dynamic-size conv stem
(reference src/openmatch/modeling/modeling_minicpmv/modeling_minicpmv.py:84-92
ToTensor + Normalize(Inception mean/std); timm patch_embed). Output is the
static-shape slice buffer consumed by SiglipViT:

  patches     (MAX_P, 3*ps*ps) float32, rows = row-major patch grid, each row
              the (c, ph, pw)-flattened pixels of one 14×14 patch (conv-weight
              compatible layout)
  mask        (MAX_P,) 1/0
  pos_matrix  (MAX_P, 729) bicubic-antialias resample weights: the timm
              `resample_abs_pos_embed` (pos_embed.py:17-57) expressed as a
              linear operator so arbitrary grids batch in one compiled program
  grid (h, w) patch-grid dims

PIL bicubic resizes keep bit-parity with the reference's preprocessing.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
from PIL import Image

from .slicing import MAX_ASPECT_RATIO, MAX_PATCHES, SlicePlan, plan_slices

INCEPTION_MEAN = (0.5, 0.5, 0.5)
INCEPTION_STD = (0.5, 0.5, 0.5)


def normalize_image(img: Image.Image) -> np.ndarray:
    """PIL → (3, H, W) float32, ToTensor + Inception normalize parity."""
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    arr = (arr - np.array(INCEPTION_MEAN, np.float32)) / np.array(
        INCEPTION_STD, np.float32)
    return arr.transpose(2, 0, 1)


def patchify(arr: np.ndarray, patch_size: int = 14,
             max_patches: int = MAX_PATCHES):
    """(3, H, W) → (max_patches, 3*ps*ps), mask, (grid_h, grid_w).
    Row-major patch order; per-patch layout (c, ph, pw) matching a
    Conv2d(3, D, ps, stride=ps) weight flattened as (D, 3*ps*ps)."""
    c, h, w = arr.shape
    ps = patch_size
    assert h % ps == 0 and w % ps == 0, (h, w)
    gh, gw = h // ps, w // ps
    n = gh * gw
    if n > max_patches:
        raise ValueError(f"slice grid {gh}x{gw}={n} exceeds MAX_PATCHES "
                         f"{max_patches}; clamp aspect ratio upstream")
    p = arr.reshape(c, gh, ps, gw, ps).transpose(1, 3, 0, 2, 4)  # gh,gw,c,ph,pw
    p = p.reshape(n, c * ps * ps)
    out = np.zeros((max_patches, c * ps * ps), np.float32)
    out[:n] = p
    mask = np.zeros((max_patches,), np.int32)
    mask[:n] = 1
    return out, mask, (gh, gw)


def patchify_normalized(arr_u8: np.ndarray, patch_size: int = 14,
                        max_patches: int = MAX_PATCHES):
    """(H, W, 3) uint8 → normalized fp32 patch rows: ToTensor + Inception
    normalize + patchify fused in the native kernel (numpy fallback is
    normalize_image→patchify, bit-identical)."""
    h, w, c = arr_u8.shape
    ps = patch_size
    assert h % ps == 0 and w % ps == 0, (h, w)
    gh, gw = h // ps, w // ps
    n = gh * gw
    if n > max_patches:
        raise ValueError(f"slice grid {gh}x{gw}={n} exceeds MAX_PATCHES")
    out = np.zeros((max_patches, c * ps * ps), np.float32)
    from ..native import patchify_f32_native
    if not patchify_f32_native(arr_u8, ps,
                               np.asarray(INCEPTION_MEAN, np.float32),
                               np.asarray(INCEPTION_STD, np.float32), out):
        arr = (arr_u8.astype(np.float32) / 255.0
               - np.array(INCEPTION_MEAN, np.float32)) / np.array(
                   INCEPTION_STD, np.float32)
        p = arr.transpose(2, 0, 1).reshape(c, gh, ps, gw, ps)
        out[:n] = p.transpose(1, 3, 0, 2, 4).reshape(n, c * ps * ps)
    mask = np.zeros((max_patches,), np.int32)
    mask[:n] = 1
    return out, mask, (gh, gw)


@functools.lru_cache(maxsize=4096)
def _bicubic_resample_matrix_1d(src: int, dst: int) -> np.ndarray:
    """(dst, src) 1-D bicubic-antialias resize operator, exact parity with
    torch F.interpolate(mode='bicubic', antialias=True, align_corners=False)
    as used by timm resample_abs_pos_embed. Extracted by resizing the identity
    (interpolation is linear, separable)."""
    import torch
    import torch.nn.functional as F

    # basis signals along H; W must be ≥2 (torch's antialiased resize
    # degenerates on a singleton spatial axis)
    eye = (torch.eye(src, dtype=torch.float64)
           .view(src, 1, src, 1).expand(src, 1, src, 2).contiguous())
    out = F.interpolate(eye, size=(dst, 2), mode="bicubic", antialias=True,
                        align_corners=False)
    return out[:, 0, :, 0].transpose(0, 1).numpy().astype(np.float64)


def patchify_u8(arr: np.ndarray, patch_size: int = 14,
                max_patches: int = MAX_PATCHES):
    """(H, W, 3) uint8 → (max_patches, 3*ps*ps) uint8, mask, (gh, gw).

    The device-input path: keeps pixels in uint8 (4× less host copy + host→
    device transfer than f32 patches) and defers ToTensor+Inception
    normalization to the jitted step (preprocess.device.finish_encode_batch).
    Patch layout matches patchify: row-major patches, (c, ph, pw) inside.
    Runs the native C++/OpenMP kernel (native/) when the toolchain
    is available — one parallel pass instead of numpy's transpose chain."""
    h, w, c = arr.shape
    ps = patch_size
    assert h % ps == 0 and w % ps == 0, (h, w)
    gh, gw = h // ps, w // ps
    n = gh * gw
    if n > max_patches:
        raise ValueError(f"slice grid {gh}x{gw}={n} exceeds MAX_PATCHES")
    out = np.zeros((max_patches, c * ps * ps), np.uint8)
    from ..native import patchify_u8_native
    if not patchify_u8_native(arr, ps, out):
        p = arr.reshape(gh, ps, gw, ps, c).transpose(0, 2, 4, 1, 3)
        out[:n] = p.reshape(n, c * ps * ps)
    mask = np.zeros((max_patches,), np.int32)
    mask[:n] = 1
    return out, mask, (gh, gw)


def pos_factor_rows(grid_h: int, grid_w: int, src_grid: int = 27,
                    max_patches: int = MAX_PATCHES):
    """Factorized pos-resample operator: per-patch-row 1-D bicubic factors
    (A, B), each (max_patches, src_grid) f32, with
    pos_matrix[p] == outer(A[p], B[p]).reshape(-1) — 27× less host→device
    traffic than the dense (max_patches, src_grid²) matrix; the outer
    product runs on device."""
    wh = _bicubic_resample_matrix_1d(src_grid, grid_h).astype(np.float32)
    ww = _bicubic_resample_matrix_1d(src_grid, grid_w).astype(np.float32)
    n = grid_h * grid_w
    a = np.zeros((max_patches, src_grid), np.float32)
    b = np.zeros((max_patches, src_grid), np.float32)
    rows = np.arange(n)
    a[:n] = wh[rows // grid_w]
    b[:n] = ww[rows % grid_w]
    return a, b


@functools.lru_cache(maxsize=8)
def bicubic_table(src_grid: int = 27, max_dst: int = 256) -> np.ndarray:
    """(max_dst+1, max_dst, src_grid) f32 stack of every 1-D bicubic resize
    operator up to max_dst: table[d, :d] = the (d, src) operator, rows >= d
    zero (max_dst=256 covers the 48:1-aspect worst case: sqrt(1152·48) ≈
    235). A ~7 MB per-process compile-time constant that lets the jitted
    input pipeline
    build pos operators ON DEVICE from (grid_h, grid_w) alone — the batch
    ships no pos factors at all (28 MB/batch at the bench shape; the host
    stops at uint8 pixels + grid dims). Same torch-parity 1-D operators as
    pos_factor_rows, so outputs are bit-identical."""
    out = np.zeros((max_dst + 1, max_dst, src_grid), np.float32)
    for d in range(1, max_dst + 1):
        out[d, :d] = _bicubic_resample_matrix_1d(src_grid, d).astype(
            np.float32)
    return out


@functools.lru_cache(maxsize=4096)
def pos_resample_matrix(grid_h: int, grid_w: int, src_grid: int = 27,
                        max_patches: int = MAX_PATCHES) -> np.ndarray:
    """(max_patches, src_grid²) operator: P @ pos_embed interpolates the
    src_grid×src_grid embedding to (grid_h, grid_w) row-major; padded rows 0."""
    wh = _bicubic_resample_matrix_1d(src_grid, grid_h)   # (gh, src)
    ww = _bicubic_resample_matrix_1d(src_grid, grid_w)   # (gw, src)
    full = np.einsum("hi,wj->hwij", wh, ww).reshape(
        grid_h * grid_w, src_grid * src_grid)
    out = np.zeros((max_patches, src_grid * src_grid), np.float32)
    out[:grid_h * grid_w] = full.astype(np.float32)
    return out


def render_slices(img: Image.Image, plan: SlicePlan) -> List[Image.Image]:
    """Execute a SlicePlan: [source_image] + row-major grid crops."""
    out = [img.resize(plan.source_size, Image.Resampling.BICUBIC)]
    if plan.crop_boxes:
        refined = img.resize(plan.refine_size, Image.Resampling.BICUBIC)
        out.extend(refined.crop(box) for box in plan.crop_boxes)
    return out


def prepare_page(img: Image.Image, *, max_slice_nums: int = 9,
                 scale_resolution: int = 448, patch_size: int = 14,
                 slice_mode: bool = True, src_grid: int = 27,
                 max_patches: int = MAX_PATCHES, device_mode: bool = False):
    """Page image → per-slice static buffers + the slice plan.

    Returns (plan, slices): dicts with patches/mask/pos_matrix/grid_h/grid_w,
    or — with device_mode — pixels (uint8) + factorized pos_a/pos_b for the
    jitted finish_encode_batch step (preprocess.device).
    """
    w, h = img.size
    ratio = w / h
    if ratio > MAX_ASPECT_RATIO or ratio < 1.0 / MAX_ASPECT_RATIO:
        # degenerate aspect: clamp so slices fit the static patch buffer
        if ratio > MAX_ASPECT_RATIO:
            img = img.resize((int(h * MAX_ASPECT_RATIO), h),
                             Image.Resampling.BICUBIC)
        else:
            img = img.resize((w, int(w * MAX_ASPECT_RATIO)),
                             Image.Resampling.BICUBIC)
    plan = plan_slices(img.size, max_slice_nums, scale_resolution, patch_size,
                       never_split=not slice_mode)
    rendered = render_slices(img, plan)
    out = []
    for im in rendered:
        if device_mode:
            arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
            pixels, mask, (gh, gw) = patchify_u8(arr, patch_size, max_patches)
            # pos operators are built ON DEVICE from (gh, gw) + the
            # bicubic_table constant (preprocess.device.finish_encode_batch)
            # — nothing pos-shaped ships with the batch
            out.append(dict(pixels=pixels, mask=mask,
                            grid_h=gh, grid_w=gw))
        else:
            patches, mask, (gh, gw) = patchify_normalized(
                np.asarray(im.convert("RGB"), dtype=np.uint8), patch_size,
                max_patches)
            out.append(dict(
                patches=patches, mask=mask,
                pos_matrix=pos_resample_matrix(gh, gw, src_grid, max_patches),
                grid_h=gh, grid_w=gw))
    return plan, out

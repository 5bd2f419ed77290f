"""Host-side Qwen2.5-VL vision preprocessing → static buffers.

The port's own copy of visrag_tpu/preprocess/qwen_vision.py (numpy and PIL
only): smart resize into a pixel budget, CLIP normalization or raw uint8
patches (device mode: the model normalizes on the card), merge-grouped
patch flattening, per-patch rotary tables, the window permutation, and the
window / per-image SEGMENT IDS that the vision tower's banded attention
(ops/attention_kvgrid.py) reads. Segment ids are contiguous ascending runs
with padding (0) only at the tail, which is what makes each query tile's
key band one contiguous range.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> Tuple[int, int]:
    if max(height, width) / min(height, width) > 200:
        raise ValueError("aspect ratio must be < 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def image_to_patches(img: Image.Image, *, patch_size: int = 14,
                     merge_size: int = 2, temporal_patch_size: int = 2,
                     min_pixels: int = 56 * 56,
                     max_pixels: int = 14 * 14 * 4 * 1280,
                     raw_uint8: bool = False):
    """→ (grid_h*grid_w, 3*t*ps*ps) float32 patches + (t, h, w) grid.
    raw_uint8: skip CLIP normalization and keep uint8 (4× less host→device
    traffic; the model normalizes in-jit — Qwen25VL.encode_images)."""
    w0, h0 = img.size
    h, w = smart_resize(h0, w0, patch_size * merge_size, min_pixels, max_pixels)
    img = img.convert("RGB").resize((w, h), Image.Resampling.BICUBIC)
    if raw_uint8:
        arr = np.asarray(img, np.uint8)
    else:
        arr = np.asarray(img, np.float32) / 255.0
        arr = (arr - np.array(OPENAI_CLIP_MEAN, np.float32)) / np.array(
            OPENAI_CLIP_STD, np.float32)
    arr = arr.transpose(2, 0, 1)                       # (C, H, W)
    frames = np.stack([arr] * temporal_patch_size, 0)  # (T, C, H, W)
    c = 3
    gt = 1
    gh, gw = h // patch_size, w // patch_size
    p = frames.reshape(gt, temporal_patch_size, c, gh // merge_size,
                       merge_size, patch_size, gw // merge_size, merge_size,
                       patch_size)
    p = p.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = p.reshape(gt * gh * gw,
                     c * temporal_patch_size * patch_size * patch_size)
    return (flat if raw_uint8 else flat.astype(np.float32)), (gt, gh, gw)


def video_to_patches(frames: Sequence[Image.Image], *, patch_size: int = 14,
                     merge_size: int = 2, temporal_patch_size: int = 2,
                     min_pixels: int = 56 * 56,
                     max_pixels: int = 14 * 14 * 4 * 1280,
                     raw_uint8: bool = False):
    """Video frames → (gt*gh*gw, 3*tps*ps*ps) patches + (gt, gh, gw) grid.

    The reference feeds videos through qwen_vl_utils.process_vision_info
    (utils/dataset.py:81-85); here frames arrive as PIL images (decoding is
    the caller's concern — see data.datasets.load_video_frames). Frame count
    pads to a temporal_patch_size multiple by repeating the last frame, as
    the HF Qwen2.5-VL processor does."""
    assert len(frames) >= 1
    w0, h0 = frames[0].size
    h, w = smart_resize(h0, w0, patch_size * merge_size, min_pixels,
                        max_pixels)
    arrs = []
    for f in frames:
        f = f.convert("RGB").resize((w, h), Image.Resampling.BICUBIC)
        if raw_uint8:
            a = np.asarray(f, np.uint8)
        else:
            a = np.asarray(f, np.float32) / 255.0
            a = (a - np.array(OPENAI_CLIP_MEAN, np.float32)) / np.array(
                OPENAI_CLIP_STD, np.float32)
        arrs.append(a.transpose(2, 0, 1))
    while len(arrs) % temporal_patch_size:
        arrs.append(arrs[-1])
    stack = np.stack(arrs, 0)                              # (T, C, H, W)
    c = 3
    gt = stack.shape[0] // temporal_patch_size
    gh, gw = h // patch_size, w // patch_size
    p = stack.reshape(gt, temporal_patch_size, c, gh // merge_size,
                      merge_size, patch_size, gw // merge_size, merge_size,
                      patch_size)
    p = p.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = p.reshape(gt * gh * gw,
                     c * temporal_patch_size * patch_size * patch_size)
    return (flat if raw_uint8 else flat.astype(np.float32)), (gt, gh, gw)


def rot_pos_ids(grid_thw: Sequence[Tuple[int, int, int]],
                merge_size: int = 2) -> np.ndarray:
    """(total_patches, 2) per-patch (h, w) ids in merge-grouped order
    (modeling_qwen2_5_vl.py:336-364)."""
    out = []
    for t, h, w in grid_thw:
        hp = np.arange(h)[:, None] * np.ones((1, w), np.int64)
        wp = np.ones((h, 1), np.int64) * np.arange(w)[None, :]

        def group(x):
            x = x.reshape(h // merge_size, merge_size, w // merge_size,
                          merge_size)
            return x.transpose(0, 2, 1, 3).reshape(-1)

        pair = np.stack([group(hp), group(wp)], axis=-1)
        out.append(np.tile(pair, (t, 1)))
    return np.concatenate(out, axis=0)


def window_index(grid_thw: Sequence[Tuple[int, int, int]], *,
                 window_size: int = 112, patch_size: int = 14,
                 merge_size: int = 2):
    """Window permutation over the merged grid + per-window patch counts
    (modeling_qwen2_5_vl.py:365-404). Returns (index, window_sizes) where
    index permutes merge-groups and window_sizes[i] = patches in window i."""
    vit_ws = window_size // merge_size // patch_size
    mu = merge_size ** 2
    idx_all: List[np.ndarray] = []
    win_sizes: List[int] = []
    base = 0
    for t, h, w in grid_thw:
        lh, lw = h // merge_size, w // merge_size
        index = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h = (-lh) % vit_ws
        pad_w = (-lw) % vit_ws
        nh, nw = (lh + pad_h) // vit_ws, (lw + pad_w) // vit_ws
        padded = np.pad(index, ((0, 0), (0, pad_h), (0, pad_w)),
                        constant_values=-100)
        padded = padded.reshape(t, nh, vit_ws, nw, vit_ws)
        padded = padded.transpose(0, 1, 3, 2, 4).reshape(t, nh * nw, vit_ws,
                                                         vit_ws)
        sizes = (padded != -100).sum(axis=(2, 3)).reshape(-1)
        flat = padded.reshape(-1)
        flat = flat[flat != -100]
        idx_all.append(flat + base)
        win_sizes.extend((sizes * mu).tolist())
        base += t * lh * lw
    return np.concatenate(idx_all), [s for s in win_sizes if s > 0]


@dataclasses.dataclass
class QwenVisionBatch:
    patches: np.ndarray       # (S_pad, patch_dim), window-permuted
    rot_cos: np.ndarray       # (S_pad, head_dim)
    rot_sin: np.ndarray       # (S_pad, head_dim)
    seg_window: np.ndarray    # (S_pad,)
    seg_full: np.ndarray      # (S_pad,)
    reverse_index: np.ndarray  # (S_pad // merge²,)
    grid_thw: List[Tuple[int, int, int]]
    n_tokens: int             # merged tokens (image order) before padding


def prepare_vision_batch(images: Sequence[Image.Image], *, head_dim: int,
                         patch_size: int = 14, merge_size: int = 2,
                         temporal_patch_size: int = 2, window_size: int = 112,
                         min_pixels: int = 56 * 56,
                         max_pixels: int = 14 * 14 * 4 * 1280,
                         pad_to: Optional[int] = None,
                         rope_theta: float = 10000.0,
                         device_mode: bool = False) -> QwenVisionBatch:
    """All images → one packed, window-permuted, padded patch stream.

    device_mode=True ships uint8 patches (no CLIP normalization — the model
    normalizes in-jit, Qwen25VL.encode_images): 4× less host→device traffic
    per vision prefill."""
    mu = merge_size ** 2
    flats, grids = [], []
    for img in images:
        if isinstance(img, (list, tuple)):     # a video: a list of frames
            f, g = video_to_patches(
                img, patch_size=patch_size, merge_size=merge_size,
                temporal_patch_size=temporal_patch_size,
                min_pixels=min_pixels, max_pixels=max_pixels,
                raw_uint8=device_mode)
        else:
            f, g = image_to_patches(
                img, patch_size=patch_size, merge_size=merge_size,
                temporal_patch_size=temporal_patch_size,
                min_pixels=min_pixels, max_pixels=max_pixels,
                raw_uint8=device_mode)
        flats.append(f)
        grids.append(g)
    patches = np.concatenate(flats, axis=0)
    total = patches.shape[0]

    pos = rot_pos_ids(grids, merge_size)                  # (total, 2)
    widx, win_sizes = window_index(grids, window_size=window_size,
                                   patch_size=patch_size,
                                   merge_size=merge_size)

    # permute merge-groups into window order
    group_view = patches.reshape(total // mu, mu, -1)
    patches_w = group_view[widx].reshape(total, -1)
    pos_w = pos.reshape(total // mu, mu, 2)[widx].reshape(total, 2)

    # rotary tables: per-axis freqs on head_dim//4 channels, concat, dup
    half = head_dim // 2
    inv_freq = 1.0 / (rope_theta ** (np.arange(0, half, 2, np.float64) / half))
    fh = pos_w[:, 0:1] * inv_freq[None, :]
    fw = pos_w[:, 1:2] * inv_freq[None, :]
    emb = np.concatenate([fh, fw], axis=1)                # (total, head_dim/2)
    emb = np.concatenate([emb, emb], axis=1)              # (total, head_dim)
    rot_cos = np.cos(emb).astype(np.float32)
    rot_sin = np.sin(emb).astype(np.float32)

    # segment ids in window order
    seg_window = np.repeat(np.arange(1, len(win_sizes) + 1), win_sizes)
    img_sizes = [t * h * w for (t, h, w) in grids]
    seg_full_imgorder = np.repeat(np.arange(1, len(grids) + 1), img_sizes)
    seg_full = seg_full_imgorder.reshape(total // mu, mu)[widx].reshape(total)

    pad = 0 if pad_to is None else pad_to - total
    if pad < 0:
        raise ValueError(f"pad_to {pad_to} < total patches {total}")
    S = total + pad

    def padrows(x, value=0.0):
        if pad == 0:
            return x
        return np.concatenate(
            [x, np.full((pad,) + x.shape[1:], value, x.dtype)], axis=0)

    reverse = np.argsort(widx)
    n_tokens = total // mu
    reverse_pad = np.concatenate(
        [reverse, np.full((pad // mu,), n_tokens, np.int64)]) if pad else reverse
    # reverse indices point into window-order merged rows; padded slots point
    # at the first padded merged row (garbage, masked by slot maps)
    return QwenVisionBatch(
        patches=padrows(patches_w),
        rot_cos=padrows(rot_cos), rot_sin=padrows(rot_sin),
        seg_window=padrows(seg_window.astype(np.int32), 0),
        seg_full=padrows(seg_full.astype(np.int32), 0),
        reverse_index=reverse_pad.astype(np.int32),
        grid_thw=grids, n_tokens=n_tokens)


def combine_vision_batches(vbs, merge_size: int = 2):
    """Concatenate per-prompt vision tables into ONE batch table so the RL
    update runs the vision tower once for the whole batch.

    Window/full segment ids and reverse indices are offset per sub-table
    (windows never span prompts, so concatenation with disjoint segment ids
    is exact). Returns (combined dict of arrays, merged-row offsets): a
    prompt's flat slot-map indices shift by its offset — the combined
    embedding table keeps each sub-table's image-order rows (including its
    padded rows) contiguous.
    """
    mu = merge_size ** 2
    arrs = {k: [] for k in ("patches", "rot_cos", "rot_sin", "seg_window",
                            "seg_full", "reverse_index")}
    offsets = []
    row_offset = 0          # merged-token rows (image order)
    w_offset = 0            # window segment ids
    f_offset = 0            # image segment ids
    for vb in vbs:
        get = (lambda k: vb[k]) if isinstance(vb, dict) else \
            (lambda k: getattr(vb, k))
        offsets.append(row_offset)
        sw = np.asarray(get("seg_window"))
        sf = np.asarray(get("seg_full"))
        # The banded kernel's _band_bounds (ops/attention_kvgrid.py) assumes
        # each table's real ids form ONE non-decreasing run with padding (0)
        # only at the tail; an interior zero run (e.g. a pad_to'd sub-table)
        # would silently truncate the K band and drop real attention.
        for name, seg in (("seg_window", sw), ("seg_full", sf)):
            real = seg > 0
            if real.any():
                last = int(np.flatnonzero(real)[-1])
                if not real[:last + 1].all() or \
                        np.any(np.diff(seg[:last + 1]) < 0):
                    raise ValueError(
                        f"combine_vision_batches: {name} must be one "
                        "non-decreasing run of real ids with padding only "
                        "at the tail (pass unpadded per-prompt tables, not "
                        "pad_to'd ones)")
        arrs["patches"].append(np.asarray(get("patches")))
        arrs["rot_cos"].append(np.asarray(get("rot_cos")))
        arrs["rot_sin"].append(np.asarray(get("rot_sin")))
        arrs["seg_window"].append(np.where(sw > 0, sw + w_offset, 0))
        arrs["seg_full"].append(np.where(sf > 0, sf + f_offset, 0))
        arrs["reverse_index"].append(
            np.asarray(get("reverse_index")) + row_offset)
        w_offset += int(sw.max(initial=0))
        f_offset += int(sf.max(initial=0))
        row_offset += sw.shape[0] // mu
    return ({k: np.concatenate(v, axis=0) for k, v in arrs.items()},
            offsets)


def pad_vision_table(table: dict, multiple: int, merge_size: int = 2) -> dict:
    """Pad a (combined) vision table's patch rows up to a bucket so jitted
    consumers compile once per bucket, not per step. Appended rows are
    segment-0 padding; appended reverse entries point at the last (padded)
    merged row, which no slot map references."""
    mu = merge_size ** 2
    rows = table["patches"].shape[0]
    target = -(-rows // multiple) * multiple
    if target == rows:
        return table
    pad = target - rows
    out = {}
    for k in ("patches", "rot_cos", "rot_sin", "seg_window", "seg_full"):
        v = table[k]
        out[k] = np.concatenate(
            [v, np.zeros((pad,) + v.shape[1:], v.dtype)], axis=0)
    out["reverse_index"] = np.concatenate(
        [table["reverse_index"],
         np.full((pad // mu,), target // mu - 1,
                 table["reverse_index"].dtype)])
    return out

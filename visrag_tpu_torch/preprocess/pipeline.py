"""Batch assembly: (text, image) pairs → fixed-shape EncodeBatch arrays.

The TPU-side contract (models/visrag_ret.py EncodeBatch) wants every array
static-shape; this module does the dynamic→static packing on the host:
slices across the whole batch are flattened into one (N_slots, MAX_P, …)
buffer (padded with a dummy slice when text-only), and per-page vision-token
positions are encoded in the (B, S) slot map.

Mirrors the role of the reference's VisRAG_Ret.forward preprocessing
(modeling_visrag_ret.py:86-126) but off the accelerator and threadpooled.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from .slicing import MAX_PATCHES, page_patch_need
from .tokenize import (TokenizerLike, build_page_prompt, build_slot_map,
                       pad_batch, tokenize_prompt)
from .transform import prepare_page

# Per-batch patch-buffer rungs. The ladder bounds jit recompiles (each rung
# compiles the encode step once per process) while reclaiming the pad tax of
# the fixed 48:1-worst-case MAX_PATCHES buffer: typical A4/slide slices need
# only ~1010-1035 patches, and S=1088 vs 1152 measured 30.3 vs 34.3 ms per
# ViT block on v5e (attention is quadratic in S).
PATCH_BUCKETS = (576, 704, 832, 960, 1088, MAX_PATCHES)


def pick_patch_bucket(items, cfg: "PipelineConfig",
                      buckets=PATCH_BUCKETS) -> int:
    """Smallest ladder rung ≥ the largest patch count any slice in `items`
    needs (pure geometry, no pixel work). Pass the result as cfg.max_patches."""
    need = 1
    for _t, im in items:
        if im is None:
            continue
        need = max(need, page_patch_need(
            im.size, cfg.max_slice_nums, cfg.scale_resolution, cfg.patch_size,
            cfg.slice_mode))
    for b in buckets:
        if b >= need:
            return b
    return need  # beyond the ladder: exact (callers size buffers off this)


@dataclasses.dataclass
class PipelineConfig:
    seq_len: int = 2048
    # round the token batch down from the seq_len cap to the batch's actual
    # max length (64-multiple): page prompts are slice-count dependent
    # (~(1+slices)·66 tokens) and the LM is ~25% padding at the fixed cap
    seq_auto: bool = False
    query_num: int = 64
    max_slice_nums: int = 9
    scale_resolution: int = 448
    patch_size: int = 14
    slice_mode: bool = True
    src_grid: int = 27
    max_patches: int = MAX_PATCHES
    max_slices_per_page: int = 10   # 1 source + ≤9 grid cells
    num_workers: int = 8


def _prep_one(args):
    text, image, tok, cfg, device_mode = args
    if image is None:
        prompt = text
        slices = []
        grid = None
    else:
        _plan, slices = prepare_page(
            image, max_slice_nums=cfg.max_slice_nums,
            scale_resolution=cfg.scale_resolution, patch_size=cfg.patch_size,
            slice_mode=cfg.slice_mode, src_grid=cfg.src_grid,
            max_patches=cfg.max_patches, device_mode=device_mode)
        grid = _plan.grid
        prompt = build_page_prompt(tok, text, grid, cfg.query_num)
    ids = tokenize_prompt(tok, prompt, cfg.seq_len)
    return ids, slices


def build_encode_batch(tok: TokenizerLike,
                       items: Sequence[Tuple[str, Optional[Image.Image]]],
                       cfg: Optional[PipelineConfig] = None,
                       n_slice_slots: Optional[int] = None,
                       device_mode: bool = False) -> dict:
    """→ dict of numpy arrays matching EncodeBatch fields.

    n_slice_slots pins the slice-buffer size for shape-stable jit calls
    (e.g. batch_size * max_slices_per_page); defaults to exactly what the
    batch needs (≥1).

    device_mode=True returns the RAW input-pipeline dict instead — uint8
    `pixels` plus per-slice grid dims — for
    preprocess.device.finish_encode_batch to normalize inside the jitted
    encode step, which also rebuilds the pos-resample operators on device
    from the bicubic_table constant (the batch ships NO pos arrays at all):
    ~4× less host copy work and ~37× less host→device transfer than fp32
    patches + dense pos matrices.
    """
    cfg = cfg or PipelineConfig()
    with ThreadPoolExecutor(max_workers=cfg.num_workers) as ex:
        prepped = list(ex.map(_prep_one,
                              [(t, im, tok, cfg, device_mode)
                               for t, im in items]))

    patch_dim = 3 * cfg.patch_size * cfg.patch_size
    total = sum(len(s) for _, s in prepped)
    n_slots = n_slice_slots if n_slice_slots is not None else max(total, 1)
    if total > n_slots:
        raise ValueError(f"batch needs {total} slice slots > {n_slots}")

    if device_mode:
        pixels = np.zeros((n_slots, cfg.max_patches, patch_dim), np.uint8)
    else:
        patches = np.zeros((n_slots, cfg.max_patches, patch_dim), np.float32)
        pos_matrix = np.zeros((n_slots, cfg.max_patches, cfg.src_grid ** 2),
                              np.float32)
    patch_mask = np.zeros((n_slots, cfg.max_patches), np.int32)
    grid_h = np.ones((n_slots,), np.int32)
    grid_w = np.ones((n_slots,), np.int32)

    seq_len = cfg.seq_len
    if cfg.seq_auto:
        longest = max(len(ids) for ids, _ in prepped)
        seq_len = min(cfg.seq_len, -(-longest // 64) * 64)

    id_list = []
    slot_maps = []
    offset = 0
    for ids, slices in prepped:
        id_list.append(ids)
        slot_maps.append(build_slot_map(
            ids, seq_len, getattr(tok, "im_start_id"),
            getattr(tok, "im_end_id"), cfg.query_num, offset))
        for s in slices:
            if device_mode:
                pixels[offset] = s["pixels"]
            else:
                patches[offset] = s["patches"]
                pos_matrix[offset] = s["pos_matrix"]
            patch_mask[offset] = s["mask"]
            grid_h[offset] = s["grid_h"]
            grid_w[offset] = s["grid_w"]
            offset += 1

    input_ids, attention_mask = pad_batch(id_list, seq_len)
    common = dict(input_ids=input_ids, attention_mask=attention_mask,
                  patch_mask=patch_mask, grid_h=grid_h, grid_w=grid_w,
                  slot_map=np.stack(slot_maps, axis=0))
    if device_mode:
        return dict(common, pixels=pixels)
    return dict(common, patches=patches, pos_matrix=pos_matrix)


def build_multi_image_batch(tok: TokenizerLike,
                            images: Sequence[Image.Image],
                            compose,
                            cfg: Optional[PipelineConfig] = None,
                            n_slice_slots: Optional[int] = None,
                            device_mode: bool = False) -> dict:
    """MiniCPM-V 2.6 generation batch: several images in ONE prompt.

    Each image is adaptively sliced; `compose(placeholders) -> str` receives
    one 2.6-format placeholder string per image (ordered; includes
    <image_id> tags when len(images) > 1) and returns the final prompt —
    typically wrapping them plus the question in a chat template. Slices
    from all images are packed into one vision buffer in prompt order, so
    the slot map (which scans both <image> and <slice> regions) lines up
    with the flattened (N_slices, query_num) vision table.

    Returns EncodeBatch-style numpy dict with (1, S) ids/mask/slot_map.
    The reference runs this model via HF remote code
    (visrag_scripts/generate/generate.py:243-267); multi_image task_type
    feeds top-k pages in one prompt (:122-145).

    device_mode=True ships uint8 `pixels` instead of fp32 patches +
    pos_matrix — essential at the 2.6 70² pos grid, where host-built dense
    pos matrices cost ~23 MB fp32 PER SLICE (measured 32 s host build for 2
    pages); the model finishes normalization + pos operators in the jit
    (MiniCPMV26ForGeneration auto-detects raw batches).
    """
    from .tokenize import build_slot_map, image_placeholder_v26

    cfg = cfg or PipelineConfig()
    with ThreadPoolExecutor(max_workers=cfg.num_workers) as ex:
        results = list(ex.map(
            lambda im: prepare_page(
                im, max_slice_nums=cfg.max_slice_nums,
                scale_resolution=cfg.scale_resolution,
                patch_size=cfg.patch_size, slice_mode=cfg.slice_mode,
                src_grid=cfg.src_grid, max_patches=cfg.max_patches,
                device_mode=device_mode),
            images))

    placeholders, all_slices = [], []
    for idx, (plan, slices) in enumerate(results):
        placeholders.append(image_placeholder_v26(
            tok, plan.grid, cfg.query_num,
            image_id=idx if len(images) > 1 else None))
        all_slices.extend(slices)
    prompt = compose(placeholders)
    # Qwen2-family tokenizers have no BOS (chatml frames the turn instead)
    ids = tokenize_prompt(tok, prompt, cfg.seq_len,
                          add_bos=getattr(tok, "bos_id", None) is not None)

    patch_dim = 3 * cfg.patch_size * cfg.patch_size
    total = len(all_slices)
    n_slots = n_slice_slots if n_slice_slots is not None else max(total, 1)
    if total > n_slots:
        raise ValueError(f"batch needs {total} slice slots > {n_slots}")
    if device_mode:
        pixels = np.zeros((n_slots, cfg.max_patches, patch_dim), np.uint8)
    else:
        patches = np.zeros((n_slots, cfg.max_patches, patch_dim), np.float32)
        pos_matrix = np.zeros((n_slots, cfg.max_patches, cfg.src_grid ** 2),
                              np.float32)
    patch_mask = np.zeros((n_slots, cfg.max_patches), np.int32)
    grid_h = np.ones((n_slots,), np.int32)
    grid_w = np.ones((n_slots,), np.int32)
    for i, s in enumerate(all_slices):
        if device_mode:
            pixels[i] = s["pixels"]
        else:
            patches[i] = s["patches"]
            pos_matrix[i] = s["pos_matrix"]
        patch_mask[i] = s["mask"]
        grid_h[i] = s["grid_h"]
        grid_w[i] = s["grid_w"]

    seq = len(ids)
    row = np.zeros((seq,), np.int32)
    row[:] = ids
    slot_map = build_slot_map(
        row, seq, getattr(tok, "im_start_id"), getattr(tok, "im_end_id"),
        cfg.query_num, 0,
        extra_pairs=[(getattr(tok, "slice_start_id"),
                      getattr(tok, "slice_end_id"))])
    n_regions = int((slot_map >= 0).sum()) // max(cfg.query_num, 1)
    if total and n_regions != total:
        raise ValueError(
            f"prompt has {n_regions} vision regions but {total} slices — "
            "placeholder text and slicing disagree (truncated prompt?)")
    out = {"input_ids": ids[None, :], "attention_mask":
           np.ones((1, seq), np.int32), "patch_mask": patch_mask,
           "grid_h": grid_h, "grid_w": grid_w, "slot_map": slot_map[None, :]}
    if device_mode:
        out["pixels"] = pixels
    else:
        out["patches"] = patches
        out["pos_matrix"] = pos_matrix
    return out

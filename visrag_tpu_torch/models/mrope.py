"""Qwen2.5-VL 3-D multimodal RoPE (mrope).

Counterpart of visrag_tpu/models/mrope.py. `get_rope_index` is the host
numpy computation of the (t, h, w) position ids (text tokens advance all
three streams together; each image's tokens get a constant t and an (h, w)
grid at merged resolution; after an image the offset jumps to its max + 1).
`mrope_cos_sin` builds the rotary tables with the head_dim/2 frequency
channels split into mrope_section = [t, h, w] chunks, each driven by its
own stream; `apply_rope_cos_sin` rotates q and k in fp32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def get_rope_index(input_ids: np.ndarray,
                   image_grid_thw: Sequence[Tuple[int, int, int]],
                   image_token_id: int, spatial_merge_size: int = 2,
                   attention_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """(S,) ids for ONE sequence → (3, S) t/h/w position ids.

    image_grid_thw: per image (t, h, w) in ViT-patch units (pre-merge); the
    i-th run of image_token_id consumes t*(h/m)*(w/m) tokens."""
    s = len(input_ids)
    pos = np.zeros((3, s), np.int64)
    m = spatial_merge_size
    img_idx = 0
    offset = 0
    i = 0
    while i < s:
        if input_ids[i] == image_token_id:
            t, h, w = image_grid_thw[img_idx]
            lh, lw = h // m, w // m
            n = t * lh * lw
            tt = np.repeat(np.arange(t), lh * lw)
            hh = np.tile(np.repeat(np.arange(lh), lw), t)
            ww = np.tile(np.arange(lw), t * lh)
            pos[0, i:i + n] = offset + tt
            pos[1, i:i + n] = offset + hh
            pos[2, i:i + n] = offset + ww
            offset = pos[:, i:i + n].max() + 1
            i += n
            img_idx += 1
        else:
            pos[:, i] = offset
            offset += 1
            i += 1
    if attention_mask is not None:
        pos[:, attention_mask == 0] = 1  # HF sets masked positions to 1
    return pos


def mrope_cos_sin(positions, inv_freq, mrope_section: Sequence[int]):
    """positions (3, B, S) int → cos/sin (B, S, head_dim) fp32, sections
    interleaved as in HF apply_multimodal_rotary_pos_emb. inv_freq
    (head_dim/2,); mrope_section sums to head_dim/2."""
    freqs = positions[..., None].float() * inv_freq.float()    # (3,B,S,hd/2)
    starts = np.cumsum([0] + list(mrope_section))
    half = torch.cat([freqs[i % 3, :, :, starts[i]:starts[i + 1]]
                      for i in range(len(mrope_section))], dim=-1)
    emb = torch.cat([half, half], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope_cos_sin(q, k, cos, sin):
    """q, k (B, S, H, D); cos/sin (B, S, D). fp32 rotation, cast back."""
    cos = cos[:, :, None, :].float()
    sin = sin[:, :, None, :].float()
    qf, kf = q.float(), k.float()
    return ((qf * cos + _rotate_half(qf) * sin).to(q.dtype),
            (kf * cos + _rotate_half(kf) * sin).to(k.dtype))

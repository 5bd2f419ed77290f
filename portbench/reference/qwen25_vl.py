"""Plain float32 Qwen2.5-VL: the vision tower, the text model's forward
over a prompt and the tokens served after it, and the judgement of served
greedy tokens.

From raw inputs: each page's uint8 image and the request's token ids. The
resize into the pixel budget, the CLIP normalisation, the patch layout
(c, t, ph, pw with the frame doubled), the 2 × 2 merge order, the rotary
angles of each patch's (row, column), the windows of the window layers
(8 × 8 patches of one image; the full layers see the whole image), the
mrope positions (text advances all three streams; an image's tokens take
its (row, column) grid at merged resolution) and the slot of each vision
token are worked out here again. Windowed attention is a mask on the
image's own order: no permutation is needed.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from .common import Weights, fp32_matmuls, masked_attention, rms_norm, \
    rotate_half

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def budget_size(h: int, w: int, factor: int, min_px: int, max_px: int):
    """(h, w) rounded to the factor and brought into [min_px, max_px]."""
    hb, wb = round(h / factor) * factor, round(w / factor) * factor
    if hb * wb > max_px:
        beta = math.sqrt(h * w / max_px)
        hb = max(factor, math.floor(h / beta / factor) * factor)
        wb = max(factor, math.floor(w / beta / factor) * factor)
    elif hb * wb < min_px:
        beta = math.sqrt(min_px / (h * w))
        hb = math.ceil(h * beta / factor) * factor
        wb = math.ceil(w * beta / factor) * factor
    return hb, wb


def image_patches(img: Image.Image, v: dict, min_px: int, max_px: int):
    """→ patches (gh·gw, 3·t·p·p) in 2 × 2 merge order, the (row, col)
    of each, and (gh, gw)."""
    p, m, t = v["patch_size"], v["spatial_merge_size"], \
        v["temporal_patch_size"]
    w0, h0 = img.size
    h, w = budget_size(h0, w0, p * m, min_px, max_px)
    a = np.asarray(img.convert("RGB").resize((w, h), Image.Resampling.BICUBIC),
                   np.float32) / 255.0
    a = (a - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD,
                                                               np.float32)
    gh, gw = h // p, w // p
    # (gh/m, m, p, gw/m, m, p, c) → (gh/m, gw/m, m, m, c, p, p)
    x = a.reshape(gh // m, m, p, gw // m, m, p, 3).transpose(0, 3, 1, 4, 6,
                                                             2, 5)
    x = np.repeat(x[:, :, :, :, :, None], t, axis=5)      # the frame doubled
    patches = torch.from_numpy(np.ascontiguousarray(x).reshape(gh * gw, -1))
    r = np.arange(gh).reshape(gh // m, m)[:, None, :, None]
    c = np.arange(gw).reshape(gw // m, m)[None, :, None, :]
    rows = np.broadcast_to(r, (gh // m, gw // m, m, m)).reshape(-1)
    cols = np.broadcast_to(c, (gh // m, gw // m, m, m)).reshape(-1)
    return patches, torch.from_numpy(rows.copy()), \
        torch.from_numpy(cols.copy()), (gh, gw)


def tower(W: Weights, cfg: dict, images: List[Image.Image], min_px: int,
          max_px: int):
    """The vision tower on each image → ([(tokens_i, out_hidden)], the
    (gh, gw) patch grid of each)."""
    v = cfg["vision_config"]
    e, heads = v["hidden_size"], v["num_heads"]
    d = e // heads
    m = v["spatial_merge_size"]
    win = v["window_size"] // v["patch_size"]          # patches a side
    full = set(v["fullatt_block_indexes"])
    eps = 1e-6
    half = d // 2
    inv = 1.0 / (10000.0 ** (torch.arange(0, half, 2, dtype=torch.float64)
                             / half))
    outs, grids = [], []
    for img in images:
        x, rows, cols, (gh, gw) = image_patches(img, v, min_px, max_px)
        n = x.shape[0]
        ang = torch.cat([rows[:, None].double() * inv[None],
                         cols[:, None].double() * inv[None]], dim=1)
        ang = torch.cat([ang, ang], dim=1)
        cos = ang.cos().float().to(W.device)[:, None]
        sin = ang.sin().float().to(W.device)[:, None]
        wid = (rows // win) * (-(-gw // win)) + cols // win
        wid = wid.to(W.device)
        allow_win = wid[:, None] == wid[None, :]
        allow_full = torch.ones(n, n, dtype=torch.bool, device=W.device)
        x = W.linear(x.to(W.device), "visual.patch_embed")
        for i in range(v["depth"]):
            b = f"visual.blocks.{i}."
            y = rms_norm(x, W(b + "norm1.weight"), eps)
            q, k, vv = W.linear(y, b + "attn.qkv").reshape(n, 3, heads,
                                                           d).unbind(1)
            q = q * cos + rotate_half(q) * sin
            k = k * cos + rotate_half(k) * sin
            o = masked_attention(q.transpose(0, 1), k.transpose(0, 1),
                                 vv.transpose(0, 1),
                                 allow_full if i in full else allow_win,
                                 d ** -0.5)
            x = x + W.linear(o.reshape(n, e), b + "attn.proj")
            y = rms_norm(x, W(b + "norm2.weight"), eps)
            x = x + W.linear(F.silu(W.linear(y, b + "mlp.gate_proj"))
                             * W.linear(y, b + "mlp.up_proj"),
                             b + "mlp.down_proj")
        y = rms_norm(x, W("visual.merger.ln_q.weight"), eps).reshape(
            n // (m * m), -1)
        y = W.linear(F.gelu(W.linear(y, "visual.merger.mlp.0")),
                     "visual.merger.mlp.2")
        outs.append(y)
        grids.append((gh, gw))
    return outs, grids


def mrope_positions(ids: Sequence[int], grids, image_token: int,
                    merge: int) -> torch.Tensor:
    """(3, n) t/h/w positions of a prompt whose i-th run of image tokens
    is image i at merged grid grids[i] // merge."""
    pos = np.zeros((3, len(ids)), np.int64)
    nxt, img, i = 0, 0, 0
    ids = list(ids)
    while i < len(ids):
        if ids[i] == image_token:
            gh, gw = grids[img][0] // merge, grids[img][1] // merge
            r, c = np.divmod(np.arange(gh * gw), gw)
            pos[0, i:i + gh * gw] = nxt
            pos[1, i:i + gh * gw] = nxt + r
            pos[2, i:i + gh * gw] = nxt + c
            nxt = nxt + max(gh, gw)
            i += gh * gw
            img += 1
        else:
            pos[:, i] = nxt
            nxt += 1
            i += 1
    return torch.from_numpy(pos)


def text_logits(W: Weights, cfg: dict, ids: Sequence[int], vision_rows,
                positions: torch.Tensor, first: int) -> torch.Tensor:
    """Causal forward over `ids` (vision rows at the image tokens, in
    order) → float32 logits at positions first .. len(ids) - 1."""
    heads, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    e = cfg["hidden_size"]
    d = e // heads
    eps = cfg["rms_norm_eps"]
    ids_t = torch.as_tensor(list(ids), device=W.device)
    n = len(ids_t)
    x = W("model.embed_tokens.weight")[ids_t]
    is_img = ids_t == cfg["image_token_id"]
    if is_img.any():
        x[is_img] = torch.cat(vision_rows).to(x)
    section = cfg["rope_scaling"]["mrope_section"]
    inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(0, d, 2,
                                                    dtype=torch.float64) / d))
    ang = positions.double()[:, :, None] * inv[None, None]      # (3, n, d/2)
    parts, lo = [], 0
    for j, size in enumerate(list(section) * 2):
        parts.append(torch.cat([ang, ang], -1)[j % 3, :, lo:lo + size])
        lo += size
    ang = torch.cat(parts, dim=-1)
    cos = ang.cos().float().to(W.device)[:, None]
    sin = ang.sin().float().to(W.device)[:, None]
    allow = torch.ones(n, n, dtype=torch.bool, device=W.device).tril()
    rep = heads // kvh
    for i in range(cfg["num_hidden_layers"]):
        b = f"model.layers.{i}."
        y = rms_norm(x, W(b + "input_layernorm.weight"), eps)
        q = W.linear(y, b + "self_attn.q_proj").reshape(n, heads, d)
        k = W.linear(y, b + "self_attn.k_proj").reshape(n, kvh, d)
        v = W.linear(y, b + "self_attn.v_proj").reshape(n, kvh, d)
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        o = torch.empty(n, heads, d, device=W.device)
        for g in range(kvh):
            hs = slice(g * rep, (g + 1) * rep)
            o[:, hs] = masked_attention(
                q[:, hs].transpose(0, 1),
                k[:, g:g + 1].expand(n, rep, d).transpose(0, 1),
                v[:, g:g + 1].expand(n, rep, d).transpose(0, 1),
                allow, d ** -0.5)
        x = x + W.linear(o.reshape(n, e), b + "self_attn.o_proj")
        y = rms_norm(x, W(b + "post_attention_layernorm.weight"), eps)
        x = x + W.linear(F.silu(W.linear(y, b + "mlp.gate_proj"))
                         * W.linear(y, b + "mlp.up_proj"), b + "mlp.down_proj")
    y = rms_norm(x[first:], W("model.norm.weight"), eps)
    if cfg.get("tie_word_embeddings"):
        return y @ W("model.embed_tokens.weight").T
    return W.linear(y, "lm_head", quant=False)


def processed(logits: torch.Tensor, ids: Sequence[int], prompt_len: int,
              penalty: float, bias: dict) -> torch.Tensor:
    """The logits a greedy request chooses from at each served position:
    the logit bias added, then every token seen so far (the prompt's and
    the ones served before it) divided by the penalty if positive, else
    multiplied by it. logits[j] is the position prompt_len - 1 + j."""
    out = logits.clone()
    for t, b in bias.items():
        out[:, t] += b
    ids_t = torch.as_tensor(list(ids), device=logits.device)
    seen = torch.zeros(logits.shape, dtype=torch.bool, device=logits.device)
    seen[:, ids_t[:prompt_len]] = True
    for j in range(1, logits.shape[0]):
        seen[j:, ids_t[prompt_len + j - 1]] = True
    pen = torch.where(out > 0, out / penalty, out * penalty)
    return torch.where(seen, pen, out)


@torch.no_grad()
def served_logits(state: dict, cfg: dict, request: dict, served, device,
                  low: str = None) -> torch.Tensor:
    """The processed logits of every served position of one request:
    request has 'images' (PIL), 'input_ids', 'min_pixels', 'max_pixels',
    'penalty', 'bias' ({token: bias}); low: "int8" or "fp8" runs the
    linear layers in that precision (the control). → (len(served),
    vocab) float32."""
    W = Weights(state, device, low=low)
    with fp32_matmuls():
        rows, grids = tower(W, cfg, request["images"], request["min_pixels"],
                            request["max_pixels"])
        prompt = list(request["input_ids"])
        ids = prompt + list(served[:-1])
        pos = mrope_positions(prompt, grids, cfg["image_token_id"],
                              cfg["vision_config"]["spatial_merge_size"])
        nxt = int(pos.max()) + 1
        gen = torch.arange(nxt, nxt + len(served) - 1)
        pos = torch.cat([pos, gen[None].expand(3, -1)], dim=1)
        logits = text_logits(W, cfg, ids, rows, pos, len(prompt) - 1)
        return processed(logits, prompt + list(served), len(prompt),
                         request["penalty"], request["bias"])


def token_gaps(ref: torch.Tensor, chosen) -> torch.Tensor:
    """How far below the reference's best each chosen token lies."""
    idx = torch.as_tensor(list(chosen), device=ref.device)[:, None]
    return ref.max(dim=-1).values - ref.gather(1, idx)[:, 0]

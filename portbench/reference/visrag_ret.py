"""Plain float32 VisRAG-Ret (MiniCPM-V 2.0: SigLIP ViT, resampler,
MiniCPM-2B) with position-weighted mean pooling and L2 normalisation.

From raw inputs: each page's uint8 image and its token ids. The slicing of
a page (MiniCPM-V's adaptive grid), the PIL bicubic resizes, the Inception
normalisation, the patch layout (c, ph, pw), the bicubic (antialiased)
resample of the 27 × 27 position table to each slice's grid, the slot of
each vision token (the <image> ... </image> regions of the ids in order:
the source image, then the grid's cells row by row) and the attention mask
are all worked out here again. Weights are the benchmark's, read by name.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from .common import Weights, fp32_matmuls, layer_norm, masked_attention, \
    rms_norm, rotate_half


# ---- the page: slices and pixels -------------------------------------------


def _divide(length, patch):
    return max(round(length / patch) * patch, patch)


def _resize_to(size, res, patch, upscale=False):
    w, h = size
    if w * h > res * res or upscale:
        r = w / h
        h = int(res / math.sqrt(r))
        w = int(h * r)
    return _divide(w, patch), _divide(h, patch)


def slice_page(img: Image.Image, res: int, patch: int,
               max_slices: int) -> List[Image.Image]:
    """The source image resized to about res², then, for a large page, the
    cells of the grid whose aspect is nearest the page's, row by row."""
    w, h = img.size
    multiple = min(math.ceil(w * h / (res * res)), max_slices)
    if multiple <= 1:
        return [img.resize(_resize_to((w, h), res, patch, True),
                           Image.Resampling.BICUBIC)]
    source = img.resize(_resize_to((w, h), res, patch),
                        Image.Resampling.BICUBIC)
    grids = [(m, n // m) for n in (multiple - 1, multiple, multiple + 1)
             if n != 1 and n <= max_slices
             for m in range(1, n + 1) if n % m == 0]
    log_ratio = math.log(w / h)
    best = min(grids, key=lambda g: abs(log_ratio - math.log(g[0] / g[1])))
    cols, rows = best
    cell = _resize_to((_divide(w, cols) / cols, _divide(h, rows) / rows),
                      res, patch, True)
    refined = img.resize((cell[0] * cols, cell[1] * rows),
                         Image.Resampling.BICUBIC)
    return [source] + [refined.crop((c * cell[0], r * cell[1],
                                     (c + 1) * cell[0], (r + 1) * cell[1]))
                       for r in range(rows) for c in range(cols)]


def patches_of(img: Image.Image, patch: int):
    """(gh·gw, 3·p·p) normalised patches, row-major, (c, ph, pw) inside."""
    a = np.asarray(img.convert("RGB"), np.float32) / 255.0
    a = (a - 0.5) / 0.5
    h, w, _ = a.shape
    gh, gw = h // patch, w // patch
    p = a.reshape(gh, patch, gw, patch, 3).transpose(0, 2, 4, 1, 3)
    return torch.from_numpy(p.reshape(gh * gw, -1).copy()), gh, gw


def sincos(dim: int, gh: int, gw: int) -> torch.Tensor:
    """(gh·gw, dim) 2-D sin-cos table, row-major: the first half encodes
    the column, the second the row."""
    def one(d, pos):
        omega = 1.0 / 10000 ** (torch.arange(d // 2, dtype=torch.float64)
                                / (d / 2.0))
        out = pos[:, None].double() * omega[None]
        return torch.cat([out.sin(), out.cos()], dim=1)
    idx = torch.arange(gh * gw)
    return torch.cat([one(dim // 2, idx % gw), one(dim // 2, idx // gw)],
                     dim=1).float()


def vision_regions(ids: Sequence[int], start_id: int, end_id: int):
    """[(first, last + 1)] of the tokens inside each <image> ... </image>."""
    ids = list(ids)
    starts = [i + 1 for i, t in enumerate(ids) if t == start_id]
    ends = [i for i, t in enumerate(ids) if t == end_id]
    return list(zip(starts, ends))


# ---- the encoder ------------------------------------------------------------


def vit(W: Weights, cfg: dict, slices: List[Image.Image]):
    """SigLIP ViT on each slice → [(n_i, 1152)] (the valid patches)."""
    v = cfg["vision"]
    e, heads, ps = v["embed_dim"], v["num_heads"], v["patch_size"]
    d = e // heads
    g = v["pos_grid"]
    pre = "backbone.vpm."
    table = W(pre + "pos_embed").reshape(1, g, g, e).permute(0, 3, 1, 2)
    out = []
    for img in slices:
        x, gh, gw = patches_of(img, ps)
        x = W.linear(x.to(W.device), pre + "patch_embed.proj")
        pos = F.interpolate(table, size=(gh, gw), mode="bicubic",
                            antialias=True, align_corners=False)
        x = x + pos[0].permute(1, 2, 0).reshape(gh * gw, e)
        n = x.shape[0]
        allow = torch.ones(n, n, dtype=torch.bool, device=W.device)
        for i in range(v["depth"]):
            b = f"{pre}blocks.{i}."
            y = layer_norm(x, W(b + "norm1.weight"), W(b + "norm1.bias"),
                           v["ln_eps"])
            q, k, vv = W.linear(y, b + "attn.qkv").reshape(
                n, 3, heads, d).permute(1, 2, 0, 3)
            o = masked_attention(q, k, vv, allow, d ** -0.5)
            x = x + W.linear(o.reshape(n, e), b + "attn.proj")
            y = layer_norm(x, W(b + "norm2.weight"), W(b + "norm2.bias"),
                           v["ln_eps"])
            x = x + W.linear(F.gelu(W.linear(y, b + "mlp.fc1")),
                             b + "mlp.fc2")
        out.append((layer_norm(x, W(pre + "norm.weight"),
                               W(pre + "norm.bias"), v["ln_eps"]), gh, gw))
    return out


def resampler(W: Weights, cfg: dict, feats) -> List[torch.Tensor]:
    """64 queries attend to each slice's patches → [(64, 2304)]."""
    r = cfg["resampler"]
    e, heads, eps = r["embed_dim"], r["num_heads"], r["ln_eps"]
    d = e // heads
    pre = "backbone.resampler."
    wq, wk, wv = W(pre + "attn.in_proj_weight").chunk(3)
    bq, bk, bv = W(pre + "attn.in_proj_bias").chunk(3)
    q = layer_norm(W(pre + "query"), W(pre + "ln_q.weight"),
                   W(pre + "ln_q.bias"), eps) + W(pre + "pos_embed")
    qh = F.linear(q, wq, bq).reshape(-1, heads, d).transpose(0, 1)
    out = []
    for x, gh, gw in feats:
        kv = layer_norm(W.linear(x, pre + "kv_proj"), W(pre + "ln_kv.weight"),
                        W(pre + "ln_kv.bias"), eps)
        k = kv + sincos(e, gh, gw).to(W.device)
        kh = F.linear(k, wk, bk).reshape(-1, heads, d).transpose(0, 1)
        vh = F.linear(kv, wv, bv).reshape(-1, heads, d).transpose(0, 1)
        allow = torch.ones(qh.shape[1], kh.shape[1], dtype=torch.bool,
                           device=W.device)
        o = masked_attention(qh, kh, vh, allow, d ** -0.5).reshape(-1, e)
        o = W.linear(o, pre + "attn.out_proj")
        o = layer_norm(o, W(pre + "ln_post.weight"), W(pre + "ln_post.bias"),
                       eps)
        out.append(o @ W(pre + "proj"))
    return out


def minicpm(W: Weights, cfg: dict, ids: Sequence[int], vision):
    """MiniCPM-2B over one prompt with the vision rows in its regions →
    the final hidden states (n, 2304)."""
    c = cfg["llm"]
    e, heads, layers = c["hidden_size"], c["num_attention_heads"], \
        c["num_hidden_layers"]
    kvh = c["num_key_value_heads"]
    d = e // heads
    pre = "backbone.llm."
    ids_t = torch.as_tensor(list(ids), device=W.device)
    n = len(ids_t)
    x = W(pre + "embed_tokens.weight")[ids_t] * c["scale_emb"]
    for (lo, hi), rows in zip(vision["regions"], vision["rows"]):
        x[lo:hi] = rows[:hi - lo]
    inv = 1.0 / (c["rope_theta"] ** (torch.arange(0, d, 2, dtype=torch.float64,
                                                 device=W.device) / d))
    ang = torch.arange(n, device=W.device, dtype=torch.float64)[:, None] \
        * inv[None]
    cos = torch.cat([ang, ang], -1).cos().float()[:, None]
    sin = torch.cat([ang, ang], -1).sin().float()[:, None]
    allow = torch.ones(n, n, dtype=torch.bool, device=W.device).tril()
    depth = c["scale_depth"] / layers ** 0.5
    for i in range(layers):
        b = f"{pre}layers.{i}."
        y = rms_norm(x, W(b + "input_layernorm.weight"), c["rms_norm_eps"])
        q = W.linear(y, b + "self_attn.q_proj").reshape(n, heads, d)
        k = W.linear(y, b + "self_attn.k_proj").reshape(n, kvh, d)
        v = W.linear(y, b + "self_attn.v_proj").reshape(n, kvh, d)
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        rep = heads // kvh
        o = masked_attention(q.transpose(0, 1),
                             k.repeat_interleave(rep, 1).transpose(0, 1),
                             v.repeat_interleave(rep, 1).transpose(0, 1),
                             allow, d ** -0.5)
        x = x + W.linear(o.reshape(n, e), b + "self_attn.o_proj") * depth
        y = rms_norm(x, W(b + "post_attention_layernorm.weight"),
                     c["rms_norm_eps"])
        m = W.linear(F.silu(W.linear(y, b + "mlp.gate_proj"))
                     * W.linear(y, b + "mlp.up_proj"), b + "mlp.down_proj")
        x = x + m * depth
    return rms_norm(x, W(pre + "norm.weight"), c["rms_norm_eps"])


def wmean_l2(hidden: torch.Tensor) -> torch.Tensor:
    """Token i (from 1) weighs i; the mean, L2-normalised."""
    w = torch.arange(1, hidden.shape[0] + 1, device=hidden.device,
                     dtype=torch.float32)
    e = (hidden * w[:, None]).sum(0) / w.sum()
    return e / e.norm().clamp(min=1e-12)


@torch.no_grad()
def embed(state: dict, cfg: dict, items, special: dict, device,
          low: str = None) -> torch.Tensor:
    """items: [(PIL image or None, token ids)] → (len(items), hidden)
    float32 unit embeddings, one item at a time; low: "int8" or "fp8" runs
    the linear layers in that precision (the control)."""
    W = Weights(state, device, low=low)
    p = cfg["pipeline"]
    out = []
    with fp32_matmuls():
        for img, ids in items:
            vision = {"regions": [], "rows": []}
            if img is not None:
                slices = slice_page(img, p["scale_resolution"],
                                    cfg["vision"]["patch_size"],
                                    p["max_slice_nums"])
                regions = vision_regions(ids, special["im_start_id"],
                                         special["im_end_id"])
                if len(regions) != len(slices):
                    raise ValueError(f"{len(regions)} vision regions for "
                                     f"{len(slices)} slices")
                vision = {"regions": regions,
                          "rows": resampler(W, cfg, vit(W, cfg, slices))}
            out.append(wmean_l2(minicpm(W, cfg, ids, vision)))
    return torch.stack(out)

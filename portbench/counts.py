"""The yardstick's arithmetic: H100 peaks, the operations and bytes of one
kernel call, and the model FLOPs that a cell's inputs need.

Operations count 2 per multiply-add. A kernel's bytes count each input
byte read once and each output byte written once, on the rows that these
inputs need (valid rows, live cache tokens), whatever the kernel reads
again. Model FLOPs count the dense layers on valid tokens and attention on
the visible (query, key) pairs; padding is not work the inputs need.
"""

from __future__ import annotations

from typing import Iterable, Sequence

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12      # outside the tensor cores
PEAK_BYTES = 3.35e12         # HBM3
BF16 = 2


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """Least time of a call: the larger of operations over the peak and
    bytes over the memory rate."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def pairs(lengths: Iterable[int], causal: bool) -> int:
    """Visible (query, key) pairs of rows of these lengths."""
    return sum(n * (n + 1) // 2 if causal else n * n for n in lengths)


# ---- kernels --------------------------------------------------------------


def k1_counts(lengths: Sequence[int], heads: int, d: int, causal: bool,
              kv_heads: int = None):
    """K1 (the lengths-masked flash forward, flat or stacked form): QK^T
    and PV over the visible pairs; q and the output at `heads`, k and v at
    `kv_heads` heads, each valid row read or written once. → (flops,
    bytes)."""
    hk = kv_heads or heads
    rows = sum(lengths)
    flops = 4 * pairs(lengths, causal) * heads * d
    nbytes = BF16 * rows * d * (2 * heads + 2 * hk)
    return flops, nbytes


def k3_counts(segment_sizes: Sequence[int], heads: int, d: int):
    """K3 (banded segment attention of the vision tower): each segment
    attends within itself, not causal. → (flops, bytes)."""
    return k1_counts(segment_sizes, heads, d, causal=False)


def k5_counts(lengths: Sequence[int], heads: int, kv_heads: int, d: int,
              kv_bytes: int = BF16):
    """K5 (paged decode, one step of one layer) at the live lengths: q and
    the output per slot, and each live token's K and V read once. →
    (flops, bytes)."""
    n = len(lengths)
    tokens = sum(lengths)
    flops = 4 * tokens * heads * d
    nbytes = 2 * tokens * kv_heads * d * kv_bytes + 2 * BF16 * n * heads * d
    return flops, nbytes


def scan_counts(n_rows: int, dim: int, n_queries: int, k: int):
    """The exact fp32 scan: every corpus row read once, the query block
    read once, k (score, id) pairs written per query. → (flops, bytes)."""
    flops = 2 * n_rows * dim * n_queries
    nbytes = 4 * (n_rows * dim + n_queries * dim) + 8 * n_queries * k
    return flops, nbytes


# ---- model FLOPs ------------------------------------------------------------


def linear_params(*shapes) -> int:
    """Multiply-adds per token of a chain of (in, out) linear layers."""
    return sum(i * o for i, o in shapes)


def siglip_vit_flops(v: dict, slice_lengths: Sequence[int]) -> float:
    """SigLIP ViT (patch embed, blocks) on the slices' valid patches."""
    e, m, layers = v["embed_dim"], v["mlp_dim"], v["depth"]
    patch_dim = 3 * v["patch_size"] ** 2
    tokens = sum(slice_lengths)
    per_layer = linear_params((e, 3 * e), (e, e), (e, m), (m, e))
    dense = 2 * tokens * (patch_dim * e + layers * per_layer)
    attn = 4 * pairs(slice_lengths, False) * e * layers
    return dense + attn


def resampler_flops(r: dict, slice_lengths: Sequence[int]) -> float:
    """kv_proj and the k/v in-projections on each slice's valid patches,
    the query side on num_queries rows a slice, the cross-attention."""
    e, kv, q = r["embed_dim"], r["kv_dim"], r["num_queries"]
    n = len(slice_lengths)
    tokens = sum(slice_lengths)
    kv_side = 2 * tokens * (kv * e + 2 * e * e)
    q_side = 2 * n * q * (e * e + e * e + e * e)   # q in-proj, out_proj, proj
    attn = 4 * q * tokens * e
    return kv_side + q_side + attn


def decoder_flops(hidden: int, inter: int, layers: int, heads: int,
                  kv_heads: int, head_dim: int, lengths: Sequence[int],
                  causal: bool = True, past: Sequence[int] = None) -> float:
    """A SwiGLU decoder stack on rows of `lengths` new tokens each, every
    row seeing `past` cached tokens before them (prefill: none)."""
    q_out, kv_out = heads * head_dim, kv_heads * head_dim
    per_layer = linear_params((hidden, q_out), (hidden, kv_out),
                              (hidden, kv_out), (q_out, hidden),
                              (hidden, inter), (hidden, inter),
                              (inter, hidden))
    tokens = sum(lengths)
    past = past or [0] * len(lengths)
    visible = sum(n * p + (n * (n + 1) // 2 if causal else n * n)
                  for n, p in zip(lengths, past))
    return 2 * tokens * layers * per_layer + 4 * visible * q_out * layers


def minicpm_flops(llm: dict, lengths: Sequence[int]) -> float:
    """MiniCPM-2B's stack on the valid tokens (no LM head)."""
    heads = llm["num_attention_heads"]
    return decoder_flops(llm["hidden_size"], llm["intermediate_size"],
                         llm["num_hidden_layers"], heads,
                         llm["num_key_value_heads"],
                         llm["hidden_size"] // heads, lengths)


def visrag_ret_flops(cfg: dict, slice_lengths: Sequence[int],
                     token_lengths: Sequence[int]) -> dict:
    """One encode batch by component: ViT, resampler, LM (pooling and the
    norm are a few operations a token)."""
    return {"vit": siglip_vit_flops(cfg["vision"], slice_lengths)
            if slice_lengths else 0.0,
            "resampler": resampler_flops(cfg["resampler"], slice_lengths)
            if slice_lengths else 0.0,
            "lm": minicpm_flops(cfg["llm"], token_lengths)}


def qwen_tower_flops(v: dict, out_hidden: int,
                     window_sizes: Sequence[int],
                     image_sizes: Sequence[int]) -> float:
    """Qwen2.5-VL's vision tower on one request's patches: the patch
    embed, the blocks (window layers attend within windows, the full
    layers within each image), the merger on groups of merge² patches."""
    e, inter, depth = v["hidden_size"], v["intermediate_size"], v["depth"]
    mu = v["spatial_merge_size"] ** 2
    patch_dim = 3 * v["temporal_patch_size"] * v["patch_size"] ** 2
    tokens = sum(image_sizes)
    per_layer = linear_params((e, 3 * e), (e, e), (e, inter), (e, inter),
                              (inter, e))
    n_full = len(v["fullatt_block_indexes"])
    attn = 4 * e * ((depth - n_full) * pairs(window_sizes, False)
                    + n_full * pairs(image_sizes, False))
    merger = 2 * (tokens // mu) * linear_params((mu * e, mu * e),
                                                (mu * e, out_hidden))
    return 2 * tokens * (patch_dim * e + depth * per_layer) + attn + merger


def qwen_text_flops(t: dict, lengths: Sequence[int],
                    past: Sequence[int] = None, head_rows: int = None):
    """Qwen2.5's text stack on `lengths` new tokens a row after `past`
    cached ones, and the LM head on `head_rows` rows (default: one a
    row)."""
    heads = t["num_attention_heads"]
    hidden = t["hidden_size"]
    stack = decoder_flops(hidden, t["intermediate_size"],
                          t["num_hidden_layers"], heads,
                          t["num_key_value_heads"], hidden // heads,
                          lengths, past=past)
    rows = len(lengths) if head_rows is None else head_rows
    return stack + 2 * rows * hidden * t["vocab_size"]

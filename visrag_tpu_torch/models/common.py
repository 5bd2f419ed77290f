"""Shared model building blocks.

Counterpart of visrag_tpu/models/common.py: fp32 RMSNorm/LayerNorm cast
back to the input dtype (ops/norms.py: the fused kernel K7 on the card,
the plain version on the CPU), rotary embeddings (plain, linear and
dynamic-NTK scaling) applied in fp32, and the 2-D sin-cos position
tables. Linear layers are plain `nn.Linear` with the torch (out, in)
weight layout, which is the layout the JAX package's `Dense` stores;
`QuantLinear` is the counterpart of its `QuantDense` (int8 w8a8,
inference only). Tensor-parallel serving (mesh.shard_module_tp) puts
`RowParallelLinear`, `GatheredLinear` and `VocabParallelEmbedding` in a
rank's shard: the forms of nn.Linear / nn.Embedding that close a
column / row pair with one all-reduce, gather a column-parallel output
whole, and look up a vocabulary shard (inference only: their collectives
have no backward).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..ops import norms


class RMSNorm(nn.Module):
    """RMSNorm with fp32 math, output in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x):
        return norms.rmsnorm(x, self.weight, self.eps)


class QuantLinear(nn.Linear):
    """nn.Linear whose GEMM runs in int8 (w8a8): the same `weight` (out, in)
    and `bias` as nn.Linear, so loaders fill it unchanged. The weight's int8
    codes and per-output-channel scales are the ones the JAX package's
    QuantDense computes at apply time; they are computed once and kept
    until the weight changes (an in-place write such as load_state_dict's
    bumps the tensor's version). Inference only: rounding has no useful
    gradient."""

    def _codes(self):
        key = (self.weight._version, self.weight.data_ptr(),
               self.weight.device)
        if getattr(self, "_code_key", None) != key:
            from ..ops.quant import quant_weight_colwise
            with torch.no_grad():
                wq, ws = quant_weight_colwise(self.weight.t())
            self._code_cache = (wq.t().contiguous(), ws)
            self._code_key = key
        return self._code_cache

    def forward(self, x):
        from ..ops.quant import int8_linear
        wq, ws = self._codes()
        return int8_linear(x, wq, ws, self.bias, out_dtype=self.weight.dtype)


def _inference_only(x, layer):
    if torch.is_grad_enabled() and (x.requires_grad
                                    or layer.weight.requires_grad):
        raise RuntimeError(f"{type(layer).__name__} is inference only: its "
                           "collectives have no backward")


def gather_last(y, group):
    """Every rank's y (same shape) of a tensor-parallel group, concatenated
    along the last dim in group order (one all_gather)."""
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


class GatheredLinear(nn.Linear):
    """A column-parallel nn.Linear whose outputs feed something other than
    its row-parallel pair (the LM head): this rank's out features, then
    the whole output gathered over the group. `group` is set by
    mesh.shard_module_tp."""

    group = None

    def forward(self, x):
        _inference_only(x, self)
        return gather_last(super().forward(x), self.group)


class RowParallelLinear(nn.Linear):
    """A row-parallel nn.Linear: this rank's in features (the slice its
    column-parallel pair produced) and the whole bias. The partial
    products are summed over the group in fp32 (bf16 GEMMs write fp32
    outputs), the bias is added once after the sum, and the result is
    rounded to the input dtype once, as one process's GEMM rounds it."""

    group = None

    def forward(self, x):
        _inference_only(x, self)
        x2 = x.reshape(-1, x.shape[-1])
        if x.dtype == torch.float32:
            y = x2 @ self.weight.t()
        elif x.is_cuda:
            y = torch.mm(x2, self.weight.t(), out_dtype=torch.float32)
        else:
            y = x2.float() @ self.weight.float().t()
        dist.all_reduce(y, group=self.group)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype).reshape(*x.shape[:-1], -1)


class VocabParallelEmbedding(nn.Embedding):
    """nn.Embedding over this rank's rows [start, start + num_embeddings)
    of the vocabulary: ids outside them look up zeros, and the group's sum
    is the whole lookup (exactly: one non-zero row per id). `logits`
    is the tied LM head over the same rows, gathered."""

    group = None
    start = 0

    def forward(self, ids):
        _inference_only(ids, self)
        local = ids.long() - self.start
        inside = (local >= 0) & (local < self.num_embeddings)
        y = super().forward(local.clamp(0, self.num_embeddings - 1))
        y = y.masked_fill(~inside[..., None], 0)
        dist.all_reduce(y, group=self.group)
        return y

    def logits(self, hidden):
        return gather_last(hidden @ self.weight.to(hidden.dtype).T,
                           self.group)


def tied_logits(embedding, hidden):
    """The LM head tied to `embedding` (its weight (V, E)): hidden @ W.T,
    gathered over the group when the embedding is vocab-parallel."""
    if isinstance(embedding, VocabParallelEmbedding):
        return embedding.logits(hidden)
    return hidden @ embedding.weight.to(hidden.dtype).T


class LayerNorm(nn.Module):
    """LayerNorm with fp32 math, output in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype))

    def forward(self, x):
        return norms.layernorm(x, self.weight, self.bias, self.eps)


def scatter_vision(embeds, slot_map, vision_embeds):
    """Token embeddings (B, S, E) with the rows of a table of tower outputs
    (N, E) put where slot_map (B, S) >= 0 picks one."""
    slot_map = slot_map.to(embeds.device)
    safe = slot_map.clamp(min=0).reshape(-1)
    gathered = vision_embeds[safe].reshape(*slot_map.shape, -1)
    return torch.where((slot_map >= 0)[..., None],
                       gathered.to(embeds.dtype), embeds)


def prefill_outputs(model, hidden, kvs, last_pos):
    """A generation model's prefill result from its stack's hidden states
    and per-layer K/V: (logits at last_pos (B,) → (B, V), or all (B, S, V)
    when last_pos is None; k, v stacked (layers, B, S, kvh, d))."""
    k = torch.stack([kv[0] for kv in kvs])
    v = torch.stack([kv[1] for kv in kvs])
    if last_pos is not None:
        idx = last_pos.to(hidden.device).long()
        hidden = hidden[torch.arange(hidden.shape[0], device=hidden.device),
                        idx]
    return model.compute_logits(hidden), k, v


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     scaling: Optional[dict] = None,
                     max_positions: int = 4096,
                     seq_len: Optional[int] = None) -> np.ndarray:
    """Shared inv_freq (D/2,). scaling: None or {"type": "linear"|"dynamic",
    "factor": f}; dynamic NTK rescales theta from the static seq_len (paths
    with per-row lengths use dynamic_ntk_inv_freq instead)."""
    if scaling:
        kind = scaling.get("type")
        if kind == "dynamic" and seq_len and seq_len > max_positions:
            factor = float(scaling["factor"])
            theta = theta * ((factor * seq_len / max_positions)
                             - (factor - 1.0)) ** (head_dim / (head_dim - 2))
        elif kind not in ("linear", "dynamic"):
            raise ValueError(f"unsupported rope_scaling type {kind!r} "
                             "(expected linear|dynamic)")
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                                / head_dim))
    return inv_freq.astype(np.float32)


def dynamic_ntk_inv_freq(head_dim: int, theta: float, factor: float,
                         max_positions: int, seq_lens):
    """Per-row NTK inv_freq (B, D/2) from live lengths (B,); rows at or
    under max_positions keep the base theta."""
    s = seq_lens.float()
    scaled = theta * ((factor * s / max_positions) - (factor - 1.0)) \
        ** (head_dim / (head_dim - 2))
    t = torch.where(s > max_positions, scaled, torch.full_like(s, theta))
    exp = torch.arange(0, head_dim, 2, dtype=torch.float32,
                       device=s.device) / head_dim
    return 1.0 / (t[:, None] ** exp[None, :])


def apply_rope(q, k, positions, inv_freq, scaling: Optional[dict] = None):
    """q, k: (B, S, H, D); positions (B, S) int; inv_freq (D/2,) shared or
    (B, D/2) per row. Rotation in fp32, cast back."""
    pos = positions.float()
    if scaling and scaling.get("type") == "linear":
        pos = pos / float(scaling["factor"])
    inv_freq = inv_freq.to(pos.device)
    if inv_freq.dim() == 2:
        freqs = pos[..., None] * inv_freq[:, None, :]
    else:
        freqs = pos[..., None] * inv_freq[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    cos = torch.cos(emb)[:, :, None, :]
    sin = torch.sin(emb)[:, :, None, :]

    def rot(x):
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([-x2, x1], dim=-1)

    qf, kf = q.float(), k.float()
    return ((qf * cos + rot(qf) * sin).to(q.dtype),
            (kf * cos + rot(kf) * sin).to(k.dtype))


def get_2d_sincos_pos_embed(embed_dim: int, grid_h: int,
                            grid_w: int) -> np.ndarray:
    """2-D sin-cos table (grid_h*grid_w, embed_dim), MAE convention: the
    first half encodes the meshgrid's w coordinate, the second half h."""
    def one_dim(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gh = np.arange(grid_h, dtype=np.float32)
    gw = np.arange(grid_w, dtype=np.float32)
    grid = np.stack(np.meshgrid(gw, gh), axis=0).reshape(2, -1)
    emb_h = one_dim(embed_dim // 2, grid[0])
    emb_w = one_dim(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


def sincos_2d_device(embed_dim: int, grid_h, grid_w, max_len: int):
    """Batched on-device 2-D sin-cos for per-slice (h, w) grids: grid_h,
    grid_w (N,) int → (N, max_len, embed_dim) fp32, row-major over the grid.
    Rows past h*w are garbage for the caller to mask. The row index follows
    from the width alone, so grid_h is not read (as in the JAX version)."""
    idx = torch.arange(max_len, device=grid_w.device)
    w = grid_w.long()[:, None]
    row = torch.div(idx[None, :], w, rounding_mode="floor").float()
    col = (idx[None, :] % w).float()
    half = embed_dim // 2

    def one_dim(dim, pos):
        omega = torch.arange(dim // 2, dtype=torch.float32,
                             device=pos.device) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = pos[..., None] * omega
        return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)

    return torch.cat([one_dim(half, col), one_dim(half, row)], dim=-1)

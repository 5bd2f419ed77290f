"""Perceiver resampler: learnable queries cross-attend to ViT patch tokens.

Counterpart of visrag_tpu/models/resampler.py: 64 queries plus the fixed
8×8 2-D sin-cos query pos embed (MiniCPM-V 2.0; the 2.6 resampler has none:
`query_pos=False`); keys get the adaptive sin-cos embed of each
slice's (h, w) patch grid, built on the device; kv_proj 1152→2304 (no
bias), ln_kv/ln_q/ln_post, the nn.MultiheadAttention parameter layout
(joint in_proj, out_proj) and a final projection. The attention is a
64-query cross-attention in plain PyTorch with fp32 scores and softmax and
-1e30 masking, as the JAX version leaves it to XLA.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .common import LayerNorm, sincos_2d_device


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    num_queries: int = 64
    embed_dim: int = 2304
    kv_dim: int = 1152
    num_heads: int = 18
    ln_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    query_pos: bool = True      # the fixed query-side table (2.0 only)

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(num_queries=4, embed_dim=16, kv_dim=8, num_heads=2,
                        dtype=torch.float32)
        defaults.update(kw)
        return cls(**defaults)


class MultiheadAttentionParams(nn.Module):
    """Parameter container with nn.MultiheadAttention's names; the
    attention itself is computed in Resampler.forward."""

    def __init__(self, e: int, dtype):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * e, e, dtype=dtype))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * e, dtype=dtype))
        self.out_proj = nn.Linear(e, e, dtype=dtype)


class Resampler(nn.Module):
    # tensor parallelism keeps the resampler whole on every rank
    # (mesh.shard_module_tp): its kv_proj feeds the attention's own
    # in-projection, not a row-parallel pair
    tp_whole = True

    def __init__(self, cfg: ResamplerConfig):
        super().__init__()
        c = self.cfg = cfg
        e = c.embed_dim
        self.query = nn.Parameter(torch.empty(c.num_queries, e, dtype=c.dtype))
        self.pos_embed = nn.Parameter(          # fixed sin-cos table
            torch.empty(c.num_queries, e, dtype=c.dtype),
            requires_grad=False) if c.query_pos else None
        self.kv_proj = (nn.Linear(c.kv_dim, e, bias=False, dtype=c.dtype)
                        if c.kv_dim != e else None)
        self.attn = MultiheadAttentionParams(e, c.dtype)
        self.ln_q = LayerNorm(e, c.ln_eps, dtype=c.dtype)
        self.ln_kv = LayerNorm(e, c.ln_eps, dtype=c.dtype)
        self.ln_post = LayerNorm(e, c.ln_eps, dtype=c.dtype)
        self.proj = nn.Parameter(torch.empty(e, e, dtype=c.dtype))

    def forward(self, x, grid_h, grid_w, mask):
        """x (N, MAX_P, kv_dim), grid_h/grid_w (N,), mask (N, MAX_P) →
        (N, num_queries, embed_dim)."""
        c = self.cfg
        n, max_p, _ = x.shape
        e, h = c.embed_dim, c.num_heads
        d = e // h
        kv = self.kv_proj(x) if self.kv_proj is not None else x
        kv = self.ln_kv(kv)
        k_pos = sincos_2d_device(e, grid_h, grid_w, max_p)

        q = self.ln_q(self.query)
        if self.pos_embed is not None:
            q = q + self.pos_embed
        k = kv + k_pos.to(kv.dtype)
        wq, wk, wv = self.attn.in_proj_weight.chunk(3, dim=0)
        bq, bk, bv = self.attn.in_proj_bias.chunk(3, dim=0)
        qh = F.linear(q, wq, bq).reshape(c.num_queries, h, d)
        kh = F.linear(k, wk, bk).reshape(n, max_p, h, d)
        vh = F.linear(kv, wv, bv).reshape(n, max_p, h, d)

        s = torch.einsum("qhd,nphd->nhqp", qh.float(), kh.float()) / d ** 0.5
        s = s.masked_fill(mask[:, None, None, :] <= 0, -1e30)
        o = torch.einsum("nhqp,nphd->nqhd", torch.softmax(s, dim=-1),
                         vh.float())
        o = self.attn.out_proj(o.reshape(n, c.num_queries, e).to(kv.dtype))
        return self.ln_post(o) @ self.proj

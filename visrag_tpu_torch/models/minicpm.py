"""MiniCPM-2B language model (Llama family with MUP scalings).

Counterpart of visrag_tpu/models/minicpm.py (MiniCPMConfig, MiniCPMModel):

  * embed_tokens(ids) * scale_emb;
  * residual += sublayer(x) * scale_depth / sqrt(num_layers), both
    sublayers;
  * RMSNorm eps 1e-5; RoPE theta 10000 in fp32, with linear or dynamic-NTK
    scaling (per-row live lengths drive the NTK theta);
  * right-padded attention through the stacked lengths kernel
    (ops/attention_lengths.flash_fwd_lengths), causal per config, in
    training as in inference (its backward is K2);
  * `remat` as in the ViT: True recomputes whole layers in the backward,
    "mlp" only each layer's MLP (torch.utils.checkpoint, non-reentrant);
  * `quant="int8"` (inference only): q/k/v/o and gate/up run in int8
    (models/common.QuantLinear, K6); down stays bf16, as in the JAX package.

Decode, the LM head and generation are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention_lengths import flash_fwd_lengths
from .common import (QuantLinear, RMSNorm, apply_rope, dynamic_ntk_inv_freq,
                     rope_frequencies)


@dataclasses.dataclass(frozen=True)
class MiniCPMConfig:
    vocab_size: int = 122753
    hidden_size: int = 2304
    intermediate_size: int = 5760
    num_hidden_layers: int = 40
    num_attention_heads: int = 36
    num_key_value_heads: int = 36
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling_type: str = ""     # "" | "linear" | "dynamic"
    rope_scaling_factor: float = 1.0
    scale_emb: float = 12.0
    scale_depth: float = 1.4
    max_position_embeddings: int = 4096
    is_causal: bool = True
    dtype: torch.dtype = torch.bfloat16
    remat: Any = False          # False | True (whole layers) | "mlp"
    quant: str = "none"         # "none" | "int8" (q/k/v/o, gate/up)

    def __post_init__(self):
        if self.quant != "none" and self.remat:
            raise ValueError(
                "quant='int8' is inference-only (no VJP); remat=True marks a "
                "training config — use quant='none' for training")
        if self.num_key_value_heads != self.num_attention_heads:
            raise ValueError("grouped kv heads are not ported "
                             "(MiniCPM-2B has num_key_value_heads == "
                             "num_attention_heads)")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def rope_scaling(self):
        if not self.rope_scaling_type:
            return None
        return {"type": self.rope_scaling_type,
                "factor": self.rope_scaling_factor}

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=4, dtype=torch.float32)
        defaults.update(kw)
        return cls(**defaults)


def rope_inv_freq(c: MiniCPMConfig, seq: int, lengths, device):
    """inv_freq for one forward: (D/2,) shared, or (B, D/2) per row under
    dynamic NTK (live lengths drive the theta)."""
    scaling = c.rope_scaling
    if scaling and scaling["type"] == "dynamic":
        return dynamic_ntk_inv_freq(c.head_dim, c.rope_theta,
                                    c.rope_scaling_factor,
                                    c.max_position_embeddings, lengths)
    return torch.from_numpy(rope_frequencies(
        c.head_dim, c.rope_theta, scaling=scaling,
        max_positions=c.max_position_embeddings, seq_len=seq)).to(device)


class MiniCPMMLP(nn.Module):
    def __init__(self, c: MiniCPMConfig):
        super().__init__()
        linear = QuantLinear if c.quant == "int8" else nn.Linear
        self.gate_proj = linear(c.hidden_size, c.intermediate_size,
                                bias=False, dtype=c.dtype)
        self.up_proj = linear(c.hidden_size, c.intermediate_size, bias=False,
                              dtype=c.dtype)
        self.down_proj = nn.Linear(c.intermediate_size, c.hidden_size,
                                   bias=False, dtype=c.dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MiniCPMAttention(nn.Module):
    def __init__(self, c: MiniCPMConfig):
        super().__init__()
        self.cfg = c
        hd = c.num_attention_heads * c.head_dim
        linear = QuantLinear if c.quant == "int8" else nn.Linear
        self.q_proj = linear(c.hidden_size, hd, bias=False, dtype=c.dtype)
        self.k_proj = linear(c.hidden_size, hd, bias=False, dtype=c.dtype)
        self.v_proj = linear(c.hidden_size, hd, bias=False, dtype=c.dtype)
        self.o_proj = linear(hd, c.hidden_size, bias=False, dtype=c.dtype)

    def forward(self, x, positions, lengths, inv_freq):
        c = self.cfg
        b, s, _ = x.shape
        h, d = c.num_attention_heads, c.head_dim
        q = self.q_proj(x).view(b, s, h, d)
        k = self.k_proj(x).view(b, s, h, d)
        v = self.v_proj(x).view(b, s, h, d)
        q, k = apply_rope(q, k, positions, inv_freq, scaling=c.rope_scaling)
        o = flash_fwd_lengths(q, k, v, lengths, c.is_causal, d ** -0.5)
        return self.o_proj(o.reshape(b, s, h * d))


class MiniCPMDecoderLayer(nn.Module):
    """The JAX package's MiniCPMBlock."""

    def __init__(self, c: MiniCPMConfig):
        super().__init__()
        self.remat_mlp = c.remat == "mlp"
        self.self_attn = MiniCPMAttention(c)
        self.mlp = MiniCPMMLP(c)
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps,
                                       dtype=c.dtype)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps,
                                                dtype=c.dtype)
        self.depth_scale = c.scale_depth / c.num_hidden_layers ** 0.5

    def _mlp_part(self, x):
        return self.mlp(self.post_attention_layernorm(x))

    def forward(self, x, positions, lengths, inv_freq):
        x = x + self.self_attn(self.input_layernorm(x), positions, lengths,
                               inv_freq) * self.depth_scale
        if self.remat_mlp and torch.is_grad_enabled():
            m = checkpoint(self._mlp_part, x, use_reentrant=False)
        else:
            m = self._mlp_part(x)
        return x + m * self.depth_scale


class MiniCPMModel(nn.Module):
    """Decoder stack → final hidden states (before the LM head)."""

    def __init__(self, cfg: MiniCPMConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype=cfg.dtype)
        self.layers = nn.ModuleList(MiniCPMDecoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype=cfg.dtype)

    def embed_only(self, input_ids):
        return self.embed_tokens(input_ids) * self.cfg.scale_emb

    def forward(self, input_ids=None, *, inputs_embeds=None,
                attention_mask=None):
        """attention_mask: contiguous right-padded validity mask (B, S);
        positions are 0..S-1 on every row."""
        if inputs_embeds is None:
            inputs_embeds = self.embed_only(input_ids)
        b, s, _ = inputs_embeds.shape
        device = inputs_embeds.device
        positions = torch.arange(s, device=device).expand(b, s)
        if attention_mask is None:
            lengths = torch.full((b,), s, dtype=torch.int32, device=device)
        else:
            lengths = attention_mask.sum(dim=1, dtype=torch.int32)
        inv_freq = rope_inv_freq(self.cfg, s, lengths, device)
        x = inputs_embeds.to(self.cfg.dtype)
        remat = self.cfg.remat and self.cfg.remat != "mlp" \
            and torch.is_grad_enabled()
        for layer in self.layers:
            x = checkpoint(layer, x, positions, lengths, inv_freq,
                           use_reentrant=False) if remat \
                else layer(x, positions, lengths, inv_freq)
        return self.norm(x)

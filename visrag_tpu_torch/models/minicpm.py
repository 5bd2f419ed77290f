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

Generation (MiniCPMForCausalLM, MiniCPMGenConfig, MiniCPMForGeneration):
the MUP logit scaling hidden / (hidden_size / dim_model_base) before
`lm_head`; `prefill` returns the per-layer K/V stacked (layers, B, S, kvh,
d); `decode` takes one token per row over layer-stacked caches written in
place: the paged pool through K5 (serving/paged_kv) with a block table,
a dense (layers, B, L, kvh, d) cache (the beam search's) through
serving/kv_cache.decode_attention without one. The dynamic-NTK theta of a
decode step comes from each row's live length, not the cache's capacity.
The engine's (3, B, S) mrope positions collapse to their first row.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention_lengths import flash_fwd_lengths
from ..serving.kv_cache import decode_attention
from ..serving.paged_kv import paged_decode_attention, write_token
from .common import (QuantLinear, RMSNorm, apply_rope, dynamic_ntk_inv_freq,
                     prefill_outputs, rope_frequencies)


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
    dim_model_base: int = 256
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
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError(
                f"num_key_value_heads {self.num_key_value_heads} does not "
                f"divide num_attention_heads {self.num_attention_heads}")

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
        kvd = c.num_key_value_heads * c.head_dim
        linear = QuantLinear if c.quant == "int8" else nn.Linear
        self.q_proj = linear(c.hidden_size, hd, bias=False, dtype=c.dtype)
        self.k_proj = linear(c.hidden_size, kvd, bias=False, dtype=c.dtype)
        self.v_proj = linear(c.hidden_size, kvd, bias=False, dtype=c.dtype)
        self.o_proj = linear(hd, c.hidden_size, bias=False, dtype=c.dtype)
        # (q heads, kv heads, head dim): mesh.shard_module_tp cuts by heads
        self.tp_heads = (c.num_attention_heads, c.num_key_value_heads,
                         c.head_dim)

    def _qkv(self, x, positions, inv_freq):
        c = self.cfg
        b, s, _ = x.shape
        d = c.head_dim
        # the head counts come from the projections (a tensor-parallel
        # shard holds its own heads)
        q = self.q_proj(x).view(b, s, -1, d)
        k = self.k_proj(x).view(b, s, -1, d)
        v = self.v_proj(x).view(b, s, -1, d)
        q, k = apply_rope(q, k, positions, inv_freq, scaling=c.rope_scaling)
        return q, k, v

    def forward(self, x, positions, lengths, inv_freq, return_kv=False):
        b, s, _ = x.shape
        d = self.cfg.head_dim
        q, k, v = self._qkv(x, positions, inv_freq)
        o = flash_fwd_lengths(q, k, v, lengths, self.cfg.is_causal, d ** -0.5)
        out = self.o_proj(o.reshape(b, s, -1))
        return (out, (k, v)) if return_kv else out

    def decode(self, x, positions, kc, vc, lengths_incl, inv_freq,
               block_table=None):
        """x (B, 1, E); lengths_incl counts this step's token. kc/vc: this
        layer's dense cache (B, L_max, kvh, d) when block_table is None,
        else its paged pool (n_blocks, kvh, bs, d); this token's K/V is
        written at lengths_incl - 1, in place."""
        b = x.shape[0]
        q, k, v = self._qkv(x, positions, inv_freq)
        pos = lengths_incl.long() - 1
        if block_table is None:
            rows = torch.arange(b, device=x.device)
            kc[rows, pos] = k[:, 0].to(kc.dtype)
            vc[rows, pos] = v[:, 0].to(vc.dtype)
            o = decode_attention(q[:, 0], kc, vc, lengths_incl)
        else:
            write_token(kc, block_table, pos, k[:, 0])
            write_token(vc, block_table, pos, v[:, 0])
            o = paged_decode_attention(q[:, 0], kc, vc, block_table,
                                       lengths_incl)
        return self.o_proj(o.reshape(b, 1, -1))


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

    def _mlp_residual(self, x):
        if self.remat_mlp and torch.is_grad_enabled():
            m = checkpoint(self._mlp_part, x, use_reentrant=False)
        else:
            m = self._mlp_part(x)
        return x + m * self.depth_scale

    def forward(self, x, positions, lengths, inv_freq, return_kv=False):
        a = self.self_attn(self.input_layernorm(x), positions, lengths,
                           inv_freq, return_kv=return_kv)
        if return_kv:
            a, kv = a
        out = self._mlp_residual(x + a * self.depth_scale)
        return (out, kv) if return_kv else out

    def decode(self, x, positions, kc, vc, lengths_incl, inv_freq,
               block_table=None):
        a = self.self_attn.decode(self.input_layernorm(x), positions, kc, vc,
                                  lengths_incl, inv_freq, block_table)
        return self._mlp_residual(x + a * self.depth_scale)


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
                attention_mask=None, positions=None, return_kv=False):
        """attention_mask: contiguous right-padded validity mask (B, S);
        positions (B, S), default 0..S-1 on every row. → hidden (B, S, E)
        after the final norm, and with return_kv the per-layer (k, v)
        list, k/v (B, S, kvh, d) after rope."""
        if inputs_embeds is None:
            inputs_embeds = self.embed_only(input_ids)
        b, s, _ = inputs_embeds.shape
        device = inputs_embeds.device
        if positions is None:
            positions = torch.arange(s, device=device).expand(b, s)
        positions = positions.to(device)
        if attention_mask is None:
            lengths = torch.full((b,), s, dtype=torch.int32, device=device)
        else:
            lengths = attention_mask.to(device).sum(dim=1, dtype=torch.int32)
        inv_freq = rope_inv_freq(self.cfg, s, lengths, device)
        x = inputs_embeds.to(self.cfg.dtype)
        remat = self.cfg.remat and self.cfg.remat != "mlp" \
            and torch.is_grad_enabled() and not return_kv
        kvs = []
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, positions, lengths, inv_freq,
                               use_reentrant=False)
            elif return_kv:
                x, kv = layer(x, positions, lengths, inv_freq, True)
                kvs.append(kv)
            else:
                x = layer(x, positions, lengths, inv_freq)
        out = self.norm(x)
        return (out, kvs) if return_kv else out

    def decode(self, inputs_embeds, positions, k_cache, v_cache, lengths_incl,
               block_table=None):
        """One decode step over the layer stack: inputs_embeds (B, 1, E),
        positions (B, 1); k_cache/v_cache layer-stacked (layers, ...) and
        written in place. → hidden (B, 1, E)."""
        inv_freq = rope_inv_freq(self.cfg, 1, lengths_incl,
                                 inputs_embeds.device)
        x = inputs_embeds.to(self.cfg.dtype)
        for i, layer in enumerate(self.layers):
            x = layer.decode(x, positions, k_cache[i], v_cache[i],
                             lengths_incl, inv_freq, block_table)
        return self.norm(x)


def _row0(positions):
    """The engine's (3, B, S) mrope streams → the (B, S) 1-D positions."""
    if positions is not None and positions.dim() == 3:
        return positions[0]
    return positions


class MiniCPMForCausalLM(nn.Module):
    """The decoder stack and the LM head: → (logits, hidden)."""

    def __init__(self, cfg: MiniCPMConfig):
        super().__init__()
        self.llm_cfg = cfg
        self.model = MiniCPMModel(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                 dtype=cfg.dtype)

    def compute_logits(self, hidden):
        """MUP logit scaling, then the head."""
        c = self.llm_cfg
        return self.lm_head(hidden / (c.hidden_size / c.dim_model_base))

    def forward(self, input_ids=None, *, inputs_embeds=None,
                attention_mask=None, positions=None):
        hidden = self.model(input_ids, inputs_embeds=inputs_embeds,
                            attention_mask=attention_mask,
                            positions=_row0(positions))
        return self.compute_logits(hidden), hidden


@dataclasses.dataclass(frozen=True)
class MiniCPMGenConfig:
    """Text-only MiniCPM-2B generation on the serving engine: the
    reference's 'MiniCPM' VisRAG-Gen backend for the OCR-text baseline."""
    llm: MiniCPMConfig = MiniCPMConfig()

    @property
    def text(self):
        """The engine's cache-shape contract (it reads cfg.text)."""
        return self.llm

    @classmethod
    def tiny(cls, **kw):
        d = dict(llm=MiniCPMConfig.tiny())
        d.update(kw)
        return cls(**d)


class MiniCPMForGeneration(MiniCPMForCausalLM):
    """MiniCPMForCausalLM with the engine's prefill / decode contract."""

    def __init__(self, cfg: MiniCPMGenConfig):
        super().__init__(cfg.llm)
        self.cfg = cfg

    def forward(self, input_ids, attention_mask=None, positions=None,
                vision_batch=None, slot_map=None):
        del vision_batch, slot_map          # text only
        return super().forward(input_ids, attention_mask=attention_mask,
                               positions=positions)

    def prefill(self, input_ids, attention_mask=None, positions=None,
                vision_batch=None, slot_map=None, last_pos=None):
        """→ (logits, k (layers, B, S, kvh, d), v); last_pos (B,): logits
        only there → (B, V), else (B, S, V)."""
        del vision_batch, slot_map
        hidden, kvs = self.model(input_ids, attention_mask=attention_mask,
                                 positions=_row0(positions), return_kv=True)
        return prefill_outputs(self, hidden, kvs, last_pos)

    def decode(self, token_ids, positions, k_cache, v_cache, lengths_incl,
               block_table=None):
        """token_ids (B, 1); positions (3, B, 1) or (B, 1). → logits
        (B, V)."""
        hidden = self.model.decode(self.model.embed_only(token_ids),
                                   _row0(positions), k_cache, v_cache,
                                   lengths_incl, block_table)
        return self.compute_logits(hidden)[:, 0]


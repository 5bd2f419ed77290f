"""MiniCPM-V 2.0 composite: SigLIP ViT + resampler + MiniCPM-2B LM.

Counterpart of visrag_tpu/models/minicpmv.py (MiniCPMVConfig, MiniCPMV,
MiniCPMVGenConfig, MiniCPMVForGeneration). All slices of all pages in a
batch run as one (N_slices, MAX_P) ViT and resampler call; the resampler's
query tokens then replace the token embeddings at the positions a
host-built slot map names (a gather and a where, no per-sample Python).

MiniCPMVForGeneration adds the LM head (MUP-scaled, as MiniCPM-2B's) and
the serving engine's prefill / decode contract: vision arrives as the
encode batch's arrays (patches, patch_mask, pos_matrix, grid_h, grid_w)
with a slot map; the engine's (3, B, S) positions collapse to their first
row (MiniCPM uses 1-D RoPE).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..utils import profiling
from .common import prefill_outputs, scatter_vision
from .minicpm import MiniCPMConfig, MiniCPMModel, _row0
from .resampler import Resampler, ResamplerConfig
from .siglip_vit import SiglipViT, SiglipViTConfig


@dataclasses.dataclass(frozen=True)
class MiniCPMVConfig:
    llm: MiniCPMConfig = MiniCPMConfig()
    vit: SiglipViTConfig = SiglipViTConfig()
    resampler: ResamplerConfig = ResamplerConfig()
    query_num: int = 64
    scale_resolution: int = 448

    @classmethod
    def tiny(cls, **kw):
        llm = kw.pop("llm", MiniCPMConfig.tiny())
        vit = kw.pop("vit", SiglipViTConfig.tiny())
        res = ResamplerConfig.tiny(num_queries=4, embed_dim=llm.hidden_size,
                                   kv_dim=vit.embed_dim, num_heads=2)
        defaults = dict(llm=llm, vit=vit, resampler=res, query_num=4)
        defaults.update(kw)
        return cls(**defaults)


class MiniCPMV(nn.Module):
    def __init__(self, cfg: MiniCPMVConfig):
        super().__init__()
        self.cfg = cfg
        self.vpm = SiglipViT(cfg.vit)
        self.resampler = Resampler(cfg.resampler)
        self.llm = MiniCPMModel(cfg.llm)

    def get_vision_embedding(self, patches, patch_mask, pos_matrix, grid_h,
                             grid_w):
        """(N, MAX_P, patch_dim) → (N, query_num, hidden)."""
        with profiling.span("minicpmv.vision"):
            feats = self.vpm(patches, patch_mask, pos_matrix)
            return self.resampler(feats, grid_h, grid_w, patch_mask)

    def embed(self, input_ids, vision_batch=None, slot_map=None):
        """Token embeddings * scale_emb with the vision tokens of
        `vision_batch` (a dict of the encode batch's arrays) scattered in
        where slot_map >= 0."""
        tok = self.llm.embed_only(input_ids)
        if vision_batch is None:
            return tok
        vision = self.get_vision_embedding(
            vision_batch["patches"], vision_batch["patch_mask"],
            vision_batch["pos_matrix"], vision_batch["grid_h"],
            vision_batch["grid_w"])
        return scatter_vision(tok, slot_map,
                              vision.reshape(-1, vision.shape[-1]))

    def forward(self, input_ids, attention_mask, patches, patch_mask,
                pos_matrix, grid_h, grid_w, slot_map):
        """slot_map (B, S): flat vision-token index (slice*query_num + q)
        inside <image>…</image>, else -1. → last hidden states (B, S, E)."""
        embeds = self.embed(input_ids, dict(
            patches=patches, patch_mask=patch_mask, pos_matrix=pos_matrix,
            grid_h=grid_h, grid_w=grid_w), slot_map)
        with profiling.span("minicpmv.lm"):
            return self.llm(inputs_embeds=embeds,
                            attention_mask=attention_mask)


@dataclasses.dataclass(frozen=True)
class MiniCPMVGenConfig:
    backbone: MiniCPMVConfig = MiniCPMVConfig()

    @property
    def text(self):
        """The engine's cache-shape contract (it reads cfg.text)."""
        return self.backbone.llm

    @classmethod
    def tiny(cls, **kw):
        d = dict(backbone=MiniCPMVConfig.tiny())
        d.update(kw)
        return cls(**d)


class MiniCPMVForGeneration(nn.Module):
    """MiniCPM-V 2.0 with the LM head and the engine's prefill / decode:
    the VisRAG-Gen generator."""

    def __init__(self, cfg: MiniCPMVGenConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.backbone.llm
        self.backbone = MiniCPMV(cfg.backbone)
        self.lm_head = nn.Linear(c.hidden_size, c.vocab_size, bias=False,
                                 dtype=c.dtype)

    def compute_logits(self, hidden):
        c = self.cfg.backbone.llm
        return self.lm_head(hidden / (c.hidden_size / c.dim_model_base))

    def forward(self, input_ids, attention_mask=None, positions=None,
                vision_batch=None, slot_map=None):
        """→ (logits (B, S, V), hidden (B, S, E))."""
        hidden = self.backbone.llm(
            inputs_embeds=self.backbone.embed(input_ids, vision_batch,
                                              slot_map),
            attention_mask=attention_mask, positions=_row0(positions))
        return self.compute_logits(hidden), hidden

    def prefill(self, input_ids, attention_mask=None, positions=None,
                vision_batch=None, slot_map=None, last_pos=None):
        """→ (logits, k (layers, B, S, kvh, d), v); last_pos (B,): logits
        only there → (B, V), else (B, S, V)."""
        hidden, kvs = self.backbone.llm(
            inputs_embeds=self.backbone.embed(input_ids, vision_batch,
                                              slot_map),
            attention_mask=attention_mask, positions=_row0(positions),
            return_kv=True)
        return prefill_outputs(self, hidden, kvs, last_pos)

    def decode(self, token_ids, positions, k_cache, v_cache, lengths_incl,
               block_table=None):
        """token_ids (B, 1); positions (3, B, 1) or (B, 1); caches
        layer-stacked and written in place. → logits (B, V)."""
        llm = self.backbone.llm
        hidden = llm.decode(llm.embed_only(token_ids), _row0(positions),
                            k_cache, v_cache, lengths_incl, block_table)
        return self.compute_logits(hidden)[:, 0]

"""MiniCPM-V 2.0 composite: SigLIP ViT + resampler + MiniCPM-2B LM.

Counterpart of visrag_tpu/models/minicpmv.py (MiniCPMVConfig, MiniCPMV).
All slices of all pages in a batch run as one (N_slices, MAX_P) ViT and
resampler call; the resampler's query tokens then replace the token
embeddings at the positions a host-built slot map names (a gather and a
where, no per-sample Python).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .minicpm import MiniCPMConfig, MiniCPMModel
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
        feats = self.vpm(patches, patch_mask, pos_matrix)
        return self.resampler(feats, grid_h, grid_w, patch_mask)

    def forward(self, input_ids, attention_mask, patches, patch_mask,
                pos_matrix, grid_h, grid_w, slot_map):
        """slot_map (B, S): flat vision-token index (slice*query_num + q)
        inside <image>…</image>, else -1. → last hidden states (B, S, E)."""
        vision = self.get_vision_embedding(patches, patch_mask, pos_matrix,
                                           grid_h, grid_w)
        vision_flat = vision.reshape(-1, vision.shape[-1])
        tok = self.llm.embed_only(input_ids)
        vis = vision_flat[slot_map.clamp(min=0).reshape(-1)].reshape(
            *slot_map.shape, -1)
        embeds = torch.where((slot_map >= 0)[..., None], vis.to(tok.dtype),
                             tok)
        return self.llm(inputs_embeds=embeds, attention_mask=attention_mask)

"""MiniCPM-V 2.6: SigLIP-SO400M vision tower + perceiver resampler + Qwen2-7B.

Counterpart of visrag_tpu/models/minicpmv26.py (MiniCPMV26Config,
MiniCPMV26ForGeneration), the reference's multi_image VisRAG-Gen backend:

  * vpm: the port's SiglipViT at the 2.6 geometry (27 blocks, a 70×70 pos
    grid from the 980 px image size, tanh GELU), attention on K1's flat
    form at d 72;
  * resampler: the shared perceiver resampler with query_pos=False (2.6
    keeps only the adaptive key-side pos embed);
  * model: the port's QwenTextModel at Qwen2-7B (GQA 28/4, d 128, rope
    theta 1e6, untied head): prefill on K1's stacked causal GQA form,
    decode on K5. The engine's (3, B, S) mrope streams carry identical
    rows here, under which mrope is exactly 1-D RoPE for any section split.

Vision arrives as the encode batch's arrays with a slot map (slices of all
images of one prompt in one vision call), or as a raw device-mode batch
(uint8 `pixels`, patch_mask, grid_h, grid_w) that preprocess/device
finishes on the model's device: at the 70² grid a host-built dense pos
operator is about 23 MB fp32 a slice.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..preprocess.device import finish_vision_batch, pos_table_tensor
from .common import prefill_outputs, scatter_vision
from .qwen25_vl import QwenTextConfig, QwenTextModel
from .resampler import Resampler, ResamplerConfig
from .siglip_vit import SiglipViT, SiglipViTConfig


def _qwen2_7b() -> QwenTextConfig:
    return QwenTextConfig(
        vocab_size=151666, hidden_size=3584, intermediate_size=18944,
        num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
        rope_theta=1_000_000.0, tie_word_embeddings=False,
        mrope_section=(16, 24, 24))


@dataclasses.dataclass(frozen=True)
class MiniCPMV26Config:
    vit: SiglipViTConfig = SiglipViTConfig(depth=27, pos_grid=70, act="tanh")
    resampler: ResamplerConfig = ResamplerConfig(
        embed_dim=3584, kv_dim=1152, num_heads=28, query_pos=False)
    llm: QwenTextConfig = dataclasses.field(default_factory=_qwen2_7b)
    query_num: int = 64
    scale_resolution: int = 448

    @property
    def text(self):
        """The engine's cache-shape contract (it reads cfg.text)."""
        return self.llm

    @classmethod
    def tiny(cls, **kw):
        # vocab >= 256: MockTokenizer's byte ids reach 250
        llm = QwenTextConfig.tiny(tie_word_embeddings=False, vocab_size=512)
        vit = SiglipViTConfig.tiny(act="tanh")
        res = ResamplerConfig.tiny(num_queries=4, embed_dim=llm.hidden_size,
                                   kv_dim=vit.embed_dim, num_heads=2,
                                   query_pos=False)
        d = dict(vit=vit, resampler=res, llm=llm, query_num=4)
        d.update(kw)
        return cls(**d)


class MiniCPMV26ForGeneration(nn.Module):
    def __init__(self, cfg: MiniCPMV26Config):
        super().__init__()
        self.cfg = cfg
        self.vpm = SiglipViT(cfg.vit)
        self.resampler = Resampler(cfg.resampler)
        self.model = QwenTextModel(cfg.llm)
        self.lm_head = nn.Linear(cfg.llm.hidden_size, cfg.llm.vocab_size,
                                 bias=False, dtype=cfg.llm.dtype)
        self._pos_table = None      # the bicubic table on the device

    def get_vision_embedding(self, patches, patch_mask, pos_matrix, grid_h,
                             grid_w):
        """(N, MAX_P, patch_dim) → (N, query_num, hidden)."""
        feats = self.vpm(patches, patch_mask, pos_matrix)
        return self.resampler(feats, grid_h, grid_w, patch_mask)

    def compute_logits(self, hidden):
        return self.lm_head(hidden)

    def _finish(self, vision_batch):
        """A raw device-mode batch (uint8 pixels) → patches and pos
        operators on the model's device."""
        if "pixels" not in vision_batch:
            return vision_batch
        device = self.lm_head.weight.device
        if self._pos_table is None or self._pos_table.device != device:
            self._pos_table = pos_table_tensor(self.cfg.vit.pos_grid, device)
        return finish_vision_batch(vision_batch, self._pos_table)

    def _embed(self, input_ids, vision_batch=None, slot_map=None):
        tok = self.model.embed_tokens(input_ids)
        if vision_batch is None:
            return tok
        vb = self._finish(vision_batch)
        vision = self.get_vision_embedding(vb["patches"], vb["patch_mask"],
                                           vb["pos_matrix"], vb["grid_h"],
                                           vb["grid_w"])
        return scatter_vision(tok, slot_map,
                              vision.reshape(-1, vision.shape[-1]))

    def forward(self, input_ids, attention_mask=None, positions=None,
                vision_batch=None, slot_map=None):
        """→ (logits (B, S, V), hidden (B, S, E))."""
        hidden = self.model(
            inputs_embeds=self._embed(input_ids, vision_batch, slot_map),
            positions=positions, attention_mask=attention_mask)
        return self.compute_logits(hidden), hidden

    def prefill(self, input_ids, attention_mask=None, positions=None,
                vision_batch=None, slot_map=None, last_pos=None):
        """→ (logits, k (layers, B, S, kvh, d), v); last_pos (B,): logits
        only there → (B, V), else (B, S, V)."""
        hidden, kvs = self.model(
            inputs_embeds=self._embed(input_ids, vision_batch, slot_map),
            positions=positions, attention_mask=attention_mask,
            return_kv=True)
        return prefill_outputs(self, hidden, kvs, last_pos)

    def decode(self, token_ids, positions, k_cache, v_cache, lengths_incl,
               block_table=None):
        """token_ids (B, 1); positions (3, B, 1) or (B, 1); caches
        layer-stacked and written in place. → logits (B, V)."""
        hidden = self.model.decode(self.model.embed_tokens(token_ids),
                                   positions, k_cache, v_cache, lengths_incl,
                                   block_table)
        return self.compute_logits(hidden)[:, 0]

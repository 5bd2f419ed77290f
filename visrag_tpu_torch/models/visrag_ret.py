"""VisRAG-Ret: page-image dense retriever = MiniCPM-V forward + pooling + L2.

Counterpart of visrag_tpu/models/visrag_ret.py: one shared encoder for
queries and pages; last hidden states pooled ("wmean" by default) and
L2-normalised, in fp32 when `feature_fp32` is set. Tokenisation and
slicing happen on the host; the model consumes EncodeBatch tensors. In
training mode (`model.train()`) the drop_* pooling modes draw their
dropout from the generator passed to forward.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.pooling import l2_normalize, pool
from ..utils import profiling
from .minicpmv import MiniCPMV, MiniCPMVConfig


@dataclasses.dataclass(frozen=True)
class VisRAGRetConfig:
    backbone: MiniCPMVConfig = MiniCPMVConfig()
    pooling: str = "wmean"
    normalize: bool = True
    feature_fp32: bool = True

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(backbone=MiniCPMVConfig.tiny())
        defaults.update(kw)
        return cls(**defaults)


@dataclasses.dataclass
class EncodeBatch:
    """One encode step's device tensors. Text-only batches (queries) carry
    one all-pad dummy slice so the vision path keeps its shapes."""
    input_ids: torch.Tensor       # (B, S) int, right-padded
    attention_mask: torch.Tensor  # (B, S) int
    patches: torch.Tensor         # (N, MAX_P, patch_dim) float
    patch_mask: torch.Tensor      # (N, MAX_P) int
    pos_matrix: torch.Tensor      # (N, MAX_P, G²) float32
    grid_h: torch.Tensor          # (N,) int
    grid_w: torch.Tensor          # (N,) int
    slot_map: torch.Tensor        # (B, S) int, -1 = text position


class VisRAGRet(nn.Module):
    def __init__(self, cfg: VisRAGRetConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = MiniCPMV(cfg.backbone)

    def forward(self, batch: EncodeBatch, generator=None) -> torch.Tensor:
        """→ (B, hidden) embeddings, L2-normalised when cfg.normalize.
        generator: the torch.Generator of the pooling's dropout (drop_*
        modes in training mode)."""
        with profiling.span("visrag_ret.forward"):
            hidden = self.backbone(
                batch.input_ids, batch.attention_mask, batch.patches,
                batch.patch_mask, batch.pos_matrix, batch.grid_h,
                batch.grid_w, batch.slot_map)
            if self.cfg.feature_fp32:
                hidden = hidden.float()
            reps = pool(hidden, batch.attention_mask, self.cfg.pooling,
                        training=self.training, generator=generator)
            return l2_normalize(reps) if self.cfg.normalize else reps

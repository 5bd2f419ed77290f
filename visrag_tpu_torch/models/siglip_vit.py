"""SigLIP-SO400M ViT vision tower.

Counterpart of visrag_tpu/models/siglip_vit.py (the flat attention path).
Every slice arrives pre-patchified as a (MAX_P, 3*14*14) row buffer with a
validity mask, and the bicubic pos-embed resample is a per-slice operator,
pos = pos_matrix @ pos_embed, so slices of any grid batch together.

Arch: patch 14, width 1152, 26 blocks (the 27th is dropped), 16 heads of
d=72, MLP 4304, LayerNorm eps 1e-6, exact (erf) GELU correctly rounded
to bf16 (ops/gelu.fast_gelu, as the JAX tower runs; F.gelu in bf16 differs
on 334 bf16 inputs), qkv bias. MiniCPM-V 2.6 runs the same tower at 27
blocks and a 70x70 pos grid with the tanh GELU (`act="tanh"`, HF SigLIP's
gelu_pytorch_tanh). Attention
is the fused qkv GEMM → flat lengths kernel (ops/attention_lengths.py) →
projection GEMM, all in the (N*P, ...) layout; d=72 goes to the kernel
unpadded, and its gradient (K2) comes back in the same flat layout.

`remat` trades compute for memory when gradients are on, through
torch.utils.checkpoint (non-reentrant): True recomputes whole blocks in the
backward (attention included), "mlp" only each block's MLP, False nothing.

`quant="int8"` (inference only) runs the fused qkv and fc1 GEMMs in int8
(models/common.QuantLinear, K6); proj and fc2 stay bf16, as in the JAX
package. The JAX qkv quantizes its head-padded weight; the pad columns are
zero, so the real columns' codes, scales and outputs are the ones here.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention_lengths import flash_fwd_lengths_flat
from ..ops.gelu import fast_gelu
from .common import LayerNorm, QuantLinear


@dataclasses.dataclass(frozen=True)
class SiglipViTConfig:
    patch_size: int = 14
    embed_dim: int = 1152
    depth: int = 26
    num_heads: int = 16
    mlp_dim: int = 4304
    pos_grid: int = 27
    ln_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    remat: Any = False          # False | True (whole blocks) | "mlp"
    quant: str = "none"         # "none" | "int8" (qkv and fc1, inference)
    act: str = "erf"            # MLP GELU: "erf" (2.0) | "tanh" (2.6)

    def __post_init__(self):
        if self.quant != "none" and self.remat:
            raise ValueError(
                "quant='int8' is inference-only (no VJP); remat=True marks a "
                "training config — use quant='none' for training")
        if self.act not in ("erf", "tanh"):
            raise ValueError(f"act {self.act!r}: expected 'erf' or 'tanh'")

    @property
    def patch_dim(self) -> int:
        return 3 * self.patch_size * self.patch_size

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(embed_dim=32, depth=2, num_heads=2, mlp_dim=64,
                        pos_grid=4, patch_size=2, dtype=torch.float32)
        defaults.update(kw)
        return cls(**defaults)


class Attention(nn.Module):
    def __init__(self, c: SiglipViTConfig):
        super().__init__()
        e = c.embed_dim
        self.head_dim = c.head_dim
        linear = QuantLinear if c.quant == "int8" else nn.Linear
        self.qkv = linear(e, 3 * e, dtype=c.dtype)
        self.proj = nn.Linear(e, e, dtype=c.dtype)
        # (q heads, kv heads, head dim): mesh.shard_module_tp cuts by heads
        self.tp_heads = (c.num_heads, c.num_heads, c.head_dim)

    def forward(self, y, lengths):
        n, p, e = y.shape
        qkv = self.qkv(y.reshape(n * p, e))
        # this rank's heads under tensor parallelism, else all of them
        heads = qkv.shape[-1] // (3 * self.head_dim)
        o = flash_fwd_lengths_flat(qkv, lengths, n, p, heads,
                                   self.head_dim, False,
                                   self.head_dim ** -0.5)
        return self.proj(o).reshape(n, p, e)


class Mlp(nn.Module):
    def __init__(self, c: SiglipViTConfig):
        super().__init__()
        linear = QuantLinear if c.quant == "int8" else nn.Linear
        self.fc1 = linear(c.embed_dim, c.mlp_dim, dtype=c.dtype)
        self.fc2 = nn.Linear(c.mlp_dim, c.embed_dim, dtype=c.dtype)
        self.act = fast_gelu if c.act == "erf" else functools.partial(
            F.gelu, approximate="tanh")

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class ViTBlock(nn.Module):
    def __init__(self, c: SiglipViTConfig):
        super().__init__()
        self.remat_mlp = c.remat == "mlp"
        self.norm1 = LayerNorm(c.embed_dim, c.ln_eps, dtype=c.dtype)
        self.attn = Attention(c)
        self.norm2 = LayerNorm(c.embed_dim, c.ln_eps, dtype=c.dtype)
        self.mlp = Mlp(c)

    def _mlp_part(self, x):
        return self.mlp(self.norm2(x))

    def forward(self, x, lengths):
        x = x + self.attn(self.norm1(x), lengths)
        if self.remat_mlp and torch.is_grad_enabled():
            return x + checkpoint(self._mlp_part, x, use_reentrant=False)
        return x + self._mlp_part(x)


class PatchEmbed(nn.Module):
    """The timm conv patch embed as a matmul over flattened patches (an
    fp32 Conv2d would run through cuDNN in TF32)."""

    def __init__(self, c: SiglipViTConfig):
        super().__init__()
        self.proj = nn.Linear(c.patch_dim, c.embed_dim, dtype=c.dtype)

    def forward(self, patches):
        return self.proj(patches)


class SiglipViT(nn.Module):
    """patches (N, MAX_P, 3*ps*ps), mask (N, MAX_P) valid-prefix 0/1,
    pos_matrix (N, MAX_P, pos_grid²) → (N, MAX_P, embed_dim); rows where
    mask == 0 are garbage for the caller to mask."""

    def __init__(self, cfg: SiglipViTConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.empty(
            cfg.pos_grid * cfg.pos_grid, cfg.embed_dim, dtype=cfg.dtype))
        self.blocks = nn.ModuleList(ViTBlock(cfg) for _ in range(cfg.depth))
        self.norm = LayerNorm(cfg.embed_dim, cfg.ln_eps, dtype=cfg.dtype)

    def forward(self, patches, mask, pos_matrix):
        dtype = self.cfg.dtype
        x = self.patch_embed(patches.to(dtype))
        x = x + (pos_matrix.float() @ self.pos_embed.float()).to(dtype)
        lengths = mask.sum(dim=1, dtype=torch.int32)
        remat = self.cfg.remat and self.cfg.remat != "mlp" \
            and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, lengths, use_reentrant=False) if remat \
                else block(x, lengths)
        return self.norm(x)

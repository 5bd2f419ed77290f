"""The SigLIP bi-tower: the SigLIP-only retriever baseline.

Counterpart of visrag_tpu/models/siglip.py (BASELINE.json configs[0]:
SigLIP-so400m-patch14-384 page embedding + cosine top-k). The module tree
carries HF SiglipModel's names, so an HF state dict loads by name
(models/hf_loader.load_siglip_hf_state; the conv patch embed (D, 3, ps, ps)
becomes this (D, 3·ps·ps) matmul weight).

  * Encoder layer: pre-LN, q/k/v/out projections, attention through
    ops/attention.flash_attention in the (B, S, H, D) layout, MLP with
    gelu_pytorch_tanh. At SigLIP's d 72 with Sq == Sk this is K1 stacked,
    not causal: at full length in the vision tower (no lengths), at the
    mask's lengths in the text tower.
  * Text tower: token + position embeddings, final LayerNorm, pooled =
    the last row through `head` (HF siglip). With an attention mask that
    row is a pad row: K1 writes exact zeros on pad rows where the JAX path
    writes other values, so the pooled output under a mask is not the JAX
    one (ROADMAP §3); the reference feeds SigLIP full-length ids
    (padding="max_length", no mask).
  * Vision tower: pre-patchified (B, N, 3·ps·ps) pixels, (c, ph, pw)
    row-major per patch, through the patch matmul, position embeddings,
    the encoder and `post_layernorm`, then the MAP head: a learnable probe
    cross-attending all N rows (plain torch, as the JAX head is plain XLA;
    q, k and v in the model dtype, scores and softmax in fp32, the output
    projection in the model dtype), LayerNorm and an MLP residual.
  * vocab_size keeps the JAX default (250,000), not HF SiglipTextConfig's
    32,000; a checkpoint's table size is its own.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention
from .common import LayerNorm


@dataclasses.dataclass(frozen=True)
class SiglipTowerConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class SiglipConfig:
    text: SiglipTowerConfig = SiglipTowerConfig()
    vision: SiglipTowerConfig = SiglipTowerConfig()
    vocab_size: int = 250000
    max_position_embeddings: int = 64
    projection_size: int = 1152
    image_size: int = 384
    patch_size: int = 14

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def tiny(cls, **kw):
        tower = SiglipTowerConfig(hidden_size=32, intermediate_size=64,
                                  num_hidden_layers=2, num_attention_heads=2,
                                  dtype=torch.float32)
        d = dict(text=tower, vision=tower, vocab_size=128,
                 max_position_embeddings=16, projection_size=32,
                 image_size=16, patch_size=4)
        d.update(kw)
        return cls(**d)


class SiglipAttention(nn.Module):
    def __init__(self, c: SiglipTowerConfig):
        super().__init__()
        e = c.hidden_size
        self.heads, self.head_dim = c.num_attention_heads, c.head_dim
        self.q_proj = nn.Linear(e, e, dtype=c.dtype)
        self.k_proj = nn.Linear(e, e, dtype=c.dtype)
        self.v_proj = nn.Linear(e, e, dtype=c.dtype)
        self.out_proj = nn.Linear(e, e, dtype=c.dtype)

    def forward(self, y, lengths=None):
        b, s, e = y.shape
        shape = (b, s, self.heads, self.head_dim)
        o = flash_attention(self.q_proj(y).reshape(shape),
                            self.k_proj(y).reshape(shape),
                            self.v_proj(y).reshape(shape), lengths=lengths,
                            causal=False)
        return self.out_proj(o.reshape(b, s, e))


class SiglipMLP(nn.Module):
    def __init__(self, c: SiglipTowerConfig):
        super().__init__()
        self.fc1 = nn.Linear(c.hidden_size, c.intermediate_size, dtype=c.dtype)
        self.fc2 = nn.Linear(c.intermediate_size, c.hidden_size, dtype=c.dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SiglipEncoderLayer(nn.Module):
    def __init__(self, c: SiglipTowerConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm(c.hidden_size, c.layer_norm_eps,
                                     dtype=c.dtype)
        self.self_attn = SiglipAttention(c)
        self.layer_norm2 = LayerNorm(c.hidden_size, c.layer_norm_eps,
                                     dtype=c.dtype)
        self.mlp = SiglipMLP(c)

    def forward(self, x, lengths=None):
        x = x + self.self_attn(self.layer_norm1(x), lengths)
        return x + self.mlp(self.layer_norm2(x))


class SiglipEncoder(nn.Module):
    def __init__(self, c: SiglipTowerConfig):
        super().__init__()
        self.layers = nn.ModuleList(SiglipEncoderLayer(c)
                                    for _ in range(c.num_hidden_layers))

    def forward(self, x, lengths=None):
        for layer in self.layers:
            x = layer(x, lengths)
        return x


class SiglipTextEmbeddings(nn.Module):
    def __init__(self, c: SiglipConfig):
        super().__init__()
        t = c.text
        self.token_embedding = nn.Embedding(c.vocab_size, t.hidden_size,
                                            dtype=t.dtype)
        self.position_embedding = nn.Embedding(c.max_position_embeddings,
                                               t.hidden_size, dtype=t.dtype)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        return self.token_embedding(input_ids) \
            + self.position_embedding.weight[None, :s]


class SiglipTextTower(nn.Module):
    def __init__(self, c: SiglipConfig):
        super().__init__()
        t = c.text
        self.embeddings = SiglipTextEmbeddings(c)
        self.encoder = SiglipEncoder(t)
        self.final_layer_norm = LayerNorm(t.hidden_size, t.layer_norm_eps,
                                          dtype=t.dtype)
        self.head = nn.Linear(t.hidden_size, c.projection_size, dtype=t.dtype)

    def forward(self, input_ids, attention_mask=None):
        """input_ids (B, S) → (hidden (B, S, E), pooled (B, projection))."""
        input_ids = input_ids.to(self.head.weight.device)
        x = self.embeddings(input_ids)
        lengths = None if attention_mask is None else \
            attention_mask.to(x.device).sum(dim=1, dtype=torch.int32)
        x = self.final_layer_norm(self.encoder(x, lengths))
        return x, self.head(x[:, -1])


class SiglipVisionEmbeddings(nn.Module):
    def __init__(self, c: SiglipConfig):
        super().__init__()
        v = c.vision
        self.patch_embedding = nn.Linear(3 * c.patch_size ** 2, v.hidden_size,
                                         dtype=v.dtype)
        self.position_embedding = nn.Embedding(c.num_patches, v.hidden_size,
                                               dtype=v.dtype)

    def forward(self, patches):
        n = patches.shape[1]
        x = self.patch_embedding(patches.to(self.patch_embedding.weight))
        return x + self.position_embedding.weight[None, :n]


class SiglipMAPAttention(nn.Module):
    """The parameters of the MAP head's nn.MultiheadAttention, by HF's
    names; the attention itself is SiglipMAPHead's."""

    def __init__(self, c: SiglipTowerConfig):
        super().__init__()
        e = c.hidden_size
        self.in_proj_weight = nn.Parameter(torch.empty(3 * e, e,
                                                       dtype=c.dtype))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * e, dtype=c.dtype))
        self.out_proj = nn.Linear(e, e, dtype=c.dtype)


class SiglipMAPHead(nn.Module):
    """Multihead attention pooling: a learnable probe attends every row,
    then LayerNorm and an MLP residual; → the probe's row."""

    def __init__(self, c: SiglipTowerConfig):
        super().__init__()
        self.heads = c.num_attention_heads
        self.probe = nn.Parameter(torch.empty(1, 1, c.hidden_size,
                                              dtype=c.dtype))
        self.attention = SiglipMAPAttention(c)
        self.layernorm = LayerNorm(c.hidden_size, c.layer_norm_eps,
                                   dtype=c.dtype)
        self.mlp = SiglipMLP(c)

    def forward(self, x):
        b, n, e = x.shape
        h, d = self.heads, e // self.heads
        wq, wk, wv = self.attention.in_proj_weight.chunk(3)
        bq, bk, bv = self.attention.in_proj_bias.chunk(3)
        q = F.linear(self.probe.expand(b, 1, e), wq, bq).reshape(b, 1, h, d)
        k = F.linear(x, wk, bk).reshape(b, n, h, d)
        v = F.linear(x, wv, bv).reshape(b, n, h, d)
        s = torch.einsum("bqhd,bnhd->bhqn", q.float(), k.float()) / d ** 0.5
        o = torch.einsum("bhqn,bnhd->bqhd", torch.softmax(s, dim=-1),
                         v.float())
        o = self.attention.out_proj(o.reshape(b, 1, e).to(x.dtype))
        o = o + self.mlp(self.layernorm(o))
        return o[:, 0]


class SiglipVisionTower(nn.Module):
    """Fixed-size vision tower (image_size² / patch² rows) with the MAP
    head."""

    def __init__(self, c: SiglipConfig):
        super().__init__()
        v = c.vision
        self.embeddings = SiglipVisionEmbeddings(c)
        self.encoder = SiglipEncoder(v)
        self.post_layernorm = LayerNorm(v.hidden_size, v.layer_norm_eps,
                                        dtype=v.dtype)
        self.head = SiglipMAPHead(v)

    def forward(self, patches):
        """patches (B, N, 3·ps·ps) → (hidden (B, N, E), pooled (B, E))."""
        x = self.post_layernorm(self.encoder(self.embeddings(patches)))
        return x, self.head(x)


class SiglipModel(nn.Module):
    """The bi-tower with HF's logit_scale / logit_bias; the pooled outputs
    are the retriever's embeddings (`siglip_pooling`)."""

    def __init__(self, cfg: SiglipConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = SiglipTextTower(cfg)
        self.vision_model = SiglipVisionTower(cfg)
        self.logit_scale = nn.Parameter(torch.ones(1))
        self.logit_bias = nn.Parameter(torch.zeros(1))

    def encode_text(self, input_ids, attention_mask=None):
        return self.text_model(input_ids, attention_mask)[1]

    def encode_image(self, patches):
        return self.vision_model(patches)[1]

    def forward(self, input_ids=None, patches=None, attention_mask=None):
        t = None if input_ids is None else \
            self.encode_text(input_ids, attention_mask)
        v = None if patches is None else self.encode_image(patches)
        return t, v

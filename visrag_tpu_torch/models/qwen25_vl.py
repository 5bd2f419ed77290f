"""Qwen2.5-VL (3B/7B): the EVisRAG generator.

Counterpart of visrag_tpu/models/qwen25_vl.py (configs, vision tower, text
model with its sequence-parallel `sp_mesh` path, Qwen25VL with the
training forward and prefill / decode / embed_prompt / prefill_chunk, and
the critic's `QwenForValue`). Module names follow the HF
checkpoint (`visual.blocks.{i}.attn.qkv`,
`model.layers.{i}.self_attn.q_proj`, ...), so loading is a copy by name
(models/hf_loader.py).

  * Vision tower: one packed, window-permuted patch stream (host prep in
    preprocess/qwen_vision.py). Window and full-attention layers are both
    one banded segment-attention call (ops/attention_kvgrid.py, K3): window
    segments in the window layers, one segment per image in the
    `fullatt_block_indexes` layers. uint8 device-mode patches are CLIP-
    normalized here, on the device.
  * Text model: Qwen2 decoder (GQA, qkv bias, RMSNorm, SwiGLU) with 3-D
    mrope. Whole-prompt prefill is the stacked causal lengths kernel with
    grouped kv heads (ops/attention_lengths.py, K1); decode reads the paged
    pool through K5 (serving/paged_kv.py) or, without a block table, a dense
    cache; chunked prefill writes the chunk into the pool and attends the
    prefix gathered (and dequantized) from it through the chunk kernel
    (ops/attention.chunk_attention, K8).
  * Training forward (the RL update): `segment_ids` runs packed rows
    through the segment kernel K4 (ops/attention.flash_attention, causal),
    whose backward is K4's dq and dk/dv; `attention_mask` rows keep K1.
    `vision_embeds` + `slot_map` scatter a precomputed table of the frozen
    tower's outputs. `remat` (text config): True recomputes whole blocks in
    the backward, "mlp" only each block's MLP, False nothing
    (torch.utils.checkpoint, non-reentrant, only while gradients are on).
    `Qwen25VL.forward(..., return_logits=False)` skips the full-sequence LM
    head: eager PyTorch has no dead-code elimination, and (B, S, vocab)
    logits of a 16k-token row are 10 GB in fp32.
  * Sequence parallelism (`sp_mesh`, a mesh with a seq axis): each rank of
    the seq group keeps its contiguous block of the sequence through every
    layer (the embeddings, mrope positions and cos/sin are sliced along S;
    the vision tower runs unsharded), attention runs
    parallel/ulysses.sp_flash_attention (`sp_backend` "ulysses": K4 at
    H/n heads between all_to_alls; "ring": P2P ring attention), and the
    model returns this rank's block of the hidden states.
  * KV writes are in place into the caller's layer-stacked cache tensors
    (layers, ...), which the JAX package threads through as donated
    per-layer buffers instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..ops.attention import chunk_attention, flash_attention
from ..ops.attention_kvgrid import flash_attention_kvgrid
from ..ops.attention_lengths import flash_fwd_lengths
from ..preprocess.qwen_vision import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD
from ..utils import profiling
from .common import RMSNorm, prefill_outputs, scatter_vision, tied_logits
from .mrope import apply_rope_cos_sin, mrope_cos_sin


@dataclasses.dataclass(frozen=True)
class QwenVisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3456
    num_heads: int = 16
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    out_hidden_size: int = 2048
    rms_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    remat: bool = False       # recompute whole blocks in the backward
    # "auto" / "banded": the banded segment kernel K3 (its plain version on
    # the CPU). "packed": the general segment kernel K4, which scans every
    # key tile's id range instead of searching a band.
    attn_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return 3 * self.temporal_patch_size * self.patch_size ** 2

    @classmethod
    def tiny(cls, **kw):
        d = dict(depth=2, hidden_size=32, intermediate_size=64, num_heads=2,
                 fullatt_block_indexes=(1,), out_hidden_size=48,
                 dtype=torch.float32)
        d.update(kw)
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class QwenTextConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 11008
    num_hidden_layers: int = 36
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    mrope_section: Tuple[int, ...] = (16, 24, 24)
    tie_word_embeddings: bool = True
    dtype: Any = torch.bfloat16
    # False | True (whole-block recomputation) | "mlp" (the MLP only)
    remat: Any = False
    # sequence-parallel attention when an sp_mesh is passed: "ulysses"
    # (all_to_all head sharding) | "ring" (P2P k/v rotation)
    sp_backend: str = "ulysses"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=128, hidden_size=48, intermediate_size=96,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, mrope_section=(2, 2, 2),
                 dtype=torch.float32)
        d.update(kw)
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Qwen25VLConfig:
    vision: QwenVisionConfig = QwenVisionConfig()
    text: QwenTextConfig = QwenTextConfig()
    image_token_id: int = 151655
    vision_start_token_id: int = 151652

    @classmethod
    def b3(cls):
        """Qwen2.5-VL-3B-Instruct dims."""
        return cls(vision=QwenVisionConfig(out_hidden_size=2048),
                   text=QwenTextConfig())

    @classmethod
    def b7(cls):
        """Qwen2.5-VL-7B-Instruct dims."""
        return cls(
            vision=QwenVisionConfig(out_hidden_size=3584),
            text=QwenTextConfig(hidden_size=3584, intermediate_size=18944,
                                num_hidden_layers=28, num_attention_heads=28,
                                num_key_value_heads=4, vocab_size=152064,
                                tie_word_embeddings=False))

    @classmethod
    def tiny(cls, **kw):
        d = dict(vision=QwenVisionConfig.tiny(out_hidden_size=48),
                 text=QwenTextConfig.tiny(),
                 image_token_id=120, vision_start_token_id=119)
        d.update(kw)
        return cls(**d)

    @classmethod
    def from_hf(cls, d: dict, dtype=torch.bfloat16) -> "Qwen25VLConfig":
        """From an HF checkpoint's config.json dict, flat (the original
        Qwen2.5-VL releases) or with nested text_config / vision_config.
        Fields absent from the json keep the 3B defaults."""
        t = d.get("text_config") or d
        v = d.get("vision_config") or {}

        def pick(src, config_cls, skip=("dtype", "sp_backend")):
            names = {f.name for f in dataclasses.fields(config_cls)}
            return {k: (tuple(x) if isinstance(x := src[k], list) else x)
                    for k in src
                    if k in names and k not in skip
                    and not isinstance(src[k], dict)}

        tkw = pick(t, QwenTextConfig)
        rs = t.get("rope_scaling") or {}
        if rs.get("mrope_section"):
            tkw["mrope_section"] = tuple(rs["mrope_section"])
        return cls(
            vision=QwenVisionConfig(dtype=dtype, **pick(v, QwenVisionConfig)),
            text=QwenTextConfig(dtype=dtype, **tkw),
            image_token_id=d.get("image_token_id", 151655),
            vision_start_token_id=d.get("vision_start_token_id", 151652))


# ---------------------------------------------------------------------------
# Vision tower
# ---------------------------------------------------------------------------


class QwenVisionAttention(nn.Module):
    def __init__(self, c: QwenVisionConfig):
        super().__init__()
        e = c.hidden_size
        self.qkv = nn.Linear(e, 3 * e, bias=True, dtype=c.dtype)
        self.proj = nn.Linear(e, e, bias=True, dtype=c.dtype)
        # (q heads, kv heads, head dim): mesh.shard_module_tp cuts by heads
        self.tp_heads = (c.num_heads, c.num_heads, c.head_dim)


class QwenMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, e: int, inner: int, bias: bool, dtype):
        super().__init__()
        self.gate_proj = nn.Linear(e, inner, bias=bias, dtype=dtype)
        self.up_proj = nn.Linear(e, inner, bias=bias, dtype=dtype)
        self.down_proj = nn.Linear(inner, e, bias=bias, dtype=dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class QwenVisionBlock(nn.Module):
    def __init__(self, c: QwenVisionConfig):
        super().__init__()
        self.cfg = c
        self.norm1 = RMSNorm(c.hidden_size, c.rms_eps, dtype=c.dtype)
        self.attn = QwenVisionAttention(c)
        self.norm2 = RMSNorm(c.hidden_size, c.rms_eps, dtype=c.dtype)
        self.mlp = QwenMLP(c.hidden_size, c.intermediate_size, True, c.dtype)

    def forward(self, x, cos, sin, seg):
        """x (S, E); cos/sin (S, head_dim); seg (S,) int32 segment ids.
        Under tensor parallelism the block holds this rank's heads."""
        c = self.cfg
        s = x.shape[0]
        qkv = self.attn.qkv(self.norm1(x)).view(1, s, 3, -1, c.head_dim)
        q, k, v = qkv.unbind(2)                     # (1, S, H, D) views
        q, k = apply_rope_cos_sin(q, k, cos[None], sin[None])
        if c.attn_impl == "packed":
            o = flash_attention(q, k, v, seg[None], seg[None], causal=False)
        else:
            o = flash_attention_kvgrid(q, k, v, seg[None])
        x = x + self.attn.proj(o.reshape(s, -1))
        return x + self.mlp(self.norm2(x))


class QwenVisionMerger(nn.Module):
    """RMSNorm, then each merge² group of neighbours → a 2-layer MLP."""

    def __init__(self, c: QwenVisionConfig):
        super().__init__()
        mu = c.spatial_merge_size ** 2
        self.ln_q = RMSNorm(c.hidden_size, c.rms_eps, dtype=c.dtype)
        self.mlp = nn.Sequential(
            nn.Linear(mu * c.hidden_size, mu * c.hidden_size, dtype=c.dtype),
            nn.GELU(),
            nn.Linear(mu * c.hidden_size, c.out_hidden_size, dtype=c.dtype))
        self.group = mu * c.hidden_size

    def forward(self, x):
        return self.mlp(self.ln_q(x).reshape(-1, self.group))


class QwenVisionTower(nn.Module):
    """Packed-stream vision tower: (S_pad, patch_dim) window-permuted
    patches → (S_pad / merge², out_hidden) merged tokens in image order."""

    def __init__(self, cfg: QwenVisionConfig):
        super().__init__()
        if cfg.attn_impl not in ("auto", "banded", "packed"):
            raise ValueError(f"QwenVisionConfig.attn_impl {cfg.attn_impl!r}: "
                             "expected 'auto', 'banded' or 'packed'")
        self.cfg = cfg
        # HF's conv `patch_embed.proj` (D, 3, t, ps, ps) as a matmul weight
        self.patch_embed = nn.Linear(cfg.patch_dim, cfg.hidden_size,
                                     bias=False, dtype=cfg.dtype)
        self.blocks = nn.ModuleList(QwenVisionBlock(cfg)
                                    for _ in range(cfg.depth))
        self.merger = QwenVisionMerger(cfg)

    def forward(self, patches, rot_cos, rot_sin, seg_window, seg_full,
                reverse_index):
        c = self.cfg
        x = self.patch_embed(patches.to(c.dtype))
        seg_window = seg_window.to(torch.int32).contiguous()
        seg_full = seg_full.to(torch.int32).contiguous()
        remat = c.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            seg = seg_full if i in c.fullatt_block_indexes else seg_window
            x = checkpoint(block, x, rot_cos, rot_sin, seg,
                           use_reentrant=False) if remat \
                else block(x, rot_cos, rot_sin, seg)
        return self.merger(x)[reverse_index.long()]


# ---------------------------------------------------------------------------
# Text model
# ---------------------------------------------------------------------------


class QwenTextAttention(nn.Module):
    def __init__(self, c: QwenTextConfig):
        super().__init__()
        e, d = c.hidden_size, c.head_dim
        h, hk = c.num_attention_heads, c.num_key_value_heads
        self.q_proj = nn.Linear(e, h * d, bias=True, dtype=c.dtype)
        self.k_proj = nn.Linear(e, hk * d, bias=True, dtype=c.dtype)
        self.v_proj = nn.Linear(e, hk * d, bias=True, dtype=c.dtype)
        self.o_proj = nn.Linear(h * d, e, bias=False, dtype=c.dtype)
        self.tp_heads = (h, hk, d)


class QwenTextBlock(nn.Module):
    def __init__(self, c: QwenTextConfig):
        super().__init__()
        self.cfg = c
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps,
                                       dtype=c.dtype)
        self.self_attn = QwenTextAttention(c)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps,
                                                dtype=c.dtype)
        self.mlp = QwenMLP(c.hidden_size, c.intermediate_size, False, c.dtype)

    def _qkv(self, x, cos, sin):
        c = self.cfg
        b, s, _ = x.shape
        d = c.head_dim
        y = self.input_layernorm(x)
        a = self.self_attn
        # the head counts come from the projections: a tensor-parallel
        # shard holds its own heads
        q = a.q_proj(y).view(b, s, -1, d)
        k = a.k_proj(y).view(b, s, -1, d)
        v = a.v_proj(y).view(b, s, -1, d)
        q, k = apply_rope_cos_sin(q, k, cos, sin)
        return q, k, v

    def _mlp_part(self, x):
        return self.mlp(self.post_attention_layernorm(x))

    def _residual(self, x, attn_out):
        b, s, _ = x.shape
        x = x + self.self_attn.o_proj(attn_out.reshape(b, s, -1))
        if self.cfg.remat == "mlp" and torch.is_grad_enabled():
            return x + checkpoint(self._mlp_part, x, use_reentrant=False)
        return x + self._mlp_part(x)

    def forward(self, x, cos, sin, lengths, seg=None, sp_mesh=None):
        """Whole-row causal pass: right-padded rows with `lengths` (K1), or
        packed rows with segment ids `seg` (B, S) int32 (K4; lengths is
        then None). With sp_mesh, x is this rank's sequence block and
        lengths / seg the full rows' (sp_flash_attention). → (out, (k, v))
        with k/v (B, S, kvh, d) after rope."""
        q, k, v = self._qkv(x, cos, sin)
        if sp_mesh is not None:
            from ..parallel.ulysses import sp_flash_attention
            o = sp_flash_attention(q, k, v, q_seg=seg, kv_seg=seg,
                                   lengths=lengths, causal=True,
                                   mesh=sp_mesh, backend=self.cfg.sp_backend)
        elif seg is not None:
            o = flash_attention(q, k, v, seg, seg, causal=True)
        else:
            o = flash_fwd_lengths(q, k, v, lengths, True,
                                  self.cfg.head_dim ** -0.5)
        return self._residual(x, o), (k, v)

    def prefill_chunk(self, x, cos, sin, kc, vc, chunk_rows, gather_rows,
                      start):
        """One block-aligned chunk of ONE prompt: x (1, C, E) at global
        positions start + arange(C). Writes the chunk's K/V into this
        layer's pools kc/vc (n_blocks, kvh, bs, d; bf16, or int8 KVQuant
        quantized on write) at chunk_rows, then attends the whole prefix
        gathered (and dequantized) from gather_rows."""
        from ..serving.paged_kv import pool_gather, pool_write_rows
        q, k, v = self._qkv(x, cos, sin)
        bs = kc.shape[2]
        cl = x.shape[1]
        kvh, d = k.shape[2], k.shape[3]
        pool_write_rows(kc, chunk_rows, k[0].reshape(cl // bs, bs, kvh, d)
                        .transpose(1, 2))
        pool_write_rows(vc, chunk_rows, v[0].reshape(cl // bs, bs, kvh, d)
                        .transpose(1, 2))
        ng = gather_rows.shape[0]
        kg = pool_gather(kc, gather_rows, q.dtype).transpose(1, 2) \
            .reshape(1, ng * bs, kvh, d)
        vg = pool_gather(vc, gather_rows, q.dtype).transpose(1, 2) \
            .reshape(1, ng * bs, kvh, d)
        o = chunk_attention(q, kg, vg, start.reshape(1))
        return self._residual(x, o)

    def decode(self, x, cos, sin, kc, vc, lengths_incl, block_table=None):
        """x (B, 1, E); lengths_incl counts this step's token. kc/vc: this
        layer's dense cache (B, L_max, kvh, d) when block_table is None,
        else its paged pool (n_blocks, kvh, bs, d), bf16 or an int8
        KVQuant (read by K5's int8 variant); this token's K/V is written
        at lengths_incl - 1, in place."""
        q, k, v = self._qkv(x, cos, sin)
        b = x.shape[0]
        pos = lengths_incl.long() - 1
        if block_table is None:
            from ..serving.kv_cache import decode_attention
            rows = torch.arange(b, device=x.device)
            kc[rows, pos] = k[:, 0].to(kc.dtype)
            vc[rows, pos] = v[:, 0].to(vc.dtype)
            o = decode_attention(q[:, 0], kc, vc, lengths_incl)
        else:
            from ..serving.paged_kv import paged_decode_attention, write_token
            write_token(kc, block_table, pos, k[:, 0])
            write_token(vc, block_table, pos, v[:, 0])
            o = paged_decode_attention(q[:, 0], kc, vc, block_table,
                                       lengths_incl)
        return self._residual(x, o[:, None])


class QwenTextModel(nn.Module):
    def __init__(self, cfg: QwenTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype=cfg.dtype)
        self.layers = nn.ModuleList(QwenTextBlock(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype=cfg.dtype)

    def cos_sin(self, positions, b, s, device):
        """positions (3, B, S) mrope streams, (B, S) (broadcast to all
        three) or None (arange) → cos/sin (B, S, head_dim) fp32."""
        c = self.cfg
        if positions is None:
            positions = torch.arange(s, device=device).expand(b, s)
        positions = positions.to(device)
        if positions.dim() == 2:
            positions = positions[None].expand(3, b, s)
        inv_freq = 1.0 / (c.rope_theta ** (
            torch.arange(0, c.head_dim, 2, dtype=torch.float32,
                         device=device) / c.head_dim))
        return mrope_cos_sin(positions, inv_freq, c.mrope_section)

    def forward(self, input_ids=None, *, inputs_embeds=None, positions=None,
                attention_mask=None, segment_ids=None, return_kv=False,
                sp_mesh=None):
        """Causal pass over right-padded rows (attention_mask (B, S): a
        contiguous valid prefix per row; None: all valid) or, with
        segment_ids (B, S), over packed rows whose sequences stay
        independent (ids <= 0 are padding). → hidden (B, S, E) after the
        final norm, and with return_kv the per-layer (k, v) list. sp_mesh:
        a mesh (mesh.build_mesh) whose seq ranks share these rows; at seq
        > 1 the hidden states returned are this rank's (B, S / seq, E)
        block of the sequence."""
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        b, s, _ = inputs_embeds.shape
        device = inputs_embeds.device
        cos, sin = self.cos_sin(positions, b, s, device)
        from ..mesh import SEQ, axis_index, axis_size
        n_seq = axis_size(sp_mesh, SEQ)
        if n_seq > 1:
            if s % n_seq or return_kv:
                raise ValueError(f"sequence parallelism over {n_seq} ranks "
                                 f"needs S ({s}) a multiple of it "
                                 "(parallel.ulysses.pad_seq_for_ulysses) "
                                 "and no return_kv")
            blk = slice(axis_index(sp_mesh, SEQ) * (s // n_seq),
                        (axis_index(sp_mesh, SEQ) + 1) * (s // n_seq))
            inputs_embeds = inputs_embeds[:, blk]
            cos, sin = cos[:, blk], sin[:, blk]
        seg = lengths = None
        if segment_ids is not None:
            seg = segment_ids.to(device=device, dtype=torch.int32).contiguous()
        elif attention_mask is None:
            lengths = torch.full((b,), s, dtype=torch.int32, device=device)
        else:
            lengths = attention_mask.to(device).sum(dim=1, dtype=torch.int32)
        x = inputs_embeds.to(self.cfg.dtype)
        remat = self.cfg.remat and self.cfg.remat != "mlp" \
            and torch.is_grad_enabled() and not return_kv
        kvs = []
        for layer in self.layers:
            if remat:
                # the module's own call, so that FSDP2's hooks gather a
                # sharded block's weights in the forward and the recompute
                x = checkpoint(layer, x, cos, sin, lengths, seg, sp_mesh,
                               use_reentrant=False)[0]
                continue
            x, kv = layer(x, cos, sin, lengths, seg, sp_mesh)
            if return_kv:
                kvs.append(kv)
        out = self.norm(x)
        return (out, kvs) if return_kv else out

    def decode(self, inputs_embeds, positions, k_cache, v_cache, lengths_incl,
               block_table=None):
        """One decode step over the layer stack; k_cache/v_cache are
        layer-stacked (layers, ...) caches written in place. → hidden."""
        b = inputs_embeds.shape[0]
        cos, sin = self.cos_sin(positions, b, 1, inputs_embeds.device)
        x = inputs_embeds.to(self.cfg.dtype)
        for i, layer in enumerate(self.layers):
            x = layer.decode(x, cos, sin, k_cache[i], v_cache[i],
                             lengths_incl, block_table)
        return self.norm(x)

    def prefill_chunk(self, inputs_embeds, positions, k_cache, v_cache,
                      chunk_rows, gather_rows, start):
        cos, sin = self.cos_sin(positions, 1, inputs_embeds.shape[1],
                                inputs_embeds.device)
        x = inputs_embeds.to(self.cfg.dtype)
        for i, layer in enumerate(self.layers):
            x = layer.prefill_chunk(x, cos, sin, k_cache[i], v_cache[i],
                                    chunk_rows, gather_rows, start)
        return self.norm(x)


class QwenForValue(nn.Module):
    """Token-level value head over the Qwen text stack: the critic (the
    reference loads AutoModelForTokenClassification with one label).
    Multimodal prompts enter through `vision_embeds` + `slot_map`, a
    precomputed table of the frozen tower's outputs, as in the actor's RL
    update. → (B, S) fp32 values; the head is fp32."""

    def __init__(self, cfg: QwenTextConfig):
        super().__init__()
        self.cfg = cfg
        self.model = QwenTextModel(cfg)
        self.score = nn.Linear(cfg.hidden_size, 1, bias=False,
                               dtype=torch.float32)

    def forward(self, input_ids, attention_mask=None, positions=None,
                segment_ids=None, slot_map=None, vision_embeds=None):
        embeds = self.model.embed_tokens(input_ids)
        if vision_embeds is not None and slot_map is not None:
            embeds = scatter_vision(embeds, slot_map, vision_embeds)
        hidden = self.model(inputs_embeds=embeds, positions=positions,
                            attention_mask=attention_mask,
                            segment_ids=segment_ids)
        return self.score(hidden.float())[..., 0]


class Qwen25VL(nn.Module):
    """Conditional generation: vision tokens scattered into the text stream
    by a slot map (slot_map[b, s] >= 0 picks that row of the tower's
    output), then the LM head."""

    def __init__(self, cfg: Qwen25VLConfig):
        super().__init__()
        self.cfg = cfg
        self.visual = QwenVisionTower(cfg.vision)
        self.model = QwenTextModel(cfg.text)
        if not cfg.text.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.text.hidden_size, cfg.text.vocab_size,
                                     bias=False, dtype=cfg.text.dtype)

    def encode_images(self, vision_batch: dict):
        """vision_batch: the prepare_vision_batch arrays as tensors on the
        model's device. uint8 patches (device mode) are CLIP-normalized
        here; the flat patch layout is channel-major, so each channel's
        constant repeats patch_dim / 3 times."""
        with profiling.span("qwen.vision"):
            patches = vision_batch["patches"]
            if patches.dtype == torch.uint8:
                per = patches.shape[-1] // 3
                mean = torch.tensor(OPENAI_CLIP_MEAN, dtype=torch.float32,
                                    device=patches.device
                                    ).repeat_interleave(per)
                std = torch.tensor(OPENAI_CLIP_STD, dtype=torch.float32,
                                   device=patches.device
                                   ).repeat_interleave(per)
                patches = (patches.float() / 255.0 - mean) / std
            return self.visual(patches, vision_batch["rot_cos"],
                               vision_batch["rot_sin"],
                               vision_batch["seg_window"],
                               vision_batch["seg_full"],
                               vision_batch["reverse_index"])

    def compute_logits(self, hidden):
        if self.cfg.text.tie_word_embeddings:
            return tied_logits(self.model.embed_tokens, hidden)
        return self.lm_head(hidden)

    def _embed(self, input_ids, vision_batch=None, slot_map=None,
               vision_embeds=None):
        embeds = self.model.embed_tokens(input_ids)
        vis = vision_embeds
        if vis is None and vision_batch is not None:
            vis = self.encode_images(vision_batch)
        if vis is not None:
            embeds = scatter_vision(embeds, slot_map, vis)
        return embeds

    def forward(self, input_ids, attention_mask=None, positions=None,
                vision_batch=None, slot_map=None, segment_ids=None,
                vision_embeds=None, return_logits=True, sp_mesh=None):
        """→ (logits (B, S, V), hidden (B, S, E)). vision_embeds: a
        precomputed (N, E) table of tower outputs that slot_map indexes (the
        frozen-tower RL update), instead of vision_batch. return_logits
        False → (None, hidden): the caller projects chunks of hidden
        itself and the (B, S, V) tensor is never built. sp_mesh: sequence
        parallelism (QwenTextModel.forward): at seq > 1, S in the outputs
        is this rank's block."""
        hidden = self.model(
            inputs_embeds=self._embed(input_ids, vision_batch, slot_map,
                                      vision_embeds),
            positions=positions, attention_mask=attention_mask,
            segment_ids=segment_ids, sp_mesh=sp_mesh)
        return (self.compute_logits(hidden) if return_logits else None), \
            hidden

    def prefill(self, input_ids, attention_mask=None, positions=None,
                vision_batch=None, slot_map=None, last_pos=None):
        """Whole-prompt pass returning the K/V for the cache: → (logits, k
        (layers, B, S, kvh, d), v). last_pos (B,): logits only at those
        positions → (B, V), never a (B, S, V) buffer; None → (B, S, V)."""
        hidden, kvs = self.model(
            inputs_embeds=self._embed(input_ids, vision_batch, slot_map),
            positions=positions, attention_mask=attention_mask,
            return_kv=True)
        return prefill_outputs(self, hidden, kvs, last_pos)

    def decode(self, token_ids, positions, k_cache, v_cache, lengths_incl,
               block_table=None):
        """token_ids (B, 1); positions (3, B, 1); caches layer-stacked and
        written in place. → logits (B, V)."""
        hidden = self.model.decode(self.model.embed_tokens(token_ids),
                                   positions, k_cache, v_cache, lengths_incl,
                                   block_table)
        return self.compute_logits(hidden)[:, 0]

    def embed_prompt(self, input_ids, vision_batch=None, slot_map=None):
        """The whole prompt's (1, S, E) embeddings, the vision tower run
        once, for chunked prefill of a multimodal prompt."""
        return self._embed(input_ids, vision_batch, slot_map)

    def prefill_chunk(self, token_ids, positions, k_cache, v_cache,
                      chunk_rows, gather_rows, start, last_pos=None,
                      inputs_embeds=None):
        """Chunked prefill of ONE prompt (B = 1): token_ids (1, C) at global
        positions start .. start + C - 1 (C and start block-aligned);
        chunk_rows (C // bs,) pool rows this chunk writes; gather_rows the
        rows covering [0, start + C). inputs_embeds (1, C, E) overrides the
        token embedding (vision prompts: a slice of embed_prompt's table).
        → logits (1, V) at the LOCAL position last_pos (1,), or None."""
        embeds = inputs_embeds if inputs_embeds is not None \
            else self.model.embed_tokens(token_ids)
        hidden = self.model.prefill_chunk(embeds, positions, k_cache, v_cache,
                                          chunk_rows, gather_rows, start)
        if last_pos is None:
            return None
        pos = last_pos.to(hidden.device).long().reshape(1)
        return self.compute_logits(hidden.index_select(1, pos)[:, 0])

"""Shared driver plumbing: model, tokenizer and pipeline construction.

Counterpart of visrag_tpu/driver/common.py (build_visrag_ret,
build_tokenizer, get_tokenizer). With a checkpoint directory, the
tokenizer is its HF tokenizer (the MockTokenizer without one), the LM's
rope scaling comes from its config.json (linear or dynamic; any other type
raises), and the weights load by their HF names (models/hf_loader). Without
one, the model is initialised at random from a seed, with the JAX
package's initialiser families so that activations stay finite through the
40 MUP-scaled LM layers:

  * linear and patch-embed weights: truncated normal with std
    1/sqrt(out_features) (flax lecun_normal reads fan-in from the first
    axis of the JAX package's (out, in) layout); biases zero;
  * norms: weight one, bias zero;
  * token embeddings: normal, std 1/sqrt(hidden);
  * ViT pos_embed: normal(0.02); resampler query: truncated normal(0.02);
    resampler in_proj: xavier uniform; resampler proj: normal(E^-1/2);
    the resampler's query pos embed: the fixed 8×8 2-D sin-cos table;
    SigLIP's MAP head: probe normal(0.02), in_proj xavier uniform.

Full width is bf16, `tiny` fp32. `ModelConfig.remat` switches on
whole-block recomputation in the ViT and the LM when gradients are on.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch
from torch import nn

from ..config import ModelConfig
from ..models.common import LayerNorm, RMSNorm, get_2d_sincos_pos_embed
from ..models.hf_loader import (load_safetensors_dir, load_visrag_ret_state,
                                minicpmv_hf_to_port)
from ..models.resampler import Resampler
from ..models.siglip import SiglipMAPHead
from ..models.siglip_vit import SiglipViT
from ..models.visrag_ret import VisRAGRet, VisRAGRetConfig
from ..preprocess import MockTokenizer, PipelineConfig
from ..preprocess.tokenize import HFTokenizerAdapter


def build_tokenizer(checkpoint: str):
    """The checkpoint's HF tokenizer behind the pipeline's tokenizer
    surface when the directory has a tokenizer_config.json, else the
    deterministic MockTokenizer (runs on random weights)."""
    if checkpoint and os.path.exists(os.path.join(checkpoint,
                                                  "tokenizer_config.json")):
        return HFTokenizerAdapter(get_tokenizer(checkpoint, use_fast=True))
    return MockTokenizer()


def rope_scaled(llm_cfg, checkpoint: str):
    """A MiniCPM LM config with the rope scaling of the checkpoint's
    config.json (none: unchanged). A scaled checkpoint loaded without it
    would give wrong outputs silently."""
    path = os.path.join(checkpoint, "config.json") if checkpoint else ""
    if not path or not os.path.exists(path):
        return llm_cfg
    with open(path) as f:
        rs = json.load(f).get("rope_scaling")
    if not rs:
        return llm_cfg
    kind = rs.get("type", rs.get("rope_type"))
    if kind not in ("linear", "dynamic"):
        raise ValueError(f"unsupported rope_scaling type {kind!r}")
    return dataclasses.replace(llm_cfg, rope_scaling_type=kind,
                               rope_scaling_factor=float(rs["factor"]))


def _trunc_normal_(t, std, gen):
    # flax truncated normal: ±2σ of the underlying normal, rescaled so the
    # truncated distribution keeps the requested std (lecun) or not (query)
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                 generator=gen)


@torch.no_grad()
def init_weights_(model: nn.Module, gen: torch.Generator) -> None:
    """Random init in place of VisRAGRet or any of its submodules, in
    module order (reproducible per seed)."""
    for module in model.modules():
        if isinstance(module, (LayerNorm, RMSNorm)):
            module.weight.fill_(1.0)
            if isinstance(module, LayerNorm):
                module.bias.zero_()
        elif isinstance(module, nn.Linear):
            std = module.weight.shape[0] ** -0.5 / 0.87962566103423978
            _trunc_normal_(module.weight, std, gen)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, module.weight.shape[1] ** -0.5,
                                  generator=gen)
        elif isinstance(module, SiglipViT):
            module.pos_embed.normal_(0.0, 0.02, generator=gen)
        elif isinstance(module, Resampler):
            c = module.cfg
            _trunc_normal_(module.query, 0.02, gen)
            if module.pos_embed is not None:
                grid = int(round(c.num_queries ** 0.5))
                module.pos_embed.copy_(torch.from_numpy(
                    get_2d_sincos_pos_embed(c.embed_dim, grid, grid)))
            nn.init.xavier_uniform_(module.attn.in_proj_weight, generator=gen)
            module.attn.in_proj_bias.zero_()
            module.proj.normal_(0.0, c.embed_dim ** -0.5, generator=gen)
        elif isinstance(module, SiglipMAPHead):
            module.probe.normal_(0.0, 0.02, generator=gen)
            nn.init.xavier_uniform_(module.attention.in_proj_weight,
                                    generator=gen)
            module.attention.in_proj_bias.zero_()


def build_visrag_ret(model_cfg: ModelConfig, *, tiny: bool = False,
                     device="cuda", seed: int = 0):
    """→ (model in eval mode on `device`, PipelineConfig). With
    model_cfg.checkpoint: the released MiniCPM-V 2.0 / VisRAG-Ret names
    from its safetensors (the LM head and the 27th ViT block dropped), rope
    scaling from its config.json; else random weights from `seed`."""
    ckpt = model_cfg.checkpoint
    cfg = VisRAGRetConfig.tiny() if tiny else VisRAGRetConfig(
        pooling=model_cfg.pooling, normalize=model_cfg.normalize)
    bb = cfg.backbone
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        bb, vit=dataclasses.replace(bb.vit, remat=model_cfg.remat),
        llm=dataclasses.replace(rope_scaled(bb.llm, ckpt),
                                remat=model_cfg.remat)))
    device = torch.device(device)
    with torch.device("meta"):
        model = VisRAGRet(cfg)
    model = model.to_empty(device=device)
    if ckpt:
        load_visrag_ret_state(model, minicpmv_hf_to_port(
            load_safetensors_dir(ckpt), cfg.backbone.vit.depth))
    else:
        init_weights_(model, torch.Generator(device=device)
                      .manual_seed(seed))
    model.eval()
    bb = cfg.backbone
    pcfg = PipelineConfig(
        seq_len=64 if tiny else model_cfg.max_inp_length,
        query_num=bb.query_num, patch_size=bb.vit.patch_size,
        src_grid=bb.vit.pos_grid,
        scale_resolution=8 if tiny else bb.scale_resolution,
        max_patches=64 if tiny else 1152)
    return model, pcfg


# --- Qwen2.5-VL (EVisRAG generation) ---------------------------------------


def get_tokenizer(model_path: str, **kwargs):
    """The checkpoint's HF tokenizer (transformers, imported here), with
    pad_token := eos_token when the checkpoint ships none."""
    from transformers import AutoTokenizer
    tok = AutoTokenizer.from_pretrained(model_path, **kwargs)
    if tok.pad_token_id is None:
        tok.pad_token = tok.eos_token
    return tok


def get_processor(model_path: str, **kwargs):
    """The checkpoint's HF multimodal processor, or None for a checkpoint
    without one (AutoProcessor then raises, or returns a bare tokenizer). A
    directory that has a preprocessor_config.json and still fails raises."""
    import os

    from transformers import AutoProcessor
    try:
        processor = AutoProcessor.from_pretrained(model_path, **kwargs)
    except (OSError, ValueError):
        if os.path.isdir(model_path) and os.path.exists(
                os.path.join(model_path, "preprocessor_config.json")):
            raise
        return None
    if "Processor" not in type(processor).__name__:
        return None
    return processor


def encode_qwen_prompt_row(row, processor, tok, mcfg, rollout_cfg):
    """RL prompt row → engine-ready dict (the reference RLHFDataset role,
    rsgrpo/verl/utils/dataset.py:159-296). Text-only rows tokenize the chat
    template; multimodal rows additionally load/resize images into the
    rollout pixel budget, expand per-image pad tokens, and attach the uint8
    device-mode vision batch + mrope positions + flat slot map."""
    import numpy as np
    prompt = row.get("problem") or row.get("prompt")
    images = row.get("images") or row.get("image") or []
    if not isinstance(images, (list, tuple)):
        images = [images]
    images = list(images)[:rollout_cfg.limit_images]
    content = [{"type": "image"}] * len(images) + [
        {"type": "text", "text": prompt}]
    text = processor.apply_chat_template(
        [{"role": "user", "content": content}],
        tokenize=False, add_generation_prompt=True)
    if not images:
        ids = np.asarray(tok.encode(text), np.int32)
        return dict(input_ids=ids, ground_truth=row.get("answer", ""))

    from PIL import Image as _Image

    from ..data.datasets import to_pil
    from ..models.mrope import get_rope_index
    from ..preprocess.qwen_vision import prepare_vision_batch
    pil = [(_Image.open(im).convert("RGB") if isinstance(im, str)
            else to_pil(im).convert("RGB")) for im in images]
    vb = prepare_vision_batch(
        pil, head_dim=mcfg.vision.head_dim,
        min_pixels=rollout_cfg.min_pixels,
        max_pixels=rollout_cfg.max_pixels, device_mode=True)
    mu = mcfg.vision.spatial_merge_size ** 2
    for (t, h, w) in vb.grid_thw:       # expand pads per image, in order
        text = text.replace("<|image_pad|>",
                            "<|graft_img|>" * (t * h * w // mu), 1)
    text = text.replace("<|graft_img|>", "<|image_pad|>")
    ids = np.asarray(tok.encode(text), np.int32)
    pos = get_rope_index(ids, vb.grid_thw, mcfg.image_token_id)
    slot = np.full(ids.shape, -1, np.int32)
    slot[ids == mcfg.image_token_id] = np.arange(vb.n_tokens)
    vision_batch = {k: getattr(vb, k) for k in
                    ("patches", "rot_cos", "rot_sin", "seg_window",
                     "seg_full", "reverse_index")}
    return dict(input_ids=ids, positions=pos, vision_batch=vision_batch,
                slot_map=slot, ground_truth=row.get("answer", ""))


def qwen_config_from_checkpoint(checkpoint: str, state=None):
    """Qwen25VLConfig of a checkpoint dir: from its config.json (any
    geometry), else the preset whose text width matches the embeddings."""
    import json
    import os

    from ..models.qwen25_vl import Qwen25VLConfig
    cfg_json = os.path.join(checkpoint, "config.json")
    if os.path.exists(cfg_json):
        with open(cfg_json) as f:
            return Qwen25VLConfig.from_hf(json.load(f))
    hid = state[[k for k in state if "embed_tokens" in k][0]].shape[1]
    return {3584: Qwen25VLConfig.b7}.get(hid, Qwen25VLConfig.b3)()


def build_qwen25_vl(cfg, *, device="cuda", seed: int = 0, state=None):
    """Qwen25VL in eval mode on `device`: HF-named weights from `state`, or
    (state None) random ones from `seed` by init_weights_."""
    from ..models.hf_loader import load_qwen25_vl_state
    from ..models.qwen25_vl import Qwen25VL
    device = torch.device(device)
    with torch.device("meta"):
        model = Qwen25VL(cfg)
    model = model.to_empty(device=device)
    if state is None:
        init_weights_(model, torch.Generator(device=device).manual_seed(seed))
    else:
        load_qwen25_vl_state(model, state)
    return model.eval()


def load_qwen25_vl_checkpoint(checkpoint: str, device="cuda"):
    """A Qwen2.5-VL checkpoint dir → (processor, tokenizer, model): the
    weights by their HF names on `device`, the config from config.json.
    A checkpoint without a processor: its tokenizer applies the chat
    template and stands in as the processor."""
    processor = get_processor(checkpoint)
    tok = processor.tokenizer if processor is not None \
        else get_tokenizer(checkpoint)
    state = load_safetensors_dir(checkpoint)
    cfg = qwen_config_from_checkpoint(checkpoint, state)
    model = build_qwen25_vl(cfg, device=device, state=state)
    return processor if processor is not None else tok, tok, model

"""The port's modules → HF-named state dicts and safetensors files (the
model-merger role).

Counterpart of visrag_tpu/models/hf_export.py. Each exporter writes a
port module under the released checkpoints' names, which are the names
the port's own loaders read back (models/hf_loader): `export_visrag_ret`
for `minicpmv_hf_to_port` + `load_visrag_ret_state`, `export_qwen25_vl`
for `load_qwen25_vl_state` (the modern `model.language_model.*` /
`model.visual.*` layout), `export_minicpmv26` and
`export_siglip_vision_hf` for `load_generation_hf_state` (through
`minicpmv26_hf_to_port`), so `load(export(m))` gives `m` back bit for bit.

Two faults of the JAX exporter are not copied (ROADMAP §3): the MiniCPM
LM goes out as the checkpoint's `llm.model.*` (the JAX one writes
`llm.layers.*` and `llm.embed_tokens.embedding`), and the conv patch
embeds take the model's own patch sizes (the JAX one reshapes to 14 x 14
and a temporal 2 whatever the config).
"""

from __future__ import annotations

import os
from typing import Dict

import torch


def _detached(state: dict) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in state.items()}


def export_visrag_ret(model) -> Dict[str, torch.Tensor]:
    """VisRAGRet → a MiniCPM-V 2.0 / VisRAG-Ret checkpoint's names: timm
    `vpm.*` (the patch embed as a (D, 3, ps, ps) conv weight, pos_embed
    (1, G², D)), `resampler.*`, and the LM as `llm.model.*`."""
    ps = model.cfg.backbone.vit.patch_size
    state = {}
    for key, v in _detached(model.backbone.state_dict()).items():
        if key == "vpm.patch_embed.proj.weight":
            v = v.reshape(v.shape[0], 3, ps, ps)
        elif key == "vpm.pos_embed":
            v = v[None]
        elif key.startswith("llm."):
            key = "llm.model." + key[len("llm."):]
        state[key] = v
    return state


def export_qwen25_vl(model) -> Dict[str, torch.Tensor]:
    """Qwen25VL → HF Qwen2.5-VL names in the modern layout
    (`model.visual.*`, `model.language_model.*`, `lm_head.weight` when
    untied), the patch embed as a (D, 3, t, ps, ps) conv weight from the
    config."""
    vc = model.cfg.vision
    state = {}
    for key, v in _detached(model.state_dict()).items():
        if key == "visual.patch_embed.weight":
            key = "model.visual.patch_embed.proj.weight"
            v = v.reshape(v.shape[0], 3, vc.temporal_patch_size,
                          vc.patch_size, vc.patch_size)
        elif key.startswith("visual."):
            key = "model." + key
        elif key.startswith("model."):
            key = "model.language_model." + key[len("model."):]
        state[key] = v
    return state


_SIGLIP_VISION_RENAME = {"norm1": "layer_norm1", "norm2": "layer_norm2",
                         "attn.proj": "self_attn.out_proj",
                         "mlp.fc1": "mlp.fc1", "mlp.fc2": "mlp.fc2"}


def export_siglip_vision_hf(vit, prefix: str = "vpm.") -> Dict[str,
                                                               torch.Tensor]:
    """SiglipViT → HF SiglipVisionModel names under `prefix`: the fused
    qkv split back into q / k / v in row order, the patch embed as a
    (D, 3, ps, ps) conv weight."""
    ps = vit.cfg.patch_size
    state = {}
    for key, v in _detached(vit.state_dict()).items():
        if key == "patch_embed.proj.weight":
            state[prefix + "embeddings.patch_embedding.weight"] = v.reshape(
                v.shape[0], 3, ps, ps)
        elif key == "patch_embed.proj.bias":
            state[prefix + "embeddings.patch_embedding.bias"] = v
        elif key == "pos_embed":
            state[prefix + "embeddings.position_embedding.weight"] = v
        elif key.startswith("norm."):
            state[prefix + "post_layernorm." + key[len("norm."):]] = v
        else:
            _, i, rest = key.split(".", 2)
            mod, _, leaf = rest.rpartition(".")
            base = f"{prefix}encoder.layers.{i}."
            if mod == "attn.qkv":
                for name, part in zip("qkv", v.chunk(3)):
                    state[base + f"self_attn.{name}_proj.{leaf}"] = part
            else:
                state[base + f"{_SIGLIP_VISION_RENAME[mod]}.{leaf}"] = v
    return state


def export_minicpmv26(model) -> Dict[str, torch.Tensor]:
    """MiniCPMV26ForGeneration → a MiniCPM-V 2.6 checkpoint's names:
    `llm.model.*` and `llm.lm_head.weight` (Qwen2ForCausalLM), `vpm.*` (HF
    SiglipVisionModel), `resampler.*`."""
    state = export_siglip_vision_hf(model.vpm, prefix="vpm.")
    for key, v in _detached(model.state_dict()).items():
        if key.startswith(("model.", "lm_head.")):
            state["llm." + key] = v
        elif key.startswith("resampler."):
            state[key] = v
    return state


def save_safetensors(state: Dict[str, torch.Tensor], out_dir: str,
                     dtype=None) -> str:
    """Write a state dict as `out_dir/model.safetensors` (cast to `dtype`
    when given) → the file's path."""
    from safetensors.torch import save_file
    os.makedirs(out_dir, exist_ok=True)
    state = {k: (v if dtype is None else v.to(dtype)).contiguous().cpu()
             for k, v in state.items()}
    path = os.path.join(out_dir, "model.safetensors")
    save_file(state, path)
    return path

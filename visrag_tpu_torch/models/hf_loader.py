"""Load MiniCPM-V / VisRAG-Ret and Qwen2.5-VL weights by their HF names into
the port.

The port's module tree carries the HF names (`vpm.*` timm ViT,
`resampler.*`, `llm.*` with the decoder stack directly under `llm`, as in
the JAX package), so loading is a copy by name in which the conv patch
embed (D, 3, ps, ps) is flattened to the (D, 3*ps*ps) matmul weight and a
(1, G², D) pos embed is squeezed to (G², D).

Any name that does not match, and any parameter left unloaded, raises.
Released checkpoints name the LM `llm.model.*` and carry an LM head and a
27th ViT block; their names are handled when checkpoint loading is ported.

`from_jax_params` takes a visrag_tpu VisRAGRet parameter tree as nested
dicts of numpy arrays and renames it itself, with this module's own copy of
the JAX package's HF export mapping (the port imports nothing of
visrag_tpu). Unlike that exporter, it reshapes the patch embed by the
model's own patch size, so a tiny ViT with patch 2 loads too.

Qwen2.5-VL: `load_qwen25_vl_state` takes an HF state dict in either key
layout the JAX package's convert_qwen25_vl takes; `qwen_from_jax_params`
renames a JAX Qwen25VL parameter tree with this module's copy of the JAX
package's export_qwen25_vl mapping.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

_RESHAPED = ("vpm.patch_embed.proj.weight", "vpm.pos_embed")

_VIT_RENAME = {
    "attn_qkv.weight": "attn.qkv.weight", "attn_qkv.bias": "attn.qkv.bias",
    "attn_proj.weight": "attn.proj.weight", "attn_proj.bias": "attn.proj.bias",
    "mlp_fc1.weight": "mlp.fc1.weight", "mlp_fc1.bias": "mlp.fc1.bias",
    "mlp_fc2.weight": "mlp.fc2.weight", "mlp_fc2.bias": "mlp.fc2.bias",
}
_RESAMPLER_RENAME = {
    "in_proj_weight": "attn.in_proj_weight",
    "in_proj_bias": "attn.in_proj_bias",
    "out_proj.weight": "attn.out_proj.weight",
    "out_proj.bias": "attn.out_proj.bias",
}


def load_visrag_ret_state(model, state: Mapping[str, np.ndarray]) -> None:
    """Copy an HF-named state dict (numpy arrays or tensors) into a
    VisRAGRet's backbone, casting to each parameter's dtype and device."""
    backbone = model.backbone
    target = backbone.state_dict()
    converted, unexpected = {}, []
    for key, value in state.items():
        if key not in target:
            unexpected.append(key)
            continue
        t = value if torch.is_tensor(value) else torch.tensor(np.asarray(value))
        if key in _RESHAPED:
            t = t.reshape(target[key].shape)
        converted[key] = t
    missing = sorted(set(target) - set(converted))
    if unexpected or missing:
        raise KeyError(f"state does not match VisRAGRet: unexpected "
                       f"{unexpected[:10]} ({len(unexpected)}), missing "
                       f"{missing[:10]} ({len(missing)})")
    backbone.load_state_dict(converted, strict=True)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def jax_params_to_state(params: Mapping,
                        patch_size: int) -> Dict[str, np.ndarray]:
    """visrag_tpu VisRAGRet flax params (nested dicts of numpy arrays, with
    the "backbone" root) → the port's HF-named state dict."""
    bb = params["backbone"]
    state = {}
    for key, v in _flatten(bb["vpm"]).items():
        if key == "patch_embed_weight":
            state["vpm.patch_embed.proj.weight"] = v.reshape(
                v.shape[0], 3, patch_size, patch_size)
        elif key == "patch_embed_bias":
            state["vpm.patch_embed.proj.bias"] = v
        elif key == "pos_embed":
            state["vpm.pos_embed"] = v[None]
        elif key.startswith("blocks_"):
            block, rest = key.split(".", 1)
            i = block[len("blocks_"):]
            state[f"vpm.blocks.{i}.{_VIT_RENAME.get(rest, rest)}"] = v
        else:
            state[f"vpm.{key}"] = v
    for key, v in _flatten(bb["resampler"]).items():
        state[f"resampler.{_RESAMPLER_RENAME.get(key, key)}"] = v
    for key, v in _flatten(bb["llm"]).items():
        key = key.replace("layers_", "layers.")
        if key == "embed_tokens.embedding":
            key = "embed_tokens.weight"
        state[f"llm.{key}"] = v
    return state


def from_jax_params(model, params: Mapping) -> None:
    """Load visrag_tpu VisRAGRet flax params (the dict `model.init`
    returns, with or without its "params" root) as nested dicts of numpy
    arrays, e.g. `jax.tree.map(np.asarray, params)`."""
    if "params" in params:
        params = params["params"]
    load_visrag_ret_state(model, jax_params_to_state(
        params, model.cfg.backbone.vit.patch_size))


# --- Qwen2.5-VL ------------------------------------------------------------

_QWEN_VISION_RENAME = {
    "attn_qkv": "attn.qkv", "attn_proj": "attn.proj",
    "mlp_gate": "mlp.gate_proj", "mlp_up": "mlp.up_proj",
    "mlp_down": "mlp.down_proj",
}
_QWEN_TEXT_RENAME = {
    "attn_q": "self_attn.q_proj", "attn_k": "self_attn.k_proj",
    "attn_v": "self_attn.v_proj", "attn_o": "self_attn.o_proj",
    "mlp_gate": "mlp.gate_proj", "mlp_up": "mlp.up_proj",
    "mlp_down": "mlp.down_proj",
}


def _qwen_port_name(key: str) -> str:
    """An HF Qwen2.5-VL name, in either layout (`model.language_model.*` /
    `model.visual.*` from transformers 4.52 on, `model.*` / `visual.*`
    before), → the port's module name."""
    key = key.replace("model.language_model.", "model.", 1)
    if key.startswith("model.visual."):
        key = key[len("model."):]
    return key.replace("visual.patch_embed.proj.", "visual.patch_embed.")


def load_qwen25_vl_state(model, state: Mapping[str, np.ndarray]) -> None:
    """Copy an HF-named Qwen2.5-VL state dict (numpy arrays or tensors)
    into the port's Qwen25VL, casting to each parameter's dtype and device.
    The conv patch embed (D, 3, t, ps, ps) becomes the (D, patch_dim)
    matmul weight; a tied checkpoint's lm_head copy is skipped. An unknown
    or a missing name raises."""
    target = model.state_dict()
    converted, unexpected = {}, []
    for key, value in state.items():
        name = _qwen_port_name(key)
        if name == "lm_head.weight" and name not in target \
                and model.cfg.text.tie_word_embeddings:
            continue
        if name not in target:
            unexpected.append(key)
            continue
        t = value if torch.is_tensor(value) else torch.tensor(np.asarray(value))
        if name == "visual.patch_embed.weight":
            t = t.reshape(target[name].shape)
        converted[name] = t
    missing = sorted(set(target) - set(converted))
    if unexpected or missing:
        raise KeyError(f"state does not match Qwen25VL: unexpected "
                       f"{unexpected[:10]} ({len(unexpected)}), missing "
                       f"{missing[:10]} ({len(missing)})")
    model.load_state_dict(converted, strict=True)


def qwen_jax_params_to_state(params: Mapping, vision_cfg) -> Dict[str,
                                                                  np.ndarray]:
    """visrag_tpu Qwen25VL flax params (nested dicts of numpy arrays) → HF
    names (the modern layout), as the JAX package's export_qwen25_vl maps
    them. The patch embed is reshaped by the config's temporal and spatial
    patch sizes."""
    state = {}
    for key, v in _flatten(params.get("visual", {})).items():
        if key == "patch_embed.weight":
            ps, tps = vision_cfg.patch_size, vision_cfg.temporal_patch_size
            state["model.visual.patch_embed.proj.weight"] = v.reshape(
                v.shape[0], 3, tps, ps, ps)
        elif key.startswith("blocks_"):
            block, rest = key.split(".", 1)
            mod, _, leaf = rest.rpartition(".")
            state[f"model.visual.blocks.{block[len('blocks_'):]}."
                  f"{_QWEN_VISION_RENAME.get(mod, mod)}.{leaf}"] = v
        elif key == "merger_ln_q.weight":
            state["model.visual.merger.ln_q.weight"] = v
        elif key.startswith("merger_fc1."):
            state["model.visual.merger.mlp.0." + key.split(".")[-1]] = v
        elif key.startswith("merger_fc2."):
            state["model.visual.merger.mlp.2." + key.split(".")[-1]] = v
        else:
            raise KeyError(f"unknown vision parameter {key}")
    for key, v in _flatten(params.get("model", {})).items():
        if key == "embed_tokens.embedding":
            state["model.language_model.embed_tokens.weight"] = v
        elif key.startswith("layers_"):
            layer, rest = key.split(".", 1)
            mod, _, leaf = rest.rpartition(".")
            state[f"model.language_model.layers.{layer[len('layers_'):]}."
                  f"{_QWEN_TEXT_RENAME.get(mod, mod)}.{leaf}"] = v
        else:
            state["model.language_model." + key] = v
    if "lm_head" in params:
        state["lm_head.weight"] = np.asarray(params["lm_head"]["weight"])
    return state


def qwen_from_jax_params(model, params: Mapping) -> None:
    """Load visrag_tpu Qwen25VL flax params (with or without the "params"
    root) given as nested dicts of numpy arrays into the port's Qwen25VL."""
    if "params" in params:
        params = params["params"]
    load_qwen25_vl_state(model, qwen_jax_params_to_state(params,
                                                         model.cfg.vision))


def qwen_value_from_jax_params(model, params: Mapping) -> None:
    """Load visrag_tpu QwenForValue flax params (text stack "model" and the
    "score" head, with or without the "params" root) given as nested dicts
    of numpy arrays into the port's QwenForValue."""
    if "params" in params:
        params = params["params"]
    state = qwen_jax_params_to_state({"model": params["model"]}, None)
    converted = {_qwen_port_name(k): torch.tensor(np.asarray(v))
                 for k, v in state.items()}
    converted["score.weight"] = torch.tensor(
        np.asarray(params["score"]["weight"]))
    model.load_state_dict(converted, strict=True)

"""Load MiniCPM-V / VisRAG-Ret and Qwen2.5-VL weights by their HF names into
the port.

The port's module tree carries the HF names (`vpm.*` timm ViT,
`resampler.*`, `llm.*` with the decoder stack directly under `llm`, as in
the JAX package), so loading is a copy by name in which the conv patch
embed (D, 3, ps, ps) is flattened to the (D, 3*ps*ps) matmul weight and a
(1, G², D) pos embed is squeezed to (G², D).

`load_visrag_ret_state` takes the port's own names: any name that does not
match, and any parameter left unloaded, raises. Released checkpoints name
the LM `llm.model.*` and carry an LM head and a 27th ViT block;
`minicpmv_hf_to_port` renames them as the JAX package's convert_minicpmv
does (the 27th block and the head dropped for VisRAG-Ret).

`from_jax_params` takes a visrag_tpu VisRAGRet parameter tree as nested
dicts of numpy arrays and renames it itself, with this module's own copy of
the JAX package's HF export mapping (the port imports nothing of
visrag_tpu). Unlike that exporter, it reshapes the patch embed by the
model's own patch size, so a tiny ViT with patch 2 loads too.

Qwen2.5-VL: `load_qwen25_vl_state` takes an HF state dict in either key
layout the JAX package's convert_qwen25_vl takes; `qwen_from_jax_params`
renames a JAX Qwen25VL parameter tree with this module's copy of the JAX
package's export_qwen25_vl mapping.

Generation (VisRAG-Gen): `load_generation_hf_state` loads a released
checkpoint's names into MiniCPMForGeneration (the MiniCPM-2B causal LM's
own names), MiniCPMVForGeneration (the MiniCPM-V 2.0 names above, with
`llm.lm_head`) or MiniCPMV26ForGeneration (`llm.*` a Qwen2ForCausalLM,
`vpm.*` an HF SiglipVisionModel whose separate q/k/v become the fused
qkv, `resampler.*`): the names the JAX package's convert_minicpm_lm,
convert_minicpmv and convert_minicpmv26 map are taken, any other name is
skipped as there, and a parameter left unloaded raises.
`generation_from_jax_params` carries the JAX package's param trees of the
same three models.

SigLIP (the bi-tower baseline, models/siglip.py): the port's module
carries HF SiglipModel's names, so `load_siglip_hf_state` is a strict copy
by name (the conv patch embed flattened; the position_ids buffers of older
checkpoints skipped; any other unknown or missing name raises), the
counterpart of the JAX package's convert_siglip. `siglip_from_jax_params`
carries a JAX SiglipModel parameter tree.
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


def _tensor(value):
    return value if torch.is_tensor(value) \
        else torch.tensor(np.asarray(value))


def load_strict(module, state: Mapping, what: str,
                reshaped=()) -> None:
    """Copy a state dict under the module's own names into it, casting to
    each parameter's dtype and device; names in `reshaped` take the
    target's shape. An unknown or a missing name raises."""
    target = module.state_dict()
    converted, unexpected = {}, []
    for key, value in state.items():
        if key not in target:
            unexpected.append(key)
            continue
        t = _tensor(value)
        if key in reshaped:
            t = t.reshape(target[key].shape)
        converted[key] = t
    missing = sorted(set(target) - set(converted))
    if unexpected or missing:
        raise KeyError(f"state does not match {what}: unexpected "
                       f"{unexpected[:10]} ({len(unexpected)}), missing "
                       f"{missing[:10]} ({len(missing)})")
    module.load_state_dict(converted, strict=True)


def load_visrag_ret_state(model, state: Mapping[str, np.ndarray]) -> None:
    """Copy an HF-named state dict (numpy arrays or tensors) into a
    VisRAGRet's backbone, casting to each parameter's dtype and device."""
    load_strict(model.backbone, state, "VisRAGRet", _RESHAPED)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _vpm_state(tree: Mapping, patch_size: int) -> Dict[str, np.ndarray]:
    """A JAX SiglipViT param tree → `vpm.*` names."""
    state = {}
    for key, v in _flatten(tree).items():
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
    return state


def _resampler_state(tree: Mapping) -> Dict[str, np.ndarray]:
    """A JAX Resampler param tree → `resampler.*` names."""
    return {f"resampler.{_RESAMPLER_RENAME.get(key, key)}": v
            for key, v in _flatten(tree).items()}


def _minicpm_lm_state(tree: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    """A JAX MiniCPMModel param tree → `prefix` + the port's names."""
    state = {}
    for key, v in _flatten(tree).items():
        key = key.replace("layers_", "layers.")
        if key == "embed_tokens.embedding":
            key = "embed_tokens.weight"
        state[prefix + key] = v
    return state


def jax_params_to_state(params: Mapping,
                        patch_size: int) -> Dict[str, np.ndarray]:
    """visrag_tpu VisRAGRet flax params (nested dicts of numpy arrays, with
    the "backbone" root) → the port's HF-named state dict."""
    bb = params["backbone"]
    return {**_vpm_state(bb["vpm"], patch_size),
            **_resampler_state(bb["resampler"]),
            **_minicpm_lm_state(bb["llm"], "llm.")}


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


# --- generation (VisRAG-Gen) and released checkpoints ----------------------


def load_safetensors_dir(path: str) -> Dict[str, np.ndarray]:
    """Every *.safetensors file of an HF checkpoint dir → one flat dict of
    numpy arrays."""
    import glob
    import os

    from safetensors import safe_open
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors under {path}")
    state = {}
    for f in files:
        with safe_open(f, framework="np") as sf:
            for k in sf.keys():
                state[k] = sf.get_tensor(k)
    return state


_TIMM_VIT_NAMES = {"norm1.weight", "norm1.bias", "norm2.weight",
                   "norm2.bias", "attn.qkv.weight", "attn.qkv.bias",
                   "attn.proj.weight", "attn.proj.bias", "mlp.fc1.weight",
                   "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias"}
_RESAMPLER_NAMES = {"query", "pos_embed", "kv_proj.weight",
                    "attn.in_proj_weight", "attn.in_proj_bias",
                    "attn.out_proj.weight", "attn.out_proj.bias",
                    "ln_q.weight", "ln_q.bias", "ln_kv.weight", "ln_kv.bias",
                    "ln_post.weight", "ln_post.bias", "proj"}


def _lm_name(name: str):
    """An HF causal LM's name (MiniCPM-2B or Qwen2) → the port's, or None
    where the JAX converters drop it (rotary buffers)."""
    if name.startswith("model.layers.") and "rotary_emb" not in name:
        return name
    if name in ("model.embed_tokens.weight", "model.norm.weight",
                "lm_head.weight"):
        return name
    return None


def minicpmv_hf_to_port(state: Mapping, vit_depth: int = 26,
                        lm_head: bool = False) -> Dict[str, object]:
    """A released MiniCPM-V 2.0 / VisRAG-Ret state dict (timm `vpm.*`,
    `resampler.*`, `llm.model.*`, `llm.lm_head.weight`) → the port's
    backbone names (`vpm.*`, `resampler.*`, `llm.*`), and `lm_head.weight`
    when asked. Names the JAX package's convert_minicpmv drops are
    dropped: ViT blocks past `vit_depth`, rotary buffers, anything else."""
    out = {}
    for name, v in state.items():
        if name.startswith("vpm."):
            rest = name[len("vpm."):]
            if rest.startswith("blocks."):
                i, sub = rest[len("blocks."):].split(".", 1)
                if int(i) < vit_depth and sub in _TIMM_VIT_NAMES:
                    out[name] = v
            elif rest in ("patch_embed.proj.weight", "patch_embed.proj.bias",
                          "pos_embed", "norm.weight", "norm.bias"):
                out[name] = v
        elif name.startswith("resampler."):
            if name[len("resampler."):] in _RESAMPLER_NAMES:
                out[name] = v
        elif name.startswith("llm."):
            lm = _lm_name(name[len("llm."):])
            if lm == "lm_head.weight":
                if lm_head:
                    out["lm_head.weight"] = v
            elif lm is not None:
                out["llm." + lm[len("model."):]] = v
    return out


def siglip_hf_to_port(state: Mapping, prefix: str = "vpm.") -> Dict:
    """An HF SiglipVisionModel state dict under `prefix` (MiniCPM-V 2.6's
    `vpm.*`, with or without `vision_model.`) → the port's SiglipViT names
    under the same prefix, q/k/v concatenated into the fused qkv in
    (q, k, v) row order (the JAX package's convert_siglip_vision_hf)."""
    out, qkv = {}, {}
    rename = {"layer_norm1": "norm1", "layer_norm2": "norm2",
              "self_attn.out_proj": "attn.proj", "mlp.fc1": "mlp.fc1",
              "mlp.fc2": "mlp.fc2"}
    for name, v in state.items():
        if not name.startswith(prefix):
            continue
        rest = name[len(prefix):]
        if rest.startswith("vision_model."):
            rest = rest[len("vision_model."):]
        if rest == "embeddings.patch_embedding.weight":
            out[prefix + "patch_embed.proj.weight"] = v
        elif rest == "embeddings.patch_embedding.bias":
            out[prefix + "patch_embed.proj.bias"] = v
        elif rest == "embeddings.position_embedding.weight":
            out[prefix + "pos_embed"] = v
        elif rest.startswith("post_layernorm."):
            out[prefix + "norm." + rest.split(".")[-1]] = v
        elif rest.startswith("encoder.layers."):
            i, sub = rest[len("encoder.layers."):].split(".", 1)
            mod, _, leaf = sub.rpartition(".")
            if mod in rename:
                out[f"{prefix}blocks.{i}.{rename[mod]}.{leaf}"] = v
            elif mod in ("self_attn.q_proj", "self_attn.k_proj",
                         "self_attn.v_proj"):
                qkv.setdefault((i, leaf), {})[mod[10]] = _tensor(v)
    for (i, leaf), parts in qkv.items():
        out[f"{prefix}blocks.{i}.attn.qkv.{leaf}"] = torch.cat(
            [parts["q"], parts["k"], parts["v"]])
    return out


def minicpmv26_hf_to_port(state: Mapping) -> Dict[str, object]:
    """A released MiniCPM-V 2.6 state dict → MiniCPMV26ForGeneration's
    names: `llm.*` (Qwen2ForCausalLM) → `model.*` and `lm_head.weight`,
    `vpm.*` through siglip_hf_to_port, `resampler.*` as they are."""
    out = siglip_hf_to_port(state, "vpm.")
    for name, v in state.items():
        if name.startswith("resampler.") \
                and name[len("resampler."):] in _RESAMPLER_NAMES:
            out[name] = v
        elif name.startswith("llm."):
            lm = _lm_name(name[len("llm."):])
            if lm is not None:
                out[lm] = v
    return out


_GEN_RESHAPED = ("vpm.patch_embed.proj.weight", "vpm.pos_embed",
                 "backbone.vpm.patch_embed.proj.weight",
                 "backbone.vpm.pos_embed")


def load_generation_hf_state(model, state: Mapping) -> None:
    """A released checkpoint's state dict (numpy arrays or tensors) into
    MiniCPMForGeneration, MiniCPMVForGeneration (the ViT's depth from the
    model's config) or MiniCPMV26ForGeneration."""
    from .minicpm import MiniCPMForGeneration
    from .minicpmv import MiniCPMVForGeneration
    from .minicpmv26 import MiniCPMV26ForGeneration
    if isinstance(model, MiniCPMForGeneration):
        conv = {n: v for k, v in state.items()
                if (n := _lm_name(k)) is not None}
    elif isinstance(model, MiniCPMVForGeneration):
        conv = {("backbone." + k if k != "lm_head.weight" else k): v
                for k, v in minicpmv_hf_to_port(
                    state, model.cfg.backbone.vit.depth, True).items()}
    elif isinstance(model, MiniCPMV26ForGeneration):
        conv = minicpmv26_hf_to_port(state)
    else:
        raise TypeError(f"not a generation model: {type(model).__name__}")
    load_strict(model, conv, type(model).__name__, _GEN_RESHAPED)


def generation_jax_params_to_state(params: Mapping, model) -> Dict:
    """visrag_tpu MiniCPMForGeneration / MiniCPMVForGeneration /
    MiniCPMV26ForGeneration flax params (nested dicts of numpy arrays,
    without the "params" root) → the names of `model`, their port twin
    (its ViT's patch size reshapes the patch embed)."""
    from .minicpm import MiniCPMForGeneration
    from .minicpmv import MiniCPMVForGeneration
    from .minicpmv26 import MiniCPMV26ForGeneration
    head = {"lm_head.weight": np.asarray(params["lm_head"]["weight"])}
    if isinstance(model, MiniCPMForGeneration):
        return {**_minicpm_lm_state(params["model"], "model."), **head}
    if isinstance(model, MiniCPMVForGeneration):
        return {**{"backbone." + k: v for k, v in jax_params_to_state(
            params, model.cfg.backbone.vit.patch_size).items()}, **head}
    if not isinstance(model, MiniCPMV26ForGeneration):
        raise TypeError(f"not a generation model: {type(model).__name__}")
    text = {_qwen_port_name(key): v for key, v in qwen_jax_params_to_state(
        {"model": params["model"]}, None).items()}
    return {**_vpm_state(params["vpm"], model.cfg.vit.patch_size),
            **_resampler_state(params["resampler"]), **text, **head}


def generation_from_jax_params(model, params: Mapping) -> None:
    """Load a visrag_tpu generation model's flax params (with or without
    the "params" root), as nested dicts of numpy arrays, into its port
    twin."""
    if "params" in params:
        params = params["params"]
    load_strict(model, generation_jax_params_to_state(params, model),
                type(model).__name__, _GEN_RESHAPED)


# --- SigLIP bi-tower ----------------------------------------------------------

_SIGLIP_RESHAPED = ("vision_model.embeddings.patch_embedding.weight",
                    "logit_scale", "logit_bias")
_SIGLIP_LAYER = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
                 "v_proj": "self_attn.v_proj",
                 "out_proj": "self_attn.out_proj", "fc1": "mlp.fc1",
                 "fc2": "mlp.fc2", "layer_norm1": "layer_norm1",
                 "layer_norm2": "layer_norm2"}
_SIGLIP_VISION = {
    "patch_embedding": "embeddings.patch_embedding.weight",
    "patch_bias": "embeddings.patch_embedding.bias",
    "position_embedding": "embeddings.position_embedding.weight",
    "probe": "head.probe",
    "in_proj_weight": "head.attention.in_proj_weight",
    "in_proj_bias": "head.attention.in_proj_bias",
    "attn_out_proj": "head.attention.out_proj", "map_layernorm":
    "head.layernorm", "map_fc1": "head.mlp.fc1", "map_fc2": "head.mlp.fc2"}
_SIGLIP_TEXT = {"token_embedding.embedding":
                "embeddings.token_embedding.weight",
                "position_embedding": "embeddings.position_embedding.weight"}


def load_siglip_hf_state(model, state: Mapping) -> None:
    """An HF SiglipModel state dict (numpy arrays or tensors) into the
    port's SiglipModel, cast to each parameter's dtype and device."""
    state = {k: v for k, v in state.items()
             if not k.endswith("embeddings.position_ids")}
    load_strict(model, state, "SiglipModel", _SIGLIP_RESHAPED)


def _siglip_tower_state(tree: Mapping, tower: str,
                        names: Mapping) -> Dict[str, np.ndarray]:
    state = {}
    for key, v in _flatten(tree).items():
        if key.startswith("layers_"):
            layer, rest = key.split(".", 1)
            mod, _, leaf = rest.rpartition(".")
            key = (f"encoder.layers.{layer[len('layers_'):]}."
                   f"{_SIGLIP_LAYER[mod]}.{leaf}")
        elif key in names:
            key = names[key]
        else:
            mod, _, leaf = key.rpartition(".")
            key = f"{names.get(mod, mod)}.{leaf}"
        state[f"{tower}.{key}"] = v
    return state


def siglip_from_jax_params(model, params: Mapping) -> None:
    """Load visrag_tpu SiglipModel flax params (with or without the
    "params" root), as nested dicts of numpy arrays, into the port's
    SiglipModel."""
    if "params" in params:
        params = params["params"]
    state = {**_siglip_tower_state(params["text_model"], "text_model",
                                   _SIGLIP_TEXT),
             **_siglip_tower_state(params["vision_model"], "vision_model",
                                   _SIGLIP_VISION),
             "logit_scale": np.asarray(params["logit_scale"]),
             "logit_bias": np.asarray(params["logit_bias"])}
    load_strict(model, state, "SiglipModel", _SIGLIP_RESHAPED)

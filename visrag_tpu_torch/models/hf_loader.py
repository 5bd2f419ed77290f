"""Load MiniCPM-V / VisRAG-Ret weights by their HF names into the port.

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

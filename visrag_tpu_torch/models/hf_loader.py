"""Load MiniCPM-V / VisRAG-Ret weights by their HF names into the port.

The port's module tree carries the HF names (`vpm.*` timm ViT,
`resampler.*`, `llm.*` with the decoder stack directly under `llm`, as in
the JAX package), so loading is a copy by name in which the conv patch
embed (D, 3, ps, ps) is flattened to the (D, 3*ps*ps) matmul weight and a
(1, G², D) pos embed is squeezed to (G², D).

Any name that does not match, and any parameter left unloaded, raises.
Released checkpoints name the LM `llm.model.*` and carry an LM head and a
27th ViT block; their names are handled when checkpoint loading is ported.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_RESHAPED = ("vpm.patch_embed.proj.weight", "vpm.pos_embed")


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


def from_jax_params(model, params) -> None:
    """Load visrag_tpu VisRAGRet flax params (the dict `model.init` returns,
    with or without its "params" root) through visrag_tpu's HF exporter,
    which names the token embedding by its flax leaf `embedding`."""
    from visrag_tpu.models.hf_export import export_visrag_ret
    if "params" in params:
        params = params["params"]
    state = export_visrag_ret(params)
    state["llm.embed_tokens.weight"] = state.pop("llm.embed_tokens.embedding")
    load_visrag_ret_state(model, state)

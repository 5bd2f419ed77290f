"""LoRA adapters for the retriever, in the weight-merge formulation.

Counterpart of visrag_tpu/training/lora.py (the reference's optional peft
LoRA: target_modules q_proj and v_proj, r=32, alpha=64). Every
nn.Linear whose module path has a component containing a target name
becomes a LoRALinear — the LM's q_proj and v_proj, and, by the same
substring match as the JAX side's (and peft's suffix match), the
resampler's kv_proj: the frozen base weight W plus trainable A (r, in) ~
N(0, 0.02) and B (out, r) = 0 in fp32, and the forward uses
W + (alpha/r)·B@A cast to W's dtype, as the JAX side's lora_merge does
inside its step. Only the adapters get gradients; lora_merge folds them
into plain nn.Linear weights for the final save, and lora_merged_state
computes the merged weights from a state dict (under FSDP2 the gathered
full tensors) without touching the model.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

DEFAULT_TARGETS = ("q_proj", "v_proj")


def _merge(weight, a, b, scale):
    return weight + ((b @ a) * scale).to(weight.dtype)


class LoRALinear(nn.Linear):
    """nn.Linear with a frozen weight and a rank-r adapter; its state dict
    holds `weight` (and `bias`) as the base Linear's, plus lora_a/lora_b."""

    def __init__(self, base: nn.Linear, rank: int, alpha: float,
                 generator: torch.Generator = None):
        super().__init__(base.in_features, base.out_features,
                         bias=base.bias is not None, device="meta")
        self.weight = nn.Parameter(base.weight.detach(), requires_grad=False)
        if base.bias is not None:
            self.bias = nn.Parameter(base.bias.detach(), requires_grad=False)
        dev = base.weight.device
        a = torch.randn(rank, base.in_features, generator=generator,
                        device=dev) * 0.02
        self.lora_a = nn.Parameter(a)
        self.lora_b = nn.Parameter(torch.zeros(base.out_features, rank,
                                               device=dev))
        self.scale = alpha / rank

    def merged_weight(self):
        return _merge(self.weight, self.lora_a, self.lora_b, self.scale)

    def forward(self, x):
        return F.linear(x, self.merged_weight(), self.bias)


def lora_init(model: nn.Module, *, targets: Sequence[str] = DEFAULT_TARGETS,
              rank: int = 32, alpha: float = 64.0,
              generator: torch.Generator = None) -> List[nn.Parameter]:
    """Freeze `model` and put adapters on every targeted nn.Linear, in
    module order → the adapter parameters (the only ones to train)."""
    for p in model.parameters():
        p.requires_grad_(False)
    adapters = []
    for name, module in list(model.named_modules()):
        if not isinstance(module, nn.Linear) or isinstance(module,
                                                           LoRALinear):
            continue
        if not any(t in part for t in targets for part in name.split(".")):
            continue
        parent_name, _, child = name.rpartition(".")
        lora = LoRALinear(module, rank, alpha, generator)
        setattr(model.get_submodule(parent_name), child, lora)
        adapters += [lora.lora_a, lora.lora_b]
    if not adapters:
        raise ValueError(f"no linear layers matched LoRA targets {targets}")
    return adapters


@torch.no_grad()
def lora_merge(model: nn.Module) -> nn.Module:
    """Replace every LoRALinear by a plain nn.Linear holding
    W + (alpha/r)·B@A, in place → the model."""
    for name, module in list(model.named_modules()):
        if isinstance(module, LoRALinear):
            merged = nn.Linear(module.in_features, module.out_features,
                               bias=module.bias is not None, device="meta")
            merged.weight = nn.Parameter(module.merged_weight())
            if module.bias is not None:
                merged.bias = nn.Parameter(module.bias.detach().clone())
            parent_name, _, child = name.rpartition(".")
            setattr(model.get_submodule(parent_name), child, merged)
    return model


@torch.no_grad()
def lora_merged_state(model: nn.Module, state=None) -> dict:
    """The state dict that lora_merge(model) would have, computed from
    `state` (default: model.state_dict()): each adapted weight replaced
    by W + (alpha/r)·B@A and the adapters dropped, the model left as it
    is. Under FSDP2, `state` is the gathered full tensors
    (training/checkpoint.full_tensors), and one rank merges."""
    state = dict(model.state_dict() if state is None else state)
    for name, module in model.named_modules():
        if isinstance(module, LoRALinear):
            a, b = state.pop(f"{name}.lora_a"), state.pop(f"{name}.lora_b")
            state[f"{name}.weight"] = _merge(state[f"{name}.weight"], a, b,
                                             module.scale)
    return state

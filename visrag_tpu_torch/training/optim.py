"""Reduced-precision AdamW: optimizer states in bf16 and Kahan-compensated
parameter updates.

Counterpart of visrag_tpu/training/optim.py (the reference's
AnyPrecisionAdamW), as a torch.optim.Optimizer:

  * `mu`/`nu` are stored in `momentum_dtype`/`variance_dtype` (bf16 halves
    the 8 bytes/param of fp32 Adam states to 4), but the EMA and the
    denominator are computed in fp32 each step;
  * with `use_kahan_summation` the step rounds the parameter through its
    own dtype and carries the rounding error in a `compensation_dtype`
    buffer, so bf16 parameters accumulate lr-scale updates that each round
    to zero;
  * the learning rate may be a float or a schedule of the step count, and
    the schedule is read at the count BEFORE the increment (schedule(0) on
    the first step), as optax does.

States are created when the optimizer is (all zeros), and state_dict /
load_state_dict keep each state's own dtype. The update is elementwise
and in place on the parameters and states.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "fp32": torch.float32, "bf16": torch.bfloat16}

LR = Union[float, Callable[[int], float]]


class AnyPrecisionAdamW(torch.optim.Optimizer):

    def __init__(self, params, lr: LR = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 momentum_dtype=torch.bfloat16,
                 variance_dtype=torch.bfloat16,
                 use_kahan_summation: bool = True,
                 compensation_dtype=torch.bfloat16):
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps,
                        weight_decay=weight_decay,
                        momentum_dtype=momentum_dtype,
                        variance_dtype=variance_dtype,
                        use_kahan_summation=use_kahan_summation,
                        compensation_dtype=compensation_dtype)
        super().__init__(params, defaults)
        self.count = 0
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                st["mu"] = torch.zeros_like(p, dtype=momentum_dtype)
                st["nu"] = torch.zeros_like(p, dtype=variance_dtype)
                if use_kahan_summation:
                    st["comp"] = torch.zeros_like(p, dtype=compensation_dtype)

    def lr_at(self, group, count: int) -> float:
        lr = group["lr"]
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AnyPrecisionAdamW takes no closure")
        t = self.count + 1
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr = self.lr_at(group, self.count)
            bc1 = 1.0 - b1 ** t
            bc2_sqrt = math.sqrt(1.0 - b2 ** t)
            step_size = lr / bc1
            wd, eps = group["weight_decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                g32 = p.grad.float()
                m32 = st["mu"].float() * b1 + g32 * (1.0 - b1)
                v32 = st["nu"].float() * b2 + g32 * g32 * (1.0 - b2)
                delta = -step_size * m32 / (v32.sqrt() / bc2_sqrt + eps)
                p32 = p.float()
                if wd:
                    delta = delta - lr * wd * p32
                if group["use_kahan_summation"]:
                    # fold the carried error into this step's delta, round
                    # through the param dtype, carry the new rounding error
                    want = delta + st["comp"].float()
                    new_p = (p32 + want).to(p.dtype)
                    st["comp"].copy_(want - (new_p.float() - p32))
                    p.copy_(new_p)
                else:
                    p.copy_(p32 + delta)
                st["mu"].copy_(m32)
                st["nu"].copy_(v32)
        self.count = t

    def state_dict(self):
        return {"count": self.count,
                "state": [dict(self.state[p]) for group in self.param_groups
                          for p in group["params"]]}

    def load_state_dict(self, state_dict):
        """Copy saved states in place; a sharded (DTensor) state takes its
        piece of a full saved one (training/checkpoint.load_full_into)."""
        from .checkpoint import load_full_into
        params = [p for group in self.param_groups for p in group["params"]]
        if len(state_dict["state"]) != len(params):
            raise ValueError(f"optimizer state holds "
                             f"{len(state_dict['state'])} parameters, this "
                             f"optimizer {len(params)}")
        for p, saved in zip(params, state_dict["state"]):
            st = self.state[p]
            if set(saved) != set(st):
                raise ValueError(f"optimizer state keys {sorted(saved)} != "
                                 f"{sorted(st)}")
            for key, value in saved.items():
                load_full_into(st[key], value)
        self.count = int(state_dict["count"])


def adamw_from_config(params, lr: LR, *, weight_decay: float = 0.0,
                      state_dtype: str = "float32", b1: float = 0.9,
                      b2: float = 0.999, eps: float = 1e-8
                      ) -> AnyPrecisionAdamW:
    """state_dtype "float32": fp32 states, no Kahan (plain AdamW, as
    optax.adamw is on the JAX side); "bfloat16": bf16 states + Kahan;
    "bfloat16_nokahan": bf16 states, no compensation buffer."""
    kahan = not state_dtype.endswith("_nokahan")
    dt = _DTYPES.get(state_dtype.replace("_nokahan", ""))
    if dt is None:
        raise ValueError(f"optimizer state_dtype {state_dtype!r}: "
                         f"expected one of {sorted(_DTYPES)} "
                         "(+ optional _nokahan suffix)")
    return AnyPrecisionAdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay, momentum_dtype=dt,
                             variance_dtype=dt,
                             use_kahan_summation=kahan and dt != torch.float32)


def constant_schedule_with_warmup(lr: float, num_warmup_steps: int) -> LR:
    """Constant LR with linear warmup: lr * min(1, count / max(1, warmup)),
    read at the pre-increment count. The plain float without warmup."""
    if num_warmup_steps <= 0:
        return lr

    def sched(count: int) -> float:
        return lr * min(1.0, count / float(max(1, num_warmup_steps)))
    return sched


def resolve_warmup_steps(warmup_steps: Optional[int], warmup_ratio: float,
                         training_steps: int) -> int:
    """Explicit warmup steps win; otherwise warmup_ratio × training_steps."""
    if warmup_steps is not None:
        return int(warmup_steps)
    return int(warmup_ratio * max(int(training_steps), 0))

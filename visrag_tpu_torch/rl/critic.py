"""Critic (value-head) trainer for the GAE path, on one GPU or across
ranks.

Counterpart of visrag_tpu/rl/critic.py (the reference's dp_critic.py:
compute_values :142-170 and update_critic :172-230): a minibatch loop with
token-budget micro-batches, the clipped value loss
(rl/ppo.compute_value_loss) weighted by each micro-batch's share of the
minibatch's response tokens, clip by the global norm, AdamW on
CriticConfig's schedule.

Alignment: values live in logp space, the value at position t scores the
token generated at t+1, so the update takes the same shifted response
mask as the actor.

Across ranks (`mesh`): FSDP2 shards the value model's text layers (and,
as a unit of its own, the fp32 score head) over every rank that holds
the weights, (replica, data, seq), as the actor's are. The value model has no sequence-parallel path (in neither package),
so each micro-batch's rows, the one-process micro-batch padded with rows
that count nothing, are split over all those ranks, seq ranks included;
the loss's denominators are the micro-batch's over the ranks, the
backward is scaled by the rank count (FSDP2 averages), and the values are
gathered back to the global batch for GAE.

What differs from the JAX trainer: the value model is an nn.Module whose
weights the optimizer updates in place; gradients accumulate into `.grad`
across micro-batches; micro-batches are not padded to a power-of-two row
count (nothing is compiled per shape; the JAX padding rows carry a zero
mask and add nothing); a non-finite gradient norm skips the optimizer
step, leaving weights and optimizer state untouched, as there.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from ..config import CriticConfig
from ..training.optim import (adamw_from_config,
                              constant_schedule_with_warmup,
                              resolve_warmup_steps)
from ..training.trainer import clip_by_global_norm_
from .ppo import compute_value_loss, group_sum
from .seqlen import token_budget_micro_batches
from .trainer import _reindex, gather_parts, rank_part

_VALUE_KEYS = ("input_ids", "attention_mask", "positions", "slot_map",
               "vision_embeds")


class CriticTrainer:
    def __init__(self, model, cfg: CriticConfig, *,
                 global_batch_size: int = 32, total_steps: int = 0,
                 mesh=None):
        self.model = model
        self.device = next(model.parameters()).device
        self.cfg = cfg
        self.global_batch_size = global_batch_size
        self.mesh = mesh
        self._group = None
        if mesh is not None:
            from ..mesh import WEIGHT_AXES, axis_group, sub_mesh
            from ..training.trainer import shard_model
            # the fp32 score head is a unit of its own: FSDP2 wants one
            # dtype among a unit's trainable parameters
            shard_model(model, [*model.model.layers, model.score], mesh,
                        sub_mesh(mesh, *WEIGHT_AXES))
            self._group = axis_group(mesh, *WEIGHT_AXES)
        self.params = [p for p in model.parameters() if p.requires_grad]
        # total_steps: the schedule horizon for lr_warmup_ratio (the
        # reference's optim_config.training_steps)
        lr = constant_schedule_with_warmup(
            cfg.lr, resolve_warmup_steps(cfg.lr_warmup_steps,
                                         cfg.lr_warmup_ratio, total_steps))
        self.optimizer = adamw_from_config(
            self.params, lr, weight_decay=cfg.weight_decay, b1=cfg.betas[0],
            b2=cfg.betas[1], state_dtype=cfg.optimizer_state_dtype)

    def _put_batch(self, batch):
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def _micro(self, batch, g):
        """Rows g on the device. Under a mesh, this rank's part of them
        (trainer.rank_part over every weight rank), the rows first padded
        to a multiple of the rank count with copies of row g[0] whose
        response mask is zero (an all-pad row would have no key to
        attend)."""
        if self.mesh is None:
            return self._put_batch(_reindex(batch, list(g)))
        from ..mesh import WEIGHT_AXES, axis_size
        idx = list(g) + [g[0]] * (-len(g) % axis_size(self.mesh,
                                                      *WEIGHT_AXES))
        micro = _reindex(batch, idx)
        if "response_mask" in micro:
            micro["response_mask"] = micro["response_mask"].copy()
            micro["response_mask"][len(g):] = 0
        return self._put_batch(rank_part(micro, self.mesh, WEIGHT_AXES,
                                         seq=False))

    def _values(self, batch):
        return self.model(batch["input_ids"],
                          attention_mask=batch["attention_mask"],
                          positions=batch["positions"],
                          **{k: batch[k] for k in ("slot_map",
                                                   "vision_embeds")
                             if k in batch})

    @torch.no_grad()
    def compute_values(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """(bs, S) fp32 values (logp space), micro-batched under the token
        budget. Vision prompts pass slot_map + the precomputed
        vision_embeds table through the value model."""
        bs, S = batch["input_ids"].shape
        groups, _ = token_budget_micro_batches(
            batch["attention_mask"].sum(1),
            max(self.cfg.micro_batch_tokens, int(S)))
        out = np.zeros((bs, S), np.float32)
        keys = [k for k in _VALUE_KEYS if k in batch]
        for g in groups:
            values = self._values(self._micro({k: batch[k] for k in keys},
                                              g))
            if self.mesh is not None:
                values = gather_parts(values, self.mesh, 1)[:len(g)]
            out[list(g)] = values.float().cpu().numpy()
        return out

    def _apply(self) -> Dict[str, torch.Tensor]:
        gnorm = clip_by_global_norm_(self.params, self.cfg.grad_clip)
        if bool(torch.isfinite(gnorm)):
            self.optimizer.step()
        for p in self.params:
            p.grad = None
        return {"grad_norm": gnorm}

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Clipped value update. Expects logp-space keys: values, returns;
        shifts the response mask into logp space itself."""
        batch = dict(batch)
        batch["response_mask"] = np.roll(batch["response_mask"], -1, axis=1)
        bs, S = batch["input_ids"].shape
        seqlens = batch["attention_mask"].sum(1)
        mini_size = min(self.global_batch_size, bs)
        keys = tuple(k for k in _VALUE_KEYS + ("response_mask", "values",
                                               "returns") if k in batch)
        agg = defaultdict(list)
        for _ in range(self.cfg.ppo_epochs):
            for lo in range(0, bs, mini_size):
                idx = np.arange(lo, min(lo + mini_size, bs))
                mini = _reindex({k: batch[k] for k in keys}, idx)
                total = max(float(mini["response_mask"].sum()), 1.0)
                groups, _ = token_budget_micro_batches(
                    seqlens[idx], max(self.cfg.micro_batch_tokens, int(S)))
                for p in self.params:
                    p.grad = None
                for g in groups:
                    micro = self._micro(mini, g)
                    mask = micro["response_mask"]
                    vf_loss, metrics = compute_value_loss(
                        self._values(micro), micro["returns"],
                        micro["values"], mask,
                        cliprange_value=self.cfg.cliprange_value,
                        group=self._group)
                    # loss · Σmask / the minibatch's total (under a mesh
                    # this rank's share, Σmask the micro-batch's)
                    loss = vf_loss * group_sum(mask.sum().float(),
                                               self._group) / total
                    if self.mesh is None:
                        loss.backward()
                    else:
                        from ..mesh import WEIGHT_AXES, axis_size
                        (loss * axis_size(self.mesh, *WEIGHT_AXES)) \
                            .backward()
                    agg["vf_loss"].append(group_sum(loss.detach(),
                                                    self._group))
                    for k, v in metrics.items():
                        agg[k].append(v.detach())
                for k, v in self._apply().items():
                    agg[k].append(v)
        return {f"critic/{k}": float(np.mean([float(x) for x in v]))
                for k, v in agg.items()}

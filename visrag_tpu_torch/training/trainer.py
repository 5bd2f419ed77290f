"""Retriever training loop: AdamW with warmup and linear decay, global-norm
clipping, the contrastive step (direct or GradCache), logging and
checkpointing.

Counterpart of visrag_tpu/training/trainer.py on one GPU. A step takes a
list of (query batch, page batch) micro-batches: one pair on the direct
path; with GradCache the caller splits the batch into micro-batches of
`grad_cache_micro_batch_size` pairs (each built on the host as its own
batch, so every micro-batch's slot map indexes its own slices).
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional, Sequence

import torch

from ..config import TrainConfig
from .contrastive import (ContrastiveConfig, direct_loss_fn,
                          gradcache_backward)
from .optim import adamw_from_config


def lr_schedule(cfg: TrainConfig, total_steps: int) -> Callable[[int], float]:
    """Linear warmup from 0 to cfg.lr over max(1, warmup_ratio * total)
    steps, then linear decay to 0 over the rest (optax.join_schedules of two
    linear_schedules, as the JAX trainer builds it)."""
    warmup = max(1, int(cfg.warmup_ratio * total_steps))
    decay = max(1, total_steps - warmup)

    def sched(count: int) -> float:
        if count < warmup:
            return cfg.lr * min(max(count / warmup, 0.0), 1.0)
        return cfg.lr * (1.0 - min(max((count - warmup) / decay, 0.0), 1.0))
    return sched


def make_optimizer(params, cfg: TrainConfig, total_steps: int):
    return adamw_from_config(params, lr_schedule(cfg, total_steps),
                             weight_decay=cfg.weight_decay,
                             state_dtype=cfg.optimizer_state_dtype)


@torch.no_grad()
def clip_by_global_norm_(params: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scale the gradients in place to global norm ≤ max_norm (as
    optax.clip_by_global_norm); → the norm before clipping (fp32)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    if norm >= max_norm:
        for g in grads:
            g.div_(norm.to(g.dtype)).mul_(max_norm)
    return norm


class RetrieverTrainer:
    """Host-side loop: iterate batches, run the step, log, checkpoint."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig,
                 total_steps: int = 1000,
                 logger: Optional[Callable[[int, dict], None]] = None,
                 params: Optional[Sequence[torch.Tensor]] = None,
                 seed: int = 0):
        """params: the tensors to train (default: every parameter of the
        model that requires grad, e.g. only the LoRA adapters)."""
        # as the JAX trainer: biaxial_loss is refused (the reference forbids
        # it); inbatch_loss=False and per-device negatives have no meaning
        # for an in-batch CE over the whole batch
        if cfg.biaxial_loss:
            raise NotImplementedError("biaxial_loss is not implemented "
                                      "(the reference forbids it too)")
        if not cfg.inbatch_loss:
            raise NotImplementedError(
                "inbatch_loss=False has no defined semantics: the contrastive "
                "objective is in-batch CE (reference never consumes the flag)")
        if not cfg.negatives_x_device:
            raise NotImplementedError(
                "negatives_x_device=False (per-device negatives) is not "
                "supported: the loss is computed over the whole batch, so "
                "negatives are always shared — shrink data.batch_size to "
                "reduce the negative pool instead")
        self.cfg = cfg
        self.model = model
        self.params = list(params) if params is not None else \
            [p for p in model.parameters() if p.requires_grad]
        self.optimizer = make_optimizer(self.params, cfg, total_steps)
        device = self.params[0].device
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.ccfg = ContrastiveConfig(temperature=cfg.softmax_temperature,
                                      n_passages=cfg.n_passages,
                                      passage_stop_grad=cfg.passage_stop_grad)
        self.logger = logger or (lambda step, m: None)
        self.step = 0
        # optional data.datasets.StatefulIterator: its cursor rides in every
        # checkpoint so that resume continues at the exact row
        self.data_iter = None

    def encode(self, batch, generator=None):
        return self.model(batch, generator=generator)

    def compute_grads(self, micro_batches) -> dict:
        """Zero the grads, then fill .grad for one step → {loss, accuracy}
        as tensors."""
        for p in self.params:
            p.grad = None
        self.model.train()
        if self.cfg.grad_cache:
            loss, metrics = gradcache_backward(self.encode, self.ccfg,
                                               micro_batches, self.generator)
        else:
            if len(micro_batches) != 1:
                raise ValueError("without grad_cache a step takes one "
                                 f"(query, page) batch, got "
                                 f"{len(micro_batches)}")
            (qb, pb), = micro_batches
            loss, metrics = direct_loss_fn(self.encode, self.ccfg)(
                qb, pb, self.generator)
            loss.backward()
        return metrics

    def train_step(self, micro_batches) -> dict:
        """One optimizer step on [(q_batch, p_batch), ...] → metrics
        (loss and accuracy before the update, grad_norm before clipping)."""
        metrics = self.compute_grads(micro_batches)
        gnorm = clip_by_global_norm_(self.params, self.cfg.grad_clip)
        self.optimizer.step()
        self.step += 1
        return {k: float(v) for k, v in dict(metrics, grad_norm=gnorm).items()}

    def train(self, batches: Iterable, checkpoint_dir: Optional[str] = None):
        metrics_hist = []
        t0 = time.time()
        for micro_batches in batches:
            if 0 < self.cfg.max_steps <= self.step:
                break
            m = self.train_step(micro_batches)
            if self.step % self.cfg.log_every == 0:
                m["steps_per_s"] = self.cfg.log_every / (time.time() - t0)
                t0 = time.time()
                metrics_hist.append((self.step, m))
                self.logger(self.step, m)
            if checkpoint_dir and self.step % self.cfg.save_every == 0:
                self.save(checkpoint_dir)
            if 0 < self.cfg.max_steps <= self.step:
                break
        return metrics_hist

    def save(self, checkpoint_dir: str) -> str:
        from .checkpoint import save_checkpoint
        extra = {"step": self.step}
        if self.data_iter is not None:
            extra["data"] = self.data_iter.state()
        return save_checkpoint(
            checkpoint_dir, self.step,
            {"model": self.model.state_dict(),
             "optimizer": self.optimizer.state_dict()},
            extra=extra, save_limit=getattr(self.cfg, "save_limit", None))

    def maybe_resume(self, checkpoint_dir: str) -> int:
        """Resume model, optimizer and step from the newest checkpoint; with
        self.data_iter set and a data cursor in the checkpoint, the iterator
        continues at the exact row. → the restored step (0 if none)."""
        from .checkpoint import find_latest_ckpt, load_checkpoint
        path = find_latest_ckpt(checkpoint_dir)
        if path is None:
            return 0
        tree, extra = load_checkpoint(path)
        self.model.load_state_dict(tree["model"])
        self.optimizer.load_state_dict(tree["optimizer"])
        self.step = int(extra["step"]) if extra else 0
        if self.data_iter is not None and extra and "data" in extra:
            self.data_iter.set_state(extra["data"])
        return self.step

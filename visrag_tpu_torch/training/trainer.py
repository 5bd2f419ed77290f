"""Retriever training loop: AdamW with warmup and linear decay, global-norm
clipping, the contrastive step (direct or GradCache), logging and
checkpointing.

Counterpart of visrag_tpu/training/trainer.py. A step takes a list of
(query batch, page batch) micro-batches: one pair on the direct path;
with GradCache the caller splits the batch into micro-batches of
`grad_cache_micro_batch_size` pairs (each built on the host as its own
batch, so every micro-batch's slot map indexes its own slices).

With a mesh (one process per GPU) each rank takes its block of the global
batch (mesh.local_slice, the JAX batch sharding), the negatives are
shared across ranks (training/contrastive.py), and the weights are
sharded by FSDP2: `fully_shard` on every ViT block and LM layer and at
the root, over the `data` axis, or HSDP over (replica, data) when the
replica axis is larger than 1, each parameter on the axis that the JAX
rule `mesh.fsdp_param_spec` picks. The global-norm clip reduces the
squared norms of the shards, and a checkpoint holds the full tensors
(rank 0 writes the one-process format).

With LoRA (`params` the adapters) the frozen base is sharded with its
adapters: a block's base weights and adapters are one FSDP2 unit, the
base all-gathered for the forward and never reduced (it takes no
gradient), and the optimizer holds only the adapters' shards. (The JAX
trainer FSDP-shards the LoRA tree and closes over a replicated base.)
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

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


def _sharded_norm(grads) -> torch.Tensor:
    """The global norm of FSDP-sharded gradients: the shards' squared
    norms summed over the mesh dims they are sharded on (not over the
    replicated HSDP dim)."""
    sq = torch.stack([torch.linalg.vector_norm(g.to_local().float()) ** 2
                      for g in grads]).sum()
    mesh = grads[0].device_mesh
    for dim, placement in enumerate(grads[0].placements):
        if placement.is_shard():
            dist.all_reduce(sq, group=mesh.get_group(dim))
    return sq.sqrt()


@torch.no_grad()
def clip_by_global_norm_(params: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scale the gradients in place to global norm ≤ max_norm (as
    optax.clip_by_global_norm); → the norm before clipping (fp32). Whole
    and sharded (FSDP2) gradients take one order: the square root of the
    sum of each tensor's (each shard's) squared norm, so that one rank
    gives one process's norm to the bit."""
    grads = [p.grad for p in params if p.grad is not None]
    if grads and isinstance(grads[0], DTensor):
        norm = _sharded_norm(grads)
        grads = [g.to_local() for g in grads]
    else:
        norm = torch.stack([torch.linalg.vector_norm(g.float()) ** 2
                            for g in grads]).sum().sqrt()
    if norm >= max_norm:
        for g in grads:
            g.div_(norm.to(g.dtype)).mul_(max_norm)
    return norm


def shard_model(model: torch.nn.Module, blocks, mesh, fsdp_mesh=None,
                ignored: Optional[torch.nn.Module] = None):
    """FSDP2: `fully_shard` on each module of `blocks` and at the root,
    over `fsdp_mesh` (default: the mesh's data axis, or HSDP on (replica,
    data) when replica > 1), each parameter on the axis that
    fsdp_param_spec picks for the shard count. `ignored`: a submodule
    whose parameters stay whole on every rank (a frozen vision tower)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    from ..mesh import BATCH_AXES, DATA, REPLICA, axis_size, fsdp_shard_dim, \
        sub_mesh
    if fsdp_mesh is None:
        fsdp_mesh = sub_mesh(mesh, *BATCH_AXES) \
            if axis_size(mesh, REPLICA) > 1 else sub_mesh(mesh, DATA)
    sizes = {DATA: fsdp_mesh.mesh.shape[-1]}

    def placement(p):
        return Shard(fsdp_shard_dim(tuple(p.shape), sizes))

    for block in blocks:
        fully_shard(block, mesh=fsdp_mesh, shard_placement_fn=placement)
    fully_shard(model, mesh=fsdp_mesh, shard_placement_fn=placement,
                ignored_params=set(ignored.parameters()) if ignored
                is not None else None)


def retriever_blocks(model: torch.nn.Module):
    """The FSDP units of VisRAG-Ret: every ViT block and LM layer."""
    bb = model.backbone
    return list(bb.vpm.blocks) + list(bb.llm.layers)


class RetrieverTrainer:
    """Host-side loop: iterate batches, run the step, log, checkpoint."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig,
                 total_steps: int = 1000,
                 logger: Optional[Callable[[int, dict], None]] = None,
                 params: Optional[Sequence[torch.Tensor]] = None,
                 seed: int = 0, mesh=None):
        """params: the tensors to train (default: every parameter of the
        model that requires grad, e.g. only the LoRA adapters). mesh: a
        DeviceMesh (mesh.build_mesh); the model is then sharded here and
        each step takes this rank's micro-batches."""
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
        self.mesh = mesh
        names = None
        if params is not None:
            ids = {id(p) for p in params}
            names = {n for n, p in model.named_parameters() if id(p) in ids}
        if mesh is not None:
            # FSDP2 puts new (sharded) parameters in the modules' place
            shard_model(model, retriever_blocks(model), mesh)
        self.params = [p for n, p in model.named_parameters()
                       if n in names] if names is not None else \
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
        # the loss is the global mean on every rank and FSDP2 averages the
        # ranks' gradients: scaling by the rank count makes their sum
        from ..mesh import BATCH_AXES, axis_group, axis_size
        group = None if self.mesh is None else \
            axis_group(self.mesh, *BATCH_AXES)
        scale = axis_size(self.mesh, *BATCH_AXES)
        if self.cfg.grad_cache:
            loss, metrics = gradcache_backward(
                self.encode, self.ccfg, micro_batches, self.generator,
                group=group, grad_scale=scale)
        else:
            if len(micro_batches) != 1:
                raise ValueError("without grad_cache a step takes one "
                                 f"(query, page) batch, got "
                                 f"{len(micro_batches)}")
            (qb, pb), = micro_batches
            loss, metrics = direct_loss_fn(self.encode, self.ccfg, group)(
                qb, pb, self.generator)
            (loss * scale).backward()
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
        """Save model, optimizer, step and data cursor; under a mesh every
        rank gathers the full tensors and rank 0 writes them."""
        from .checkpoint import _ckpt_dir, full_tensors, save_checkpoint
        extra = {"step": self.step}
        if self.data_iter is not None:
            extra["data"] = self.data_iter.state()
        tree = {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}
        if self.mesh is None:
            return save_checkpoint(
                checkpoint_dir, self.step, tree, extra=extra,
                save_limit=getattr(self.cfg, "save_limit", None))
        tree = full_tensors(tree)
        if dist.get_rank() == 0:
            save_checkpoint(checkpoint_dir, self.step, tree, extra=extra,
                            save_limit=getattr(self.cfg, "save_limit", None))
        dist.barrier()
        return _ckpt_dir(checkpoint_dir, self.step)

    def maybe_resume(self, checkpoint_dir: str) -> int:
        """Resume model, optimizer and step from the newest checkpoint; with
        self.data_iter set and a data cursor in the checkpoint, the iterator
        continues at the exact row. → the restored step (0 if none)."""
        from .checkpoint import (find_latest_ckpt, load_checkpoint,
                                 load_state_into)
        path = find_latest_ckpt(checkpoint_dir)
        if path is None:
            return 0
        tree, extra = load_checkpoint(path)
        load_state_into(self.model, tree["model"])
        self.optimizer.load_state_dict(tree["optimizer"])
        self.step = int(extra["step"]) if extra else 0
        if self.data_iter is not None and extra and "data" in extra:
            self.data_iter.set_state(extra["data"])
        return self.step

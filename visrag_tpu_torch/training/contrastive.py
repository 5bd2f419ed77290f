"""Contrastive loss and GradCache for the retriever (in-batch negatives).

Counterpart of visrag_tpu/training/contrastive.py:
  * scores = q @ pᵀ / temperature (τ = 0.02 in the paper config);
  * target[i] = i * n_passages (one positive among n_passages per query);
  * loss = mean cross-entropy over the batch; accuracy = argmax == target.

Cross-device negatives: with a process group (the mesh's (replica, data)
ranks, each holding a contiguous block of the global batch) every rank
all-gathers the representations, splices its own block back in with its
gradient, and computes the loss over the gathered global order, query i
against passage i * n_passages; each rank's backward then reaches only
its own block's encoder. The loss is the same global mean on every rank,
so the ranks' parameter gradients sum to the one-process gradient; FSDP2
averages them over the ranks, and the trainer scales the backward by the
rank count to undo that average (the reference's x world_size).

GradCache runs in two passes over micro-batches of (query, page) batches:
  pass 1: encode every micro-batch under torch.no_grad (the attention
  kernels run without their LSE) and keep only the representations;
  then the loss and its gradient with respect to the representations (a
  small matmul);
  pass 2: encode each micro-batch again with grad and backpropagate the
  cached representation gradients into the parameters' .grad, so only one
  micro-batch of activations is alive at a time.
Dropout replays exactly: the generator's state is recorded before each
micro-batch in pass 1 and restored before the same micro-batch in pass 2.

`encode(batch, generator)` → (B, D) representations throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ContrastiveConfig:
    temperature: float = 0.02
    n_passages: int = 1
    passage_stop_grad: bool = False


def contrastive_loss(q_reps, p_reps, cfg: ContrastiveConfig):
    """q_reps (B, D); p_reps (B*n_passages, D) → (loss, metrics), fp32."""
    if cfg.passage_stop_grad:
        p_reps = p_reps.detach()
    scores = q_reps.float() @ p_reps.float().T / cfg.temperature
    target = torch.arange(scores.shape[0], device=scores.device) \
        * cfg.n_passages
    logz = torch.logsumexp(scores, dim=1)
    gold = scores.gather(1, target[:, None])[:, 0]
    loss = (logz - gold).mean()
    accuracy = (scores.argmax(dim=1) == target).float().mean()
    return loss, {"accuracy": accuracy.detach(), "loss": loss.detach()}


def gather_reps(local, group=None):
    """Every rank's (n, D) block in rank order, this rank's block spliced
    back in with its gradient (the others are constants); `local` itself
    without a group."""
    if group is None:
        return local
    from ..mesh import all_gather_rows
    full = all_gather_rows(local.detach(), group)
    r, n = dist.get_rank(group), local.shape[0]
    return torch.cat([full[:r * n], local, full[(r + 1) * n:]])


def direct_loss_fn(encode: Callable, cfg: ContrastiveConfig, group=None):
    """loss(q_batch, p_batch, generator) for the path without GradCache;
    with a group, over the gathered global batch."""

    def fn(q_batch, p_batch, generator=None):
        q_reps = gather_reps(encode(q_batch, generator), group)
        p_reps = gather_reps(encode(p_batch, generator), group)
        return contrastive_loss(q_reps, p_reps, cfg)

    return fn


def _state(generator):
    return None if generator is None else generator.get_state()


def gradcache_backward(encode: Callable, cfg: ContrastiveConfig,
                       micro_batches: Sequence[Tuple[object, object]],
                       generator: Optional[torch.Generator] = None,
                       group=None, grad_scale: float = 1.0):
    """Two-pass GradCache over [(q_batch, p_batch), ...], this rank's
    micro-batches; with a group the loss is over every rank's. Accumulates
    grad_scale x the parameter gradients into .grad and returns (loss,
    metrics)."""
    states, q_parts, p_parts = [], [], []
    with torch.no_grad():
        for qb, pb in micro_batches:
            states.append(_state(generator))
            q_parts.append(encode(qb, generator))
            p_parts.append(encode(pb, generator))
    q_reps = torch.cat(q_parts).requires_grad_(True)
    p_reps = torch.cat(p_parts).requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = contrastive_loss(gather_reps(q_reps, group),
                                         gather_reps(p_reps, group), cfg)
        (loss * grad_scale).backward()
    gq = q_reps.grad.split([q.shape[0] for q in q_parts])
    gp = None if p_reps.grad is None else \
        p_reps.grad.split([p.shape[0] for p in p_parts])
    for i, (qb, pb) in enumerate(micro_batches):
        if states[i] is not None:
            generator.set_state(states[i])
        outs, grads = [encode(qb, generator)], [gq[i]]
        p = encode(pb, generator)
        if gp is not None:
            outs.append(p)
            grads.append(gp[i])
        torch.autograd.backward(outs, grads)
    return loss.detach(), metrics

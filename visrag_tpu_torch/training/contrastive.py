"""Contrastive loss and GradCache for the retriever (in-batch negatives).

Counterpart of visrag_tpu/training/contrastive.py:
  * scores = q @ pᵀ / temperature (τ = 0.02 in the paper config);
  * target[i] = i * n_passages (one positive among n_passages per query);
  * loss = mean cross-entropy over the batch; accuracy = argmax == target.

Negatives come from the batch on this GPU; cross-device negatives over
torch.distributed are not ported (the trainer refuses more than one
device).

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


def direct_loss_fn(encode: Callable, cfg: ContrastiveConfig):
    """loss(q_batch, p_batch, generator) for the path without GradCache."""

    def fn(q_batch, p_batch, generator=None):
        q_reps = encode(q_batch, generator)
        p_reps = encode(p_batch, generator)
        return contrastive_loss(q_reps, p_reps, cfg)

    return fn


def _state(generator):
    return None if generator is None else generator.get_state()


def gradcache_backward(encode: Callable, cfg: ContrastiveConfig,
                       micro_batches: Sequence[Tuple[object, object]],
                       generator: Optional[torch.Generator] = None):
    """Two-pass GradCache over [(q_batch, p_batch), ...]; accumulates the
    parameter gradients into .grad and returns (loss, metrics)."""
    states, q_parts, p_parts = [], [], []
    with torch.no_grad():
        for qb, pb in micro_batches:
            states.append(_state(generator))
            q_parts.append(encode(qb, generator))
            p_parts.append(encode(pb, generator))
    q_reps = torch.cat(q_parts).requires_grad_(True)
    p_reps = torch.cat(p_parts).requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = contrastive_loss(q_reps, p_reps, cfg)
        loss.backward()
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

"""Supervised fine-tuning (the EVisRAG stage-1 role).

Counterpart of visrag_tpu/training/sft.py (the reference's LLaMA-Factory
full fine-tune of Qwen2.5-VL: freeze_vision_tower, lr 5e-7): cross-entropy
on response tokens only, the vision tower optionally frozen, one step =
forward, backward, clip by the global norm, AdamW.

What differs from the JAX step:

  * the model is an nn.Module that carries its weights; `step(batch)`
    updates them in place and returns the metrics;
  * the frozen tower is `requires_grad_(False)` and never enters the
    optimizer, so weight decay cannot move it (JAX masks the optimizer);
  * the loss projects hidden states through the LM head in sequence chunks
    (rl/ppo.chunked_token_log_probs, and `token_accuracy` chunk by chunk):
    the (B, S, V) logits never exist, where at 4 x 4096 x 152k they would
    be 10 GB in fp32.

With a mesh (one process per GPU) the step takes the global batch and
each rank its rows (mesh.local_slice over (replica, data)); the text
layers and the root are sharded by FSDP2 over every rank that holds the
weights, (replica, data, seq); the model runs its sequence-parallel path
(`sp_mesh`), so each rank of a seq group keeps its block of the sequence.
The labels are shifted on the whole sequence before the block is cut, so
the last token of one block predicts the first of the next; the
response-token count and the loss sum are reduced over every rank, so the
loss is the global batch's, and the backward is scaled by the rank count
to undo FSDP2's average: the gradients are the one-process step's.
`ulysses_size` must then equal the mesh's seq size (as the JAX step
checks).

With `attention_mask` rows the text model's attention is the valid-length
kernel K1 with its log-sum-exp forward and K2 backward, at d = 128 with
grouped kv heads, and every RMSNorm is K7 (on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..rl.ppo import group_sum, next_token_log_probs, seq_block
from .optim import adamw_from_config, constant_schedule_with_warmup
from .trainer import clip_by_global_norm_


@dataclasses.dataclass
class SFTConfig:
    lr: float = 5e-7
    weight_decay: float = 0.0
    warmup_steps: int = 10
    total_steps: int = 1000
    grad_clip: float = 1.0
    freeze_vision_tower: bool = True
    vision_key: str = "visual"
    # Ulysses SP degree: the mesh's seq axis (training/sft.make_sft_step)
    ulysses_size: int = 1
    # "bfloat16" = AnyPrecisionAdamW states (bf16 + Kahan)
    optimizer_state_dtype: str = "float32"


_MODEL_KEYS = ("attention_mask", "positions", "vision_batch", "slot_map")


def token_accuracy(head_fn, hidden, labels, mask, chunk: int = 512):
    """Σ mask · [argmax(head_fn(hidden)) == labels], the head applied over
    sequence chunks of `chunk` tokens, without gradients. → fp32 scalar."""
    hits = torch.zeros((), dtype=torch.float32, device=hidden.device)
    with torch.no_grad():
        for lo in range(0, hidden.shape[1], chunk):
            pred = head_fn(hidden[:, lo:lo + chunk]).argmax(-1)
            hits += ((pred == labels[:, lo:lo + chunk]).float()
                     * mask[:, lo:lo + chunk]).sum()
    return hits


def sft_loss(model, batch, mesh=None) -> tuple:
    """batch: input_ids (B, S), attention_mask, response_mask (1 on tokens
    the model must predict), optional positions / vision_batch / slot_map.
    → (loss, {"loss", "token_accuracy"}). With a mesh the batch is this
    rank's rows and the loss its share of the global loss (the metrics
    are the global ones). One rank computes what one process does."""
    from ..mesh import SEQ, WEIGHT_AXES, axis_group, axis_size
    sp = mesh if axis_size(mesh, SEQ) > 1 else None
    ids = batch["input_ids"]
    _, hidden = model(ids, return_logits=False, sp_mesh=sp,
                      **{k: batch.get(k) for k in _MODEL_KEYS})
    logp = next_token_log_probs(model.compute_logits, hidden, ids, sp)
    labels = seq_block(torch.roll(ids, -1, dims=1), sp)
    # token t predicts t+1 → shift the response mask left
    mask = torch.roll(batch["response_mask"], -1, dims=1).float()
    mask[:, -1] = 0                      # the last token predicts nothing
    mask = seq_block(mask, sp)
    group = None if mesh is None else axis_group(mesh, *WEIGHT_AXES)
    sums = group_sum(torch.stack([mask.sum(), token_accuracy(
        model.compute_logits, hidden.detach(), labels, mask)]), group)
    denom = torch.clamp(sums[0], min=1.0)
    loss = -(logp * mask).sum() / denom
    return loss, {"loss": group_sum(loss.detach(), group),
                  "token_accuracy": sums[1] / denom}


def _local_rows(batch, mesh):
    """This rank's rows of every (B, ...) entry; positions (3, B, S) by
    dim 1; the vision batch whole (the tower runs unsharded, and the
    rows' slot maps index its output)."""
    from ..mesh import local_slice
    rows = local_slice(range(len(batch["input_ids"])), mesh)
    rows = slice(rows.start, rows.stop)
    out = {}
    for k, v in batch.items():
        if k == "vision_batch":
            out[k] = v
        elif k == "positions" and v.ndim == 3:
            out[k] = v[:, rows]
        else:
            out[k] = v[rows]
    return out


def make_sft_step(model, cfg: SFTConfig, mesh=None):
    """Freeze the tower (cfg.freeze_vision_tower) and build the optimizer
    over the trainable parameters; with a mesh, shard the model first
    (module docstring). → (optimizer, step): step(batch) runs one update
    in place on the global batch and returns {"loss", "token_accuracy",
    "grad_norm"}, grad_norm before clipping. The learning rate warms up
    linearly from 0 over max(warmup_steps, 1) steps, then stays at lr."""
    from ..mesh import SEQ, WEIGHT_AXES, axis_size, local_device, sub_mesh
    if cfg.ulysses_size > 1 and axis_size(mesh, SEQ) != cfg.ulysses_size:
        raise ValueError(f"ulysses_size={cfg.ulysses_size} needs a mesh "
                         f"with seq={cfg.ulysses_size}")
    if cfg.freeze_vision_tower:
        for name, p in model.named_parameters():
            if cfg.vision_key in name.split("."):
                p.requires_grad_(False)
    scale = axis_size(mesh, *WEIGHT_AXES)
    if mesh is not None:
        from .trainer import shard_model
        shard_model(model, model.model.layers, mesh,
                    sub_mesh(mesh, *WEIGHT_AXES))
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer = adamw_from_config(
        params, constant_schedule_with_warmup(cfg.lr,
                                              max(cfg.warmup_steps, 1)),
        weight_decay=cfg.weight_decay, state_dtype=cfg.optimizer_state_dtype)
    device = local_device(next(model.parameters()).device)

    def put(v):
        if isinstance(v, dict):
            return {k: put(x) for k, x in v.items()}
        return torch.as_tensor(v, device=device)

    def step(batch) -> Dict[str, torch.Tensor]:
        batch = {k: v for k, v in batch.items() if v is not None}
        if mesh is not None:
            batch = _local_rows(batch, mesh)
        batch = {k: put(v) for k, v in batch.items()}
        loss, metrics = sft_loss(model, batch, mesh)
        (loss * scale).backward()
        gnorm = clip_by_global_norm_(params, cfg.grad_clip)
        optimizer.step()
        for p in params:
            p.grad = None
        return dict(metrics, grad_norm=gnorm)

    return optimizer, step

"""Dual-clip PPO objective with reward-scoped masks (RS-GRPO core), KL
penalties, and loss averaging, on torch tensors.

Counterpart of visrag_tpu/rl/ppo.py, function for function. Parity with the
reference src/rsgrpo/verl/trainer/core_algos.py:362-562 and the actor's
token normalization (dp_actor.py:286-288):

  pg_loss   = dual-clip PPO on ratio broadcast against
              advantages[:, :, None] * reward_masks (bs, n_rewards, len);
  per-channel "router" averaging → (n_rewards,);
  final      = Σ_ch loss_ch · local_tokens_ch / global_tokens_ch
               / count(loss_ch ≠ 0)

The "global" token totals of the minibatch are passed in by the trainer
(`total_tokens`). Across ranks (`group`: the process group whose ranks
hold the micro-batch's rows and sequence blocks between them) every
denominator, channel count and metric is the micro-batch's over the
group, and each rank's loss is its share: its own tokens' terms over the
group's denominators, so that the shares sum to the one-process loss and
each rank's gradient is that of its own tokens (the JAX package's
GSPMD sums do this implicitly).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint


def log_probs_from_logits(logits, labels):
    """(B, S, V), (B, S) → (B, S) log p(label). fp32 logsumexp."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return gold - logz


def _chunk_log_probs(head_fn, h, l):
    logits = head_fn(h)
    logz = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.gather(logits, -1, l.long()[..., None])[..., 0]
    return gold.float() - logz


def chunked_token_log_probs(head_fn, hidden, labels, chunk: int = 512):
    """(B, S, H) hidden + (B, S) labels → (B, S) fp32 log p(label) without
    ever holding the (B, S, V) logits (at a 15k-token row they are ~10 GB in
    fp32). A Python loop over sequence chunks; each chunk's head runs under
    torch.utils.checkpoint (non-reentrant) while gradients are on, so the
    backward also recomputes one chunk's logits at a time: forward and
    backward peak at one (B, chunk, V) buffer. head_fn: (B, K, H) → (B, K,
    V) logits; its weight's gradient accumulates across the chunks.

    The chunk size is the JAX function's: S split into ceil(S/chunk) equal
    pieces rounded up to 128, the last one short instead of padded."""
    b, s, _ = hidden.shape
    n = -(-s // chunk)
    c = -(-(-(-s // n)) // 128) * 128
    out = []
    remat = torch.is_grad_enabled() and hidden.requires_grad
    for lo in range(0, s, c):
        h, l = hidden[:, lo:lo + c], labels[:, lo:lo + c]
        out.append(checkpoint(_chunk_log_probs, head_fn, h, l,
                              use_reentrant=False) if remat
                   else _chunk_log_probs(head_fn, h, l))
    return torch.cat(out, dim=1)


def group_sum(x, group=None):
    """x summed over the ranks of `group`, without gradient; x itself
    without a group."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def seq_block(x, mesh=None, dim: int = 1):
    """This rank's contiguous block of dim `dim` over the mesh's seq axis
    (the block the sequence-parallel model returns); x itself at seq 1."""
    from ..mesh import SEQ, axis_index, axis_size
    n = axis_size(mesh, SEQ)
    if n <= 1:
        return x
    s, r = x.shape[dim], axis_index(mesh, SEQ)
    return x.narrow(dim, r * s // n, s // n)


def next_token_log_probs(head_fn, hidden, input_ids, mesh=None):
    """log p(the next token) at every position of `hidden`, 0 at the
    sequence's last position → (B, S') fp32. hidden: the model's output,
    whole rows (B, S, H), or at seq > 1 on `mesh` this rank's block (B,
    S / seq, H), whose last position takes its label from the next
    block's first token (input_ids are the whole rows)."""
    from ..mesh import SEQ, axis_index, axis_size
    labels = torch.roll(input_ids, -1, dims=1)
    n = axis_size(mesh, SEQ)
    if n <= 1:
        logp = chunked_token_log_probs(head_fn, hidden[:, :-1],
                                       labels[:, :-1])
    else:
        logp = chunked_token_log_probs(head_fn, hidden,
                                       seq_block(labels, mesh))
        if axis_index(mesh, SEQ) < n - 1:
            return logp
        logp = logp[:, :-1]
    return torch.cat([logp, torch.zeros_like(logp[:, :1])], dim=1)


def masked_mean(x, mask, eps: float = 1e-8, group=None):
    """Σ x·mask / Σ mask; with a group, this rank's share: its own Σ x·mask
    over the group's Σ mask."""
    return torch.sum(x * mask) / (group_sum(torch.sum(mask), group) + eps)


def average_loss(values, mask, mode: str = "token", eps: float = 1e-8,
                 group=None):
    """core_algos.py:362-388. 'router' → per-channel means (n_rewards,).
    With a group ('router' and 'token'), this rank's share of the
    group's means."""
    if mode == "router":
        return torch.sum(values * mask, dim=(0, 2)) / \
            (group_sum(torch.sum(mask, dim=(0, 2)), group) + eps)
    if mode == "token":
        return masked_mean(values, mask, eps, group)
    if group is not None:
        raise ValueError(f"loss mode {mode!r} has no share across ranks")
    if mode == "seq":
        return torch.mean(torch.sum(values * mask, -1)
                          / (torch.sum(mask, -1) + eps))
    raise ValueError(mode)


def compute_policy_loss(old_log_probs, log_probs, advantages, response_mask,
                        reward_masks, *, clip_ratio_low=0.2,
                        clip_ratio_high=0.3, clip_ratio_dual=3.0,
                        group=None):
    """core_algos.compute_policy_loss (:391-472).

    old_log_probs/log_probs (bs, len); advantages (bs, n_rewards) — or
    (bs, n_rewards, len) when already scoped per token (the packed
    padding-free path precomputes advantage·mask before packing);
    reward_masks (bs, n_rewards, len). → (pg_loss (n_rewards,), metrics);
    with a group, this rank's shares of both."""
    reward_masks = reward_masks.to(log_probs.dtype)
    if advantages.dim() == 3:
        adv = advantages                                         # (bs, n, len)
    else:
        adv = advantages[:, :, None] * reward_masks              # (bs, n, len)
    neg_kl = torch.clamp(log_probs - old_log_probs, -20.0, 20.0)[:, None, :]
    neg_kl = neg_kl.expand(adv.shape)
    ratio = torch.exp(neg_kl)
    clipped_ratio = torch.exp(torch.clamp(
        neg_kl, math.log(1.0 - clip_ratio_low),
        math.log(1.0 + clip_ratio_high)))

    pg1 = -adv * ratio
    pg2 = -adv * clipped_ratio
    pg3 = -adv * clip_ratio_dual
    clipped_higher = torch.maximum(pg1, pg2)
    clipped_lower = torch.minimum(clipped_higher, pg3)
    final = torch.where(adv < 0, clipped_lower, clipped_higher)

    pg_loss = average_loss(final, reward_masks, mode="router", group=group)

    metrics = {
        "ppo_kl": masked_mean(-neg_kl, reward_masks, group=group),
        "pg_clipfrac_higher": masked_mean((pg1 < pg2).float(), reward_masks,
                                          group=group),
        "pg_clipfrac_lower": masked_mean(
            ((clipped_higher > pg3) & (adv < 0)).float(), reward_masks,
            group=group),
        "entropy_loss": masked_mean(-log_probs[:, None, :] *
                                    torch.ones_like(reward_masks),
                                    reward_masks, group=group),
    }
    return pg_loss, metrics


def compute_kl(log_probs, ref_log_probs, kind: str = "low_var_kl"):
    """core_algos.compute_kl (:523-562)."""
    delta = log_probs - ref_log_probs
    if kind == "kl":
        return delta
    if kind == "abs":
        return torch.abs(delta)
    if kind == "mse":
        return 0.5 * torch.square(delta)
    if kind == "low_var_kl":
        d = torch.clamp(ref_log_probs - log_probs, -20.0, 20.0)
        return torch.clamp(torch.exp(d) - d - 1.0, -10.0, 10.0)
    if kind == "full":
        raise NotImplementedError(
            "kl_penalty='full' is a deliberate wontfix, as in the JAX "
            "package: the reference's F.kl_div over the SEQUENCE dim of "
            "chosen-token logprobs (core_algos.py:559-560) is not a KL "
            "between distributions; use kl/abs/mse/low_var_kl")
    raise ValueError(kind)


def combine_channel_losses(pg_loss, reward_masks, *, total_tokens=None,
                           group=None):
    """Per-reward token normalization (dp_actor.py:237-238, :286-288):
    final = Σ_ch pg_ch · local_tok_ch / global_tok_ch / #nonzero.
    total_tokens: the minibatch's (n_rewards,) token totals; None → this
    micro-batch's own. With a group, pg_loss is this rank's share, and
    the micro-batch's token counts and nonzero channels are the group's."""
    local = group_sum(torch.sum(reward_masks, dim=(0, 2)).float(), group)
    if total_tokens is None:
        total_tokens = local
    nz = torch.sum((group_sum(pg_loss, group) != 0.0).float())
    return torch.sum(pg_loss * local / torch.clamp(total_tokens, min=1.0)) / \
        torch.clamp(nz, min=1.0)


def compute_value_loss(vpreds, returns, values, response_mask, *,
                       cliprange_value: float = 0.5,
                       loss_avg_mode: str = "token", group=None):
    """Clipped critic loss (core_algos.compute_value_loss :475-521).
    All args (bs, len) in the same (logp-shifted) alignment. With a group:
    this rank's share of the loss, and the metrics over the group."""
    vpredclipped = torch.clamp(vpreds, values - cliprange_value,
                               values + cliprange_value)
    l1 = torch.square(vpreds - returns)
    l2 = torch.square(vpredclipped - returns)
    clipped = torch.maximum(l1, l2)
    vf_loss = 0.5 * average_loss(clipped, response_mask, mode=loss_avg_mode,
                                 group=group)
    metrics = {
        "vf_clipfrac": masked_mean((l1 < l2).float(), response_mask,
                                   group=group),
        "vpred_mean": masked_mean(vpreds, response_mask, group=group),
    }
    return vf_loss, {k: group_sum(v, group) for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# KL controllers + reward-side KL penalty (core_algos.py:38-103,
# ray_trainer.apply_kl_penalty :110-127)
# ---------------------------------------------------------------------------


class FixedKLController:
    def __init__(self, init_kl_coef: float):
        self.kl_coef = init_kl_coef

    def update(self, current_kl: float, n_steps: int):
        pass


class AdaptiveKLController:
    """Adaptive controller from arXiv:1909.08593 (core_algos.py:48-62)."""

    def __init__(self, init_kl_coef: float, target_kl: float, horizon: float):
        self.kl_coef = init_kl_coef
        self.target = target_kl
        self.horizon = horizon

    def update(self, current_kl: float, n_steps: int):
        proportional_error = float(
            np.clip(np.float32(current_kl) / np.float32(self.target) - 1,
                    -0.2, 0.2))
        self.kl_coef *= 1 + proportional_error * n_steps / self.horizon


def get_kl_controller(kl_type: str, kl_coef: float, kl_target: float = 0.1,
                      kl_horizon: float = 10000.0):
    if kl_type == "fixed":
        return FixedKLController(kl_coef)
    if kl_type == "adaptive":
        assert kl_horizon > 0, "horizon must be larger than 0"
        return AdaptiveKLController(kl_coef, kl_target, kl_horizon)
    raise ValueError(f"Unknown kl type: {kl_type}")


def apply_kl_penalty(token_scores, old_log_probs, ref_log_probs,
                     response_mask, kl_ctrl, kind: str = "kl"):
    """token_level_rewards = scores − kl_coef·KL(π, π_ref); updates the
    controller with the batch-mean sequence KL (ray_trainer.py:110-127).
    All arrays (bs, len), numpy, in the same alignment."""
    kld = compute_kl(torch.as_tensor(np.asarray(old_log_probs)),
                     torch.as_tensor(np.asarray(ref_log_probs)), kind).numpy()
    kld = kld * response_mask
    rewards = token_scores - kl_ctrl.kl_coef * kld
    seq_kl = kld.sum(-1) / np.maximum(response_mask.sum(-1), 1)
    current_kl = float(seq_kl.mean())
    metrics = {"critic/kl": current_kl, "critic/kl_coef": kl_ctrl.kl_coef}
    kl_ctrl.update(current_kl, token_scores.shape[0])
    return rewards.astype(np.float32), metrics


def ppo_loss(old_log_probs, log_probs, advantages, response_mask,
             reward_masks, *, ref_log_probs=None, kl_coef: float = 0.0,
             kl_type: str = "low_var_kl", clip_ratio_low=0.2,
             clip_ratio_high=0.3, clip_ratio_dual=3.0,
             total_tokens=None, group=None) -> tuple:
    """Full actor objective → (scalar loss, metrics). With a group: this
    rank's share of the loss, and the micro-batch's metrics over the
    group."""
    pg, metrics = compute_policy_loss(
        old_log_probs, log_probs, advantages, response_mask, reward_masks,
        clip_ratio_low=clip_ratio_low, clip_ratio_high=clip_ratio_high,
        clip_ratio_dual=clip_ratio_dual, group=group)
    if ref_log_probs is not None and kl_coef > 0.0:
        kld = compute_kl(log_probs, ref_log_probs, kl_type)[:, None, :]
        kl_loss = average_loss(kld.expand(reward_masks.shape),
                               reward_masks.to(kld.dtype), mode="router",
                               group=group)
        pg = pg + kl_loss * kl_coef
        metrics = dict(metrics, kl_loss=torch.mean(group_sum(kl_loss,
                                                             group)))
    loss = combine_channel_losses(pg, reward_masks, total_tokens=total_tokens,
                                  group=group)
    if group is not None:
        metrics = {k: v if k == "kl_loss" else group_sum(v, group)
                   for k, v in metrics.items()}
    return loss, metrics

"""Advantage estimators: GRPO, ROUTER (RS-GRPO), RLOO, REINFORCE++, ReMax, GAE.

Parity with the reference src/rsgrpo/verl/trainer/core_algos.py:106-349 —
but vectorized over fixed-size groups instead of python dict loops (rollout.n
responses per prompt are contiguous after repeat-interleave, so group
statistics are reshapes). std uses ddof=1 (torch.std default) to match.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _group_stats(scores: np.ndarray, index: np.ndarray, eps: float):
    """Per-group mean/std (ddof=1) broadcast back to samples.
    scores (bs, ...) grouped by index (bs,)."""
    out_mean = np.zeros_like(scores, dtype=np.float64)
    out_std = np.zeros_like(scores, dtype=np.float64)
    for uid in np.unique(index):
        sel = index == uid
        assert sel.sum() > 1, "group advantage needs rollout.n > 1"
        out_mean[sel] = scores[sel].mean(axis=0, keepdims=True)
        out_std[sel] = scores[sel].std(axis=0, ddof=1, keepdims=True)
    return out_mean, out_std


def grpo_advantage(token_rewards: np.ndarray, response_mask: np.ndarray,
                   index: np.ndarray, eps: float = 1e-6,
                   norm_by_std: bool = True):
    """(bs, len) token rewards → (bs, len) advantages (core_algos.py:151-193)."""
    scores = token_rewards.sum(axis=-1)
    mean, std = _group_stats(scores, index, eps)
    adv = scores - mean
    if norm_by_std:
        adv = adv / (std + eps)
    returns = adv[:, None] * response_mask
    return returns.astype(np.float32), returns.astype(np.float32)


def router_advantage(reward_tensor: np.ndarray, index: np.ndarray,
                     eps: float = 1e-6):
    """(bs, n_rewards) → per-(group, channel) z-scores (core_algos.py:196-243).
    Returns (bs, n_rewards) advantages == returns."""
    mean, std = _group_stats(reward_tensor.astype(np.float64), index, eps)
    adv = (reward_tensor - mean) / (std + eps)
    return adv.astype(np.float32), adv.astype(np.float32)


def rloo_advantage(token_rewards: np.ndarray, response_mask: np.ndarray,
                   index: np.ndarray):
    """Leave-one-out baseline (core_algos.py:247-287)."""
    scores = token_rewards.sum(axis=-1).astype(np.float64)
    adv = np.zeros_like(scores)
    for uid in np.unique(index):
        sel = index == uid
        n = sel.sum()
        assert n > 1
        total = scores[sel].sum()
        adv[sel] = scores[sel] - (total - scores[sel]) / (n - 1)
    out = adv[:, None] * response_mask
    return out.astype(np.float32), out.astype(np.float32)


def reinforce_pp_advantage(token_rewards: np.ndarray,
                           response_mask: np.ndarray, gamma: float = 1.0,
                           eps: float = 1e-6):
    """Discounted returns whitened over the batch (core_algos.py:290-320)."""
    bs, ln = token_rewards.shape
    returns = np.zeros_like(token_rewards, dtype=np.float64)
    run = np.zeros((bs,), np.float64)
    for t in range(ln - 1, -1, -1):
        run = token_rewards[:, t] + gamma * run
        returns[:, t] = run
    m = response_mask.astype(bool)
    mean = returns[m].mean() if m.any() else 0.0
    std = returns[m].std(ddof=1) if m.sum() > 1 else 1.0
    adv = (returns - mean) / (std + eps) * response_mask
    return adv.astype(np.float32), returns.astype(np.float32)


def remax_advantage(token_rewards: np.ndarray, greedy_scores: np.ndarray,
                    response_mask: np.ndarray):
    """Greedy-rollout baseline (core_algos.py:323-349). greedy_scores (bs,)"""
    scores = token_rewards.sum(axis=-1) - greedy_scores
    out = scores[:, None] * response_mask
    return out.astype(np.float32), out.astype(np.float32)


def gae_advantage(token_rewards: np.ndarray, values: np.ndarray,
                  response_mask: np.ndarray, gamma: float = 1.0,
                  lam: float = 1.0, eps: float = 1e-6):
    """Standard GAE with terminal value 0 (core_algos.py:106-147), advantages
    whitened over valid tokens."""
    bs, ln = token_rewards.shape
    adv = np.zeros((bs, ln), np.float64)
    last = np.zeros((bs,), np.float64)
    next_v = np.zeros((bs,), np.float64)
    for t in range(ln - 1, -1, -1):
        delta = token_rewards[:, t] + gamma * next_v - values[:, t]
        last = delta + gamma * lam * last
        adv[:, t] = last
        next_v = values[:, t]
    returns = adv + values
    m = response_mask.astype(bool)
    mean = adv[m].mean() if m.any() else 0.0
    std = adv[m].std(ddof=1) if m.sum() > 1 else 1.0
    adv = (adv - mean) / (std + eps) * response_mask
    return adv.astype(np.float32), (returns * response_mask).astype(np.float32)


def compute_advantage(estimator: str, *, reward_tensor=None,
                      token_rewards=None, response_mask=None, index=None,
                      values=None, greedy_scores=None, gamma=1.0, lam=1.0,
                      norm_by_std=True):
    """Dispatch like ray_trainer.compute_advantage (:130-159)."""
    if estimator == "router":
        return router_advantage(reward_tensor, index)
    if estimator == "grpo":
        return grpo_advantage(token_rewards, response_mask, index,
                              norm_by_std=norm_by_std)
    if estimator == "rloo":
        return rloo_advantage(token_rewards, response_mask, index)
    if estimator == "reinforce_plus_plus":
        return reinforce_pp_advantage(token_rewards, response_mask, gamma)
    if estimator == "remax":
        return remax_advantage(token_rewards, greedy_scores, response_mask)
    if estimator == "gae":
        return gae_advantage(token_rewards, values, response_mask, gamma, lam)
    raise ValueError(f"unknown advantage estimator {estimator!r}")

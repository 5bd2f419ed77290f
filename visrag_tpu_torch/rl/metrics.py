"""Per-step RL metric families — key-compatible with the reference's
trainer/metrics.py:27-123 (the reference src/rsgrpo/verl/trainer/
metrics.py): critic/score|rewards|advantages|returns[|values] min/mean/max,
vf_explained_var, response/prompt length stats + clip ratios, timing_s/* +
timing_per_token_ms/* per phase, and perf/throughput.

Layout notes vs the reference: batches here are ONE right-padded
(prompt+response) sequence per row (the reference splits prompts/responses
into two tensors), so prompt length = attention_mask Σ − response_mask Σ.
Advantages arrive either per-channel (bs, n_rewards) (router) or per-token
(bs, 1, S); stats run over the valid (masked) entries of whichever layout
is present.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _stats(prefix: str, vals: np.ndarray) -> Dict[str, float]:
    if vals.size == 0:
        vals = np.zeros((1,), np.float32)
    return {f"{prefix}/mean": float(vals.mean()),
            f"{prefix}/max": float(vals.max()),
            f"{prefix}/min": float(vals.min())}


def compute_length_metrics(batch: Dict[str, np.ndarray],
                           max_prompt_length: int,
                           max_response_length: int) -> Dict[str, float]:
    """reference compute_length_metrics (metrics.py:27-46)."""
    response_length = batch["response_mask"].sum(1).astype(np.float64)
    prompt_length = (batch["attention_mask"].sum(1) -
                     response_length).astype(np.float64)
    return {
        "response_length/mean": float(response_length.mean()),
        "response_length/max": float(response_length.max()),
        "response_length/min": float(response_length.min()),
        "response_length/clip_ratio": float(
            (response_length >= max_response_length).mean()),
        "prompt_length/mean": float(prompt_length.mean()),
        "prompt_length/max": float(prompt_length.max()),
        "prompt_length/min": float(prompt_length.min()),
        "prompt_length/clip_ratio": float(
            (prompt_length >= max_prompt_length).mean()),
    }


def compute_data_metrics(batch: Dict[str, np.ndarray],
                         max_prompt_length: int, max_response_length: int,
                         token_rewards: Optional[np.ndarray] = None
                         ) -> Dict[str, float]:
    """reference compute_data_metrics (metrics.py:49-116). token_rewards:
    (bs, S) post-KL token scores when a reward-side KL penalty ran
    (token_level_rewards); falls back to the raw channel sums
    (score == rewards, the reference's no-penalty case)."""
    score = batch["reward_tensor"].sum(-1).astype(np.float64)
    rewards = (token_rewards.sum(-1).astype(np.float64)
               if token_rewards is not None else score)
    out = {}
    out.update(_stats("critic/score", score))
    out.update(_stats("critic/rewards", rewards))

    adv = batch["advantages"]
    if adv.ndim == 3:                       # (bs, nch, S) token layout
        m = batch["reward_masks"].astype(bool)
        out.update(_stats("critic/advantages", adv[m]))
    else:                                   # (bs, n_rewards) router layout
        out.update(_stats("critic/advantages", adv))

    resp_m = batch["response_mask"].astype(bool)
    if "returns" in batch:
        # returns/values live in logp space (position t scores token t+1);
        # select with the same shifted mask the updates use
        m = np.roll(resp_m, -1, axis=1)
        returns = batch["returns"][m].astype(np.float64)
        out.update(_stats("critic/returns", returns))
        if "values" in batch:
            values = batch["values"][m].astype(np.float64)
            out.update(_stats("critic/values", values))
            rv = float(np.var(returns - values)) if returns.size else 0.0
            var_r = float(np.var(returns)) if returns.size else 0.0
            out["critic/vf_explained_var"] = 1.0 - rv / (var_r + 1e-5)
    elif adv.ndim == 3:
        # token-level estimators: returns == advantages (advantage.py)
        out.update(_stats("critic/returns",
                          adv[batch["reward_masks"].astype(bool)]))
    else:
        out.update(_stats("critic/returns", adv))
    out.update(compute_length_metrics(batch, max_prompt_length,
                                      max_response_length))
    return out


# reference metrics.py:100-113: which token count a phase amortizes over
_RESPONSE_PHASES = ("gen", "reward")
_OVERALL_PHASES = ("ref", "old", "values", "adv", "update_critic",
                   "update_actor")


def compute_timing_metrics(timing_raw: Dict[str, float],
                           num_response_tokens: int,
                           num_overall_tokens: int) -> Dict[str, float]:
    out = {f"timing_s/{k}": v for k, v in timing_raw.items()}
    per = {**dict.fromkeys(_RESPONSE_PHASES, num_response_tokens),
           **dict.fromkeys(_OVERALL_PHASES, num_overall_tokens)}
    for name, tokens in per.items():
        if name in timing_raw and tokens:
            out[f"timing_per_token_ms/{name}"] = \
                timing_raw[name] * 1000.0 / tokens
    return out


def compute_throughput_metrics(num_overall_tokens: int, step_time: float,
                               num_chips: int) -> Dict[str, float]:
    """reference compute_throughout_metrics (metrics.py:116-123):
    perf/throughput is tokens per second per chip."""
    return {
        "perf/total_num_tokens": float(num_overall_tokens),
        "perf/time_per_step": step_time,
        "perf/throughput": num_overall_tokens / (step_time *
                                                 max(num_chips, 1)),
    }

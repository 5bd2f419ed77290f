"""RS-GRPO reward channels + token-span reward scoping.

Parity with the reference reward stack:
  * the six channels and their math —
    the reference src/rsgrpo/examples/reward_function/evidencecot.py:77-290:
    accuracy (answer-tag F1), evidence (per-image-slot weighted EM/F1, weight
    3 for real evidence / 1 for "no relevant information"), format (strict
    observe→evidence→think→answer structure), overlong (soft length
    punishment), isObserve / isThink (-1 punishments), with the sum_all
    weighting {3·acc, 3·evid, 1, 1, 1, 1};
  * per-channel token-span scopes delimited by tag subsequences —
    verl/workers/reward/function.py:110-208: accuracy: <think>→end;
    evidence: start→<think>; format/overlong: full; isObserve:
    start→<evidence>; isThink: <think>→<answer>; a missing start tag scopes
    from 0, a missing end tag to seq_len.

The reference's per-sample Python subsequence loop (function.py:134-142) is
replaced by a vectorized numpy sliding-window match over the whole batch.
"""

from __future__ import annotations

import re
import string
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

REWARD_CHANNELS = ("accuracy", "evidence", "format", "overlong", "isObserve",
                   "isThink")

# channel → (start_tag, end_tag); None = start/end of response
CHANNEL_SPANS: Dict[str, Tuple[Optional[str], Optional[str]]] = {
    "accuracy": ("<think>", None),
    "evidence": (None, "<think>"),
    "format": (None, None),
    "overlong": (None, None),
    "isObserve": (None, "<evidence>"),
    "isThink": ("<think>", "<answer>"),
}


# --- text metrics -----------------------------------------------------------


def _normalize(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.strip().split())


def f1_match(response: str, ground_truth: str) -> float:
    """Token-SET F1 (not multiset) — evidencecot.py:89-105 builds set(pred) /
    set(gt) and counts tp/fp/fn on the sets, so repeated tokens count once."""
    pred = set(_normalize(response).split())
    gold = set(_normalize(ground_truth).split())
    tp = len(pred & gold)
    fp = len(pred - gold)
    fn = len(gold - pred)
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def em_match(response: str, ground_truth: str) -> float:
    """Substring containment, not equality — evidencecot.py:107-111 scores 1.0
    when the normalized ground truth appears anywhere in the normalized
    response."""
    return float(_normalize(ground_truth) in _normalize(response))


def _tag_body(text: str, tag: str) -> Optional[str]:
    if f"<{tag}>" not in text or f"</{tag}>" not in text:
        return None
    return text.split(f"<{tag}>")[1].split(f"</{tag}>")[0]


# --- reward channels --------------------------------------------------------


def accuracy_reward(response: str, ground_truth: str) -> float:
    pa = _tag_body(response, "answer")
    if pa is None:
        return 0.0
    ga = _tag_body(ground_truth, "answer")
    if ga is None:
        # Deviation: the reference (evidencecot.py:117) raises IndexError on a
        # ground truth without <answer> tags; we fall back to the raw string.
        ga = ground_truth
    return f1_match(_normalize(pa), _normalize(ga))


def evidence_reward(response: str, ground_truth: str, max_images: int = 6) -> float:
    obs = _tag_body(response, "evidence")
    if obs is None:
        return 0.0
    gt_obs = _tag_body(ground_truth, "evidence") or ""
    score = 0.0
    full = 0.0
    for i in range(max_images):
        if f"[{i + 1}]:" not in gt_obs:
            if full > 0.0:
                score /= full
            break
        gold = gt_obs.split(f"[{i + 1}]:")[1].split(f"[{i + 2}]")[0].strip()
        weight = 3.0 if gold != "no relevant information" else 1.0
        full += weight
        if f"[{i + 1}]:" not in obs:
            continue
        gen = obs.split(f"[{i + 1}]:")[1].split(f"[{i + 2}]")[0].strip()
        match = f1_match(gen, gold) if len(gold.split()) >= 5 else em_match(gen, gold)
        score += match * weight
    return score


_FORMAT_RE = re.compile(
    r"<observe>.*?</observe>\s*<evidence>.*?</evidence>\s*<think>.*?</think>"
    r"\s*<answer>.*?</answer>", re.DOTALL)


def format_reward(response: str) -> float:
    if not _FORMAT_RE.fullmatch(response):
        return 0.0
    for tag in ("observe", "evidence", "think", "answer"):
        if response.count(f"<{tag}>") != 1 or response.count(f"</{tag}>") != 1:
            return 0.0
    return 1.0


def overlong_punishment(response_length: int, max_response_length: int = 1536,
                        overlong_buffer: int = 512,
                        min_response_length: int = 200) -> float:
    if response_length < min_response_length:
        return -1.0
    expected = max_response_length - overlong_buffer
    if response_length <= expected:
        return 0.0
    if response_length <= max_response_length:
        return (expected - response_length) / overlong_buffer
    return -1.0


def is_observe_punishment(response: str, max_images: int = 5) -> float:
    obs = _tag_body(response, "observe")
    if obs is None:
        return 0.0
    for i in range(max_images):
        if f"[{i + 1}]" in obs:
            return -1.0
    return 0.0


def is_think_punishment(response: str) -> float:
    think = _tag_body(response, "think")
    answer = _tag_body(response, "answer")
    if think is None or answer is None:
        return 0.0
    return -1.0 if think == answer else 0.0


def score_response(response: str, ground_truth: str, response_length: int,
                   *, max_response_length: int = 1536,
                   overlong_buffer: int = 512,
                   min_response_length: int = 200) -> Dict[str, float]:
    """sum_all weighting (evidencecot.py:255-290)."""
    acc = accuracy_reward(response, ground_truth)
    evid = evidence_reward(response, ground_truth)
    fmt = format_reward(response)
    over = overlong_punishment(response_length, max_response_length,
                               overlong_buffer, min_response_length)
    iso = is_observe_punishment(response)
    ist = is_think_punishment(response)
    return {"overall": 3 * acc + 3 * evid + over + fmt + iso + ist,
            "accuracy": 3 * acc, "evidence": 3 * evid, "format": fmt,
            "overlong": over, "isObserve": iso, "isThink": ist}


# --- token-span scoping -----------------------------------------------------


def find_first_subsequence(row: np.ndarray, sub: np.ndarray) -> int:
    """First index where `sub` occurs in `row`, -1 if absent. Vectorized
    sliding-window compare (replaces the O(n·m) python loop,
    function.py:134-142)."""
    n, m = len(row), len(sub)
    if m == 0 or m > n:
        return -1
    windows = np.lib.stride_tricks.sliding_window_view(row, m)
    hits = np.nonzero((windows == sub).all(axis=1))[0]
    return int(hits[0]) if len(hits) else -1


def build_reward_masks(response_ids: np.ndarray, response_mask: np.ndarray,
                       tag_token_ids: Dict[str, Sequence[int]],
                       channels: Sequence[str] = REWARD_CHANNELS,
                       spans: Optional[Dict[str, Tuple[Optional[str],
                                                       Optional[str]]]] = None
                       ) -> np.ndarray:
    """(bs, len) response ids → (bs, n_channels, len) scoped masks.

    tag_token_ids: tag string ("<think>" etc.) → token-id subsequence (the
    tokenizer's encode of the tag, reference function.py:162-180).
    spans: channel → (start_tag|None, end_tag|None); defaults to the
    evidencecot CHANNEL_SPANS (custom reward modules supply their own via
    rl.reward_manager.RewardManager.spans).
    """
    if spans is None:
        spans = CHANNEL_SPANS
    bs, seq_len = response_ids.shape
    out = np.repeat(response_mask[:, None, :], len(channels), axis=1).astype(np.int32)
    pos = np.arange(seq_len)
    for b in range(bs):
        row = response_ids[b]
        for ci, ch in enumerate(channels):
            start_tag, end_tag = spans[ch]
            if start_tag is not None:
                sub = np.asarray(tag_token_ids[start_tag])
                idx = find_first_subsequence(row, sub)
                if idx == -1:
                    idx = 0
                out[b, ci] &= (pos >= idx)
            if end_tag is not None:
                sub = np.asarray(tag_token_ids[end_tag])
                idx = find_first_subsequence(row, sub)
                if idx == -1:
                    idx = seq_len
                out[b, ci] &= (pos < idx)
    return out


def compute_rewards(responses: Sequence[str], ground_truths: Sequence[str],
                    response_lengths: Sequence[int],
                    **overlong_kw) -> Tuple[np.ndarray, Dict[str, List[float]]]:
    """→ reward_tensor (bs, n_channels) + per-channel metric lists."""
    rows = []
    metrics: Dict[str, List[float]] = {k: [] for k in
                                       REWARD_CHANNELS + ("overall",)}
    for resp, gt, rl in zip(responses, ground_truths, response_lengths):
        s = score_response(resp, gt, rl, **overlong_kw)
        rows.append([s[c] for c in REWARD_CHANNELS])
        for k in metrics:
            metrics[k].append(s[k])
    return np.asarray(rows, np.float32), metrics

"""Pluggable reward manager: importlib-loaded user reward functions.

Parity with the reference's reward-manager construction
(the reference src/rsgrpo/verl/workers/reward/function.py):

  * FunctionRewardManager.__init__ (:47-72) — `reward_function` names a
    user-supplied `path.py`, loaded via importlib.util.spec_from_file_location
    with loud errors: FileNotFoundError on a missing file, RuntimeError when
    exec fails, AttributeError when `reward_function_name` is absent; the fn
    is partial-bound with `reward_function_kwargs`.
  * RewardConfig.post_init (:34-43 of reward/config.py) — a trailing
    ":name" on the path selects the function, default "main".
  * SequentialFunctionRewardManager (:80-105) — fn(RewardInput) →
    {"overall": float, ...}; the scalar lands at the last response token.
    Here the scalar becomes one "overall" channel scoped over the whole
    response — equivalent once the estimators broadcast the per-sequence
    advantage over response tokens (what verl's GRPO does with the
    last-token scalar).
  * BatchFunctionRewardManager (:108-208) — fn(list[RewardInput]) →
    list[score dict]; per-channel token spans. The reference hardcodes the
    six evidencecot channels in the manager; here the loaded module may
    export REWARD_CHANNELS / CHANNEL_SPANS to declare its own, defaulting
    to the evidencecot set.

The in-tree evidencecot scorer (rl/rewards.py) remains the default when
`reward_function` is None.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import RewardConfig
from .rewards import CHANNEL_SPANS, REWARD_CHANNELS, compute_rewards


def load_reward_function(path: str, name: Optional[str] = None,
                         kwargs: Optional[dict] = None) -> Callable:
    """importlib-load `name` from the file at `path` (function.py:52-68).

    `path` may carry a ":name" suffix (reward/config.py post_init :34-43);
    an explicit `name` wins. Errors are loud and typed like the reference:
    FileNotFoundError / RuntimeError (exec failure) / AttributeError.
    """
    if ":" in os.path.basename(path):
        path, _, suffix = path.rpartition(":")
        if name is None:
            name = suffix
    if name is None:
        name = "main"
    if not os.path.exists(path):
        raise FileNotFoundError(f"Reward function file {path} not found.")
    spec = importlib.util.spec_from_file_location("custom_reward_fn", path)
    module = importlib.util.module_from_spec(spec)
    try:
        sys.modules["custom_reward_fn"] = module
        spec.loader.exec_module(module)
    except Exception as e:
        raise RuntimeError(f"Failed to load reward function: {e}") from e
    if not hasattr(module, name):
        raise AttributeError(
            f"Module {path} does not have function {name}.")
    fn = getattr(module, name)
    if kwargs:
        fn = partial(fn, **kwargs)
    return fn, module


class RewardManager:
    """One object the trainer consults for scoring + channel layout.

    Attributes:
      channels: tuple of channel names — sets n_rewards everywhere
        (reward_tensor (bs, n_ch), reward_masks (bs, n_ch, S)).
      spans: channel → (start_tag|None, end_tag|None) token-span scopes
        (function.py:110-132's reward_mask_tokens table).
      required_tags: every tag string the spans mention — callers must
        provide tokenizer encodings of exactly these (trainer
        tag_token_ids).
    """

    def __init__(self, cfg: Optional[RewardConfig] = None, *,
                 max_response_length: int = 1536):
        self.cfg = cfg or RewardConfig()
        self.max_response_length = max_response_length
        self._fn = None
        if self.cfg.reward_function is not None:
            self._fn, module = load_reward_function(
                self.cfg.reward_function, self.cfg.reward_function_name,
                dict(self.cfg.reward_function_kwargs or {}))
            if self.cfg.reward_type == "sequential":
                self.channels: Tuple[str, ...] = ("overall",)
                self.spans: Dict[str, tuple] = {"overall": (None, None)}
            elif self.cfg.reward_type == "batch":
                self.channels = tuple(getattr(module, "REWARD_CHANNELS",
                                              REWARD_CHANNELS))
                self.spans = dict(getattr(module, "CHANNEL_SPANS",
                                          CHANNEL_SPANS))
                missing = [c for c in self.channels if c not in self.spans]
                if missing:
                    raise ValueError(
                        f"reward module {self.cfg.reward_function} declares "
                        f"channels {missing} without CHANNEL_SPANS entries")
            else:
                raise ValueError(
                    f"reward_type must be 'batch' or 'sequential', got "
                    f"{self.cfg.reward_type!r}")
        else:
            if self.cfg.reward_type not in ("batch", "sequential"):
                raise ValueError(
                    f"reward_type must be 'batch' or 'sequential', got "
                    f"{self.cfg.reward_type!r}")
            # in-tree evidencecot default (a batch-type manager)
            self.channels = REWARD_CHANNELS
            self.spans = dict(CHANNEL_SPANS)

    @property
    def required_tags(self) -> set:
        return {t for pair in (self.spans[c] for c in self.channels)
                for t in pair if t is not None}

    def compute(self, responses: Sequence[str],
                ground_truths: Sequence[str],
                response_lengths: Sequence[int]
                ) -> Tuple[np.ndarray, Dict[str, List[float]]]:
        """→ reward_tensor (bs, n_channels) float32 + metric lists."""
        if self._fn is None:
            return compute_rewards(
                responses, ground_truths, response_lengths,
                max_response_length=self.max_response_length)
        inputs = [{"response": r, "response_length": int(n),
                   "ground_truth": g}
                  for r, g, n in zip(responses, ground_truths,
                                     response_lengths)]
        if self.cfg.reward_type == "sequential":
            scores = [self._fn(inp) for inp in inputs]
        else:
            scores = self._fn(inputs)
            if len(scores) != len(inputs):
                raise ValueError(
                    f"batch reward function returned {len(scores)} scores "
                    f"for {len(inputs)} inputs")
        keys = ("overall",) if self.cfg.reward_type == "sequential" \
            else self.channels
        rows = []
        metrics: Dict[str, List[float]] = {}
        for s in scores:
            try:
                rows.append([float(s[k]) for k in keys])
            except KeyError as e:
                raise KeyError(
                    f"reward function score dict missing channel {e} "
                    f"(expected keys {list(keys)}; got {sorted(s)})") from e
            for k, v in s.items():
                metrics.setdefault(k, []).append(float(v))
        return np.asarray(rows, np.float32), metrics

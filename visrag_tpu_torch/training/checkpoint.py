"""Checkpoint save/load, the tracker manifest and retention GC.

Counterpart of visrag_tpu/training/checkpoint.py with torch.save in place
of orbax and the same layout:

  root/global_step_N/<name>.pt       one file per entry of the saved tree
                                     (the trainer saves "model" and
                                     "optimizer" state dicts)
  root/global_step_N/extra_state.json  small host state (step, data cursor)
  root/checkpoint_tracker.json       {last_step, best_step, best_metric}

and keep-(newest + best) retention. Loading maps every tensor to the CPU
through mmap, so a resume copies into the live model and optimizer without
a second copy on the device.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(root, f"global_step_{step}")


def save_checkpoint(root: str, step: int, tree: Dict[str, Any], *,
                    extra: Optional[dict] = None,
                    best_metric: Optional[float] = None,
                    save_limit: Optional[int] = None) -> str:
    """Save {name: object} at `root/global_step_{step}/<name>.pt`.

    extra: small JSON-serializable host state (data position, step).
    Updates checkpoint_tracker.json and applies keep-(best + newest)
    retention."""
    path = _ckpt_dir(root, step)
    os.makedirs(path, exist_ok=True)
    for name, obj in tree.items():
        tmp = os.path.join(path, f"{name}.pt.tmp")
        torch.save(obj, tmp)
        os.replace(tmp, os.path.join(path, f"{name}.pt"))
    if extra is not None:
        with open(os.path.join(path, "extra_state.json"), "w") as f:
            json.dump(extra, f)

    tracker_path = os.path.join(root, "checkpoint_tracker.json")
    tracker = {}
    if os.path.exists(tracker_path):
        with open(tracker_path) as f:
            tracker = json.load(f)
    tracker["last_step"] = step
    if best_metric is not None:
        if best_metric >= tracker.get("best_metric", -math.inf):
            tracker["best_metric"] = best_metric
            tracker["best_step"] = step
    with open(tracker_path, "w") as f:
        json.dump(tracker, f)

    if save_limit is not None:
        gc_checkpoints(root, save_limit)
    return path


def find_latest_ckpt(root: str) -> Optional[str]:
    """The newest checkpoint the tracker names, if it still exists."""
    tracker_path = os.path.join(root, "checkpoint_tracker.json")
    if not os.path.exists(tracker_path):
        return None
    with open(tracker_path) as f:
        tracker = json.load(f)
    step = tracker.get("last_step")
    if step is None:
        return None
    path = _ckpt_dir(root, step)
    return path if os.path.exists(path) else None


def gc_checkpoints(root: str, save_limit: int) -> None:
    """Keep the newest `save_limit` checkpoints, never deleting best_step."""
    tracker_path = os.path.join(root, "checkpoint_tracker.json")
    best = None
    if os.path.exists(tracker_path):
        with open(tracker_path) as f:
            best = json.load(f).get("best_step")
    steps = []
    for name in os.listdir(root):
        m = re.fullmatch(r"global_step_(\d+)", name)
        if m:
            steps.append(int(m.group(1)))
    steps.sort(reverse=True)
    for step in steps[save_limit:]:
        if step == best:
            continue
        shutil.rmtree(_ckpt_dir(root, step), ignore_errors=True)


def load_checkpoint(path: str):
    """→ ({name: object}, extra or None); tensors on the CPU (mmap)."""
    tree = {f.name[:-len(".pt")]: torch.load(f, map_location="cpu",
                                             mmap=True, weights_only=True)
            for f in sorted(Path(path).glob("*.pt"))}
    extra = None
    epath = os.path.join(path, "extra_state.json")
    if os.path.exists(epath):
        with open(epath) as f:
            extra = json.load(f)
    return tree, extra

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

A trainer sharded by FSDP2 saves the same files: `full_tensors` gathers
each sharded tensor (a collective every rank joins) and rank 0 writes;
`load_full_into` copies this rank's piece of a full tensor into a sharded
one. So one process and any number of ranks load each other's
checkpoints to the same tensors.
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
from torch.distributed.tensor import DTensor


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


def full_tensors(tree):
    """tree with every DTensor gathered to a full CPU tensor (a collective:
    every rank of its mesh calls it) and plain tensors moved to the CPU;
    dicts and lists are walked."""
    if isinstance(tree, dict):
        return {k: full_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_tensors(v) for v in tree)
    if isinstance(tree, DTensor):
        return tree.full_tensor().cpu()
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def load_full_into(dst: torch.Tensor, full: torch.Tensor) -> None:
    """Copy `full` into dst in place; a sharded dst (DTensor) takes only
    this rank's piece, chunked as DTensor's Shard placements chunk."""
    if not isinstance(dst, DTensor):
        dst.copy_(full)
        return
    piece = full
    mesh = dst.device_mesh
    for dim, placement in enumerate(dst.placements):
        if placement.is_shard():
            n, i = mesh.size(dim), mesh.get_local_rank(dim)
            chunks = torch.chunk(piece, n, dim=placement.dim)
            piece = chunks[i] if i < len(chunks) else \
                piece.narrow(placement.dim, 0, 0)
    dst.to_local().copy_(piece)


def load_state_into(module: torch.nn.Module, state: Dict[str, Any]) -> None:
    """module.load_state_dict(state) for a module whose tensors may be
    sharded: the keys must match; each tensor takes its piece."""
    own = module.state_dict()
    if set(own) != set(state):
        missing, extra = set(own) - set(state), set(state) - set(own)
        raise KeyError(f"state keys differ: missing {sorted(missing)[:5]}, "
                       f"unexpected {sorted(extra)[:5]}")
    with torch.no_grad():
        for name, t in own.items():
            load_full_into(t, state[name])

"""Batched embedding inference loop.

Counterpart of visrag_tpu/retrieval/encode.py (make_encode_step,
prefetch, EmbeddingWriter, encode_dataset): host preprocessing of batch
n+1 runs in a worker thread while the GPU encodes batch n, the first
batch is checked for NaNs, and embeddings can spill to .npy/.json shards
for corpora larger than host RAM. Across ranks, each rank encodes its
block of every batch and the representations come back in the global
order on every rank.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, \
    Tuple

import numpy as np
import torch


def make_encode_step(model_apply: Callable[..., torch.Tensor], mesh=None):
    """The data-parallel encode step. Without a mesh: model_apply itself.
    With one: step(**batch) encodes this rank's block of the global batch
    (the caller builds it from mesh.local_slice of the batch's rows) and
    all-gathers the (rows, D) representations over (replica, data), so
    that every rank returns the global batch's in the global order, as one
    process would."""
    if mesh is None:
        return model_apply
    from ..mesh import BATCH_AXES, all_gather_rows, axis_group
    group = axis_group(mesh, *BATCH_AXES)

    def step(**batch):
        return all_gather_rows(model_apply(**batch).float(), group)

    return step


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run `iterator` in a worker thread, `depth` items ahead of the
    consumer; an exception in the worker is raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # handed to the consumer, raised there
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


class EmbeddingWriter:
    """Collects (ids, reps); with an output_dir, spills a .npy/.ids.json
    shard every max_inmem_docs documents."""

    def __init__(self, output_dir: Optional[str] = None,
                 prefix: str = "embeddings.corpus",
                 max_inmem_docs: int = 10_000_000):
        self.output_dir = output_dir
        self.prefix = prefix
        self.max_inmem = max_inmem_docs
        self.ids: List[str] = []
        self.reps: List[np.ndarray] = []
        self._count = 0
        self._shards: List[str] = []

    def add(self, ids: Sequence[str], reps: np.ndarray):
        self.ids.extend(ids)
        self.reps.append(reps)
        self._count += len(ids)
        if self.output_dir and self._count >= self.max_inmem:
            self.flush()

    def flush(self):
        if not self.output_dir or not self.ids:
            return
        os.makedirs(self.output_dir, exist_ok=True)
        base = os.path.join(self.output_dir,
                            f"{self.prefix}.{len(self._shards)}")
        np.save(base + ".npy", np.concatenate(self.reps, axis=0))
        with open(base + ".ids.json", "w") as f:
            json.dump(self.ids, f)
        self._shards.append(base)
        self.ids, self.reps, self._count = [], [], 0

    def result(self) -> Tuple[List[str], np.ndarray]:
        if self._shards:
            self.flush()
            ids, reps = [], []
            for base in self._shards:
                reps.append(np.load(base + ".npy"))
                with open(base + ".ids.json") as f:
                    ids.extend(json.load(f))
            return ids, np.concatenate(reps, axis=0)
        reps = (np.concatenate(self.reps, axis=0) if self.reps
                else np.zeros((0, 0), np.float32))
        return self.ids, reps


def encode_dataset(step: Callable[..., torch.Tensor],
                   batches: Iterable[Tuple[Sequence[str], dict]],
                   writer: Optional[EmbeddingWriter] = None,
                   prefetch_depth: int = 2) -> Tuple[List[str], np.ndarray]:
    """`batches` yields (ids, batch) with step(**batch) → (B, D) tensor.
    Batches may be padded on dim 0: ids mark the valid prefix. Raises
    FloatingPointError if the first batch gives a NaN."""
    writer = writer or EmbeddingWriter()
    first = True
    for ids, batch in prefetch(iter(batches), prefetch_depth):
        reps = step(**batch)
        reps = reps.float().cpu().numpy()[:len(ids)]
        if first:
            if np.isnan(reps).any():
                raise FloatingPointError("NaN embeddings in first batch")
            first = False
        writer.add(ids, reps)
    return writer.result()

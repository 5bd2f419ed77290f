"""Sequence-length balancing and token-budget micro-batching.

Role parity with the reference src/rsgrpo/verl/utils/seqlen_balancing.py
(Karmarkar–Karp partitions :100-186, token-budget dynamic micro-batching +
inverse permutation :295-330) and the trainer's cross-dp-rank reorder
(ray_trainer.py:450-465). The equal-size partition uses capacity-constrained
LPT (longest-processing-time) which matches KK's balance quality for the
equal-cardinality case the trainer needs, in O(n log k).
"""

from __future__ import annotations

import heapq
from typing import List, Sequence, Tuple

import numpy as np


def balanced_partitions(seqlens: Sequence[int], k: int,
                        equal_size: bool = True) -> List[List[int]]:
    """Partition indices into k groups minimizing the max token sum.
    equal_size: every group gets exactly len(seqlens)/k items (required when
    groups map to dp shards)."""
    n = len(seqlens)
    if equal_size and n % k != 0:
        raise ValueError(f"{n} items not divisible into {k} equal groups")
    cap = n // k if equal_size else n
    order = np.argsort(-np.asarray(seqlens), kind="stable")
    heap = [(0, 0, i) for i in range(k)]  # (load, count, partition)
    heapq.heapify(heap)
    groups: List[List[int]] = [[] for _ in range(k)]
    deferred = []
    for idx in order:
        while True:
            load, count, p = heapq.heappop(heap)
            if count < cap:
                break
            deferred.append((load, count, p))
        for d in deferred:
            heapq.heappush(heap, d)
        deferred = []
        groups[p].append(int(idx))
        heapq.heappush(heap, (load + int(seqlens[idx]), count + 1, p))
    return groups


def balance_metrics(seqlens: Sequence[int], groups: List[List[int]]) -> dict:
    """log_seqlen_unbalance equivalent (seqlen_balancing.py:188)."""
    sums = [sum(seqlens[i] for i in g) for g in groups]
    return {"max": max(sums), "min": min(sums),
            "imbalance": max(sums) / max(1, min(sums))}


def token_budget_micro_batches(seqlens: Sequence[int], max_tokens: int
                               ) -> Tuple[List[List[int]], List[int]]:
    """Greedy first-fit-decreasing grouping under a token budget
    (prepare_dynamic_batch role). Returns (groups, restore_permutation) where
    concat(groups) reordered by restore gives original order."""
    order = np.argsort(-np.asarray(seqlens), kind="stable")
    groups: List[List[int]] = []
    sums: List[int] = []
    for idx in order:
        ln = int(seqlens[idx])
        placed = False
        for gi in range(len(groups)):
            if sums[gi] + ln <= max_tokens:
                groups[gi].append(int(idx))
                sums[gi] += ln
                placed = True
                break
        if not placed:
            groups.append([int(idx)])
            sums.append(ln)
    flat = [i for g in groups for i in g]
    restore = np.argsort(flat, kind="stable").tolist()
    return groups, restore


def reorder_for_dp(seqlens: Sequence[int], dp_size: int) -> np.ndarray:
    """Batch permutation so contiguous dp shards have balanced token counts
    (ray_trainer._balance_batch :450-465). Returns index array; apply to the
    batch before sharding dim 0 over the data axis."""
    groups = balanced_partitions(seqlens, dp_size, equal_size=True)
    return np.asarray([i for g in groups for i in g])

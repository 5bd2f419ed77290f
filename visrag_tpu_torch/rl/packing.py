"""Sequence packing: padding-free training batches with segment ids.

The reference's padding-free path unpads to (1, total_nnz) and calls
flash-attn varlen with cu_seqlens (dp_actor.py:89-141,
flash_attention_utils.py:103-123). Here, as in the JAX package, sequences
are packed back-to-back into fixed-width rows with SEGMENT IDS, and the
segment kernel (ops/attention.py, K4) enforces the same block-diagonal
visibility. Positions restart per sequence. A copy of
visrag_tpu/rl/packing.py, which imports no JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class PackedBatch:
    input_ids: np.ndarray     # (rows, width)
    segment_ids: np.ndarray   # (rows, width); 0 = padding
    positions: np.ndarray     # (rows, width) per-sequence positions
    # location of sequence i: (row, start, length)
    layout: List[Tuple[int, int, int]]


def pack_sequences(seqs: Sequence[np.ndarray], width: int,
                   extra: Dict[str, Sequence[np.ndarray]] = None
                   ) -> Tuple[PackedBatch, Dict[str, np.ndarray]]:
    """First-fit-decreasing packing of 1-D token arrays into (rows, width).

    extra: named per-sequence 1-D arrays packed with the same layout
    (e.g. response masks, per-token rewards)."""
    order = np.argsort([-len(s) for s in seqs], kind="stable")
    rows: List[int] = []            # used width per row
    layout: List[Tuple[int, int, int]] = [None] * len(seqs)
    for idx in order:
        n = len(seqs[idx])
        if n > width:
            raise ValueError(f"sequence {n} longer than pack width {width}")
        for r in range(len(rows)):
            if rows[r] + n <= width:
                layout[idx] = (r, rows[r], n)
                rows[r] += n
                break
        else:
            layout[idx] = (len(rows), 0, n)
            rows.append(n)

    nrows = len(rows)
    ids = np.zeros((nrows, width), np.int32)
    seg = np.zeros((nrows, width), np.int32)
    pos = np.zeros((nrows, width), np.int32)
    extra = extra or {}
    packed_extra = {k: np.zeros((nrows, width), np.asarray(v[0]).dtype)
                    for k, v in extra.items()}
    for i, s in enumerate(seqs):
        r, st, n = layout[i]
        ids[r, st:st + n] = s
        seg[r, st:st + n] = i + 1
        pos[r, st:st + n] = np.arange(n)
        for k, v in extra.items():
            packed_extra[k][r, st:st + n] = v[i]
    return PackedBatch(ids, seg, pos, layout), packed_extra


def unpack(values: np.ndarray, layout: Sequence[Tuple[int, int, int]]
           ) -> List[np.ndarray]:
    """(rows, width, ...) packed values → per-sequence arrays."""
    return [values[r, st:st + n] for (r, st, n) in layout]

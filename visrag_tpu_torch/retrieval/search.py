"""Exact dense top-k retrieval on one GPU.

Counterpart of visrag_tpu/retrieval/search.py (topk_single,
StreamingSearcher, build_run): fp32 Q·Cᵀ on the device plus torch.topk,
and a corpus streamed in chunks whose running top-k is merged on the host.
The int8 corpus, the multi-device sharded top-k and self_retrieve are not
ported yet.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch


def topk_single(queries, corpus, k: int):
    """(Q, D), (C, D) tensors → (scores (Q, k) fp32, indices (Q, k))."""
    scores = queries.float() @ corpus.float().T
    return torch.topk(scores, k, dim=1)


class StreamingSearcher:
    """Exact top-k over a corpus that arrives in chunks (device-memory
    bounded): each chunk is scored on `device`, its top-k merged on the
    host with the running best."""

    def __init__(self, k: int, device="cuda"):
        self.k = k
        self.device = torch.device(device)

    def search(self, queries: np.ndarray,
               corpus_chunks: Iterable[Tuple[np.ndarray, int]]):
        """corpus_chunks yields (chunk (n, D), base index). → (scores (Q, k),
        global indices (Q, k)) numpy; slots past the corpus size score -inf."""
        q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        best_s = best_i = None
        for chunk, base in corpus_chunks:
            c = torch.as_tensor(np.asarray(chunk, np.float32),
                                device=self.device)
            s, i = topk_single(q, c, min(self.k, c.shape[0]))
            s, i = s.cpu().numpy(), i.cpu().numpy() + base
            if s.shape[1] < self.k:
                pad = self.k - s.shape[1]
                s = np.pad(s, ((0, 0), (0, pad)), constant_values=-np.inf)
                i = np.pad(i, ((0, 0), (0, pad)))
            if best_s is None:
                best_s, best_i = s, i
                continue
            cat_s = np.concatenate([best_s, s], axis=1)
            cat_i = np.concatenate([best_i, i], axis=1)
            order = np.argsort(-cat_s, axis=1, kind="stable")[:, :self.k]
            best_s = np.take_along_axis(cat_s, order, axis=1)
            best_i = np.take_along_axis(cat_i, order, axis=1)
        return best_s, best_i


def build_run(scores: np.ndarray, indices: np.ndarray, query_ids: List[str],
              doc_ids: List[str]) -> dict:
    """(Q, k) arrays → TREC-style run {qid: {docid: score}}; non-finite
    (padding) slots are dropped."""
    run: dict = {}
    for qi, qid in enumerate(query_ids):
        run[qid] = {doc_ids[int(di)]: float(s)
                    for s, di in zip(scores[qi], indices[qi])
                    if np.isfinite(s)}
    return run

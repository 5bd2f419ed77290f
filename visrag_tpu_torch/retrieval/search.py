"""Exact dense top-k retrieval on one GPU, over an fp32 or an int8 corpus.

Counterpart of visrag_tpu/retrieval/search.py (topk_single,
quantize_rows, topk_single_int8, quantize_rows_np, StreamingSearcher,
self_retrieve, build_run): the scores of a query batch against the corpus
on the device, their top-k, and a corpus streamed in chunks whose running
top-k is merged on the host. The multi-device sharded top-k is not ported
(one card).

The int8 corpus halves the bytes of a resident corpus against bf16 (a
quarter of fp32), and the scan is bound by those bytes. Codes and scales
are the JAX package's bit for bit: per row, scale = where(amax > 0, amax,
1) / 127 (a zero row gets 1/127 and codes 0, unlike ops/quant's
activation scale), codes = clip(round_half_even(x / scale), ±127). The
product is an exact int32 sum: K6 (ops/matmul_int8.int8_matmul_fused) on
the card, its plain version on the CPU, both computing float(acc) · qs ·
cs in the JAX operation order, so the scores are the JAX scores bit for
bit (an fp32 product of the codes is not exact past 2^24, and 127² · 2304
is past it).

Ties go to the lower corpus index, as jax.lax.top_k gives them;
torch.topk on the card promises no order among equal scores, so
`topk_lower_index` settles the scores equal to each row's k-th one
without sorting the whole row.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch

QUANTS = ("none", "int8")


def topk_lower_index(scores, k: int):
    """torch.topk of each row of scores (Q, C), ties broken to the lower
    column index, as jax.lax.top_k breaks them. → (values (Q, k), indices
    (Q, k) int64), values descending.

    Every score above a row's k-th value is in its top-k whatever the
    order; only scores equal to the k-th value compete for the last
    places. Those rows alone are settled over the columns equal to it
    (lowest indices first), and the k winners are ordered by (value
    descending, index ascending)."""
    vals, idx = torch.topk(scores, k, dim=1)
    if k == 0:
        return vals, idx
    kth = vals[:, -1:]
    n_eq = (scores == kth).sum(dim=1)
    inside = (vals == kth).sum(dim=1)
    crowded = torch.nonzero(n_eq > inside).flatten().tolist()
    for r in crowded:
        above = idx[r][vals[r] > kth[r, 0]]
        ties = torch.nonzero(scores[r] == kth[r, 0]).flatten()
        idx[r] = torch.cat([above, ties[:k - above.numel()]])
        vals[r] = scores[r, idx[r]]
    order = torch.argsort(idx, dim=1)
    idx, vals = idx.gather(1, order), vals.gather(1, order)
    order = torch.argsort(-vals, dim=1, stable=True)
    return vals.gather(1, order), idx.gather(1, order)


def topk_single(queries, corpus, k: int):
    """(Q, D), (C, D) tensors → (scores (Q, k) fp32, indices (Q, k)); ties
    to the lower index."""
    scores = queries.float() @ corpus.float().T
    return topk_lower_index(scores, k)


def quantize_rows(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization on x's device: (N, D) → (codes
    int8 (N, D), scale fp32 (N,)) with x ≈ codes · scale. The JAX
    quantize_rows' operations in its order: divide (not a reciprocal
    multiply), round half to even, clip."""
    xf = x.float()
    amax = xf.abs().amax(dim=1)
    # a tensor divisor: PyTorch's CUDA kernels divide by a Python scalar
    # as a multiply by its reciprocal, which is not the same rounding
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) \
        / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_rows_np(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """quantize_rows on the host (numpy, the same operations): a chunk
    quantized before its upload moves a quarter of its fp32 bytes."""
    x = np.asarray(x, np.float32)
    amax = np.max(np.abs(x), axis=1)
    scale = np.where(amax > 0, amax, 1.0).astype(np.float32) / 127.0
    q = np.clip(np.rint(x / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def topk_single_int8(queries, corpus_q, corpus_scale, k: int):
    """int8-corpus top-k: queries (Q, D) in any float dtype, quantized per
    row on their device; corpus_q int8 (C, D) and corpus_scale fp32 (C,).
    The scores float(int32 product) · qs · cs come from K6 on the card and
    its plain version on the CPU. → (scores (Q, k) fp32, indices (Q, k));
    ties to the lower index."""
    from ..ops.matmul_int8 import int8_matmul_fused
    qq, qs = quantize_rows(queries)
    scores = int8_matmul_fused(qq, qs, corpus_q, corpus_scale, None,
                               out_dtype=torch.float32)
    return topk_lower_index(scores, k)


class StreamingSearcher:
    """Exact top-k over a corpus that arrives in chunks (device-memory
    bounded): each chunk is scored on `device`, its top-k merged on the
    host with the running best. quant="int8" quantizes each chunk on the
    host before its upload (quantize_rows_np) and the queries on the device
    (quantize_rows), as the JAX searcher does."""

    def __init__(self, k: int, device="cuda", quant: str = "none"):
        if quant not in QUANTS:
            raise ValueError(f"quant {quant!r}: expected one of {QUANTS}")
        self.k = k
        self.device = torch.device(device)
        self.quant = quant

    def _chunk_topk(self, q, chunk, k):
        if self.quant == "int8":
            cq, cs = quantize_rows_np(chunk)
            return topk_single_int8(q, torch.from_numpy(cq).to(self.device),
                                    torch.from_numpy(cs).to(self.device), k)
        c = torch.as_tensor(np.asarray(chunk, np.float32), device=self.device)
        return topk_single(q, c, k)

    def search(self, queries: np.ndarray,
               corpus_chunks: Iterable[Tuple[np.ndarray, int]]):
        """corpus_chunks yields (chunk (n, D), base index). → (scores (Q, k),
        global indices (Q, k)) numpy; slots past the corpus size score -inf.
        Equal scores keep the lower global index (chunks in ascending
        base order)."""
        q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        best_s = best_i = None
        for chunk, base in corpus_chunks:
            s, i = self._chunk_topk(q, chunk, min(self.k, chunk.shape[0]))
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


def self_retrieve(query_reps: np.ndarray, query_ids: List[str], k: int,
                  device="cuda") -> dict:
    """Query-to-query retrieval for near-duplicate detection: the query
    embeddings are also the corpus, and self-matches are kept (the
    reference's distributed_parallel_self_retrieve). → a TREC-style run."""
    scores, indices = StreamingSearcher(k, device).search(
        query_reps, [(query_reps, 0)])
    return build_run(scores, indices, query_ids, query_ids)


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

"""Exact dense top-k retrieval on one GPU, over an fp32 or an int8 corpus.

Counterpart of visrag_tpu/retrieval/search.py (topk_single,
quantize_rows, topk_single_int8, quantize_rows_np, make_sharded_topk,
shard_corpus, shard_corpus_int8, StreamingSearcher, self_retrieve,
build_run): the scores of a query batch against the corpus on the device,
their top-k, and a corpus streamed in chunks whose running top-k is merged
on the host.

Across ranks (a mesh): each rank holds a contiguous shard of the corpus
rows, in (replica, data) order, scores it (a plain GEMM in fp32, K6 over
an int8 shard), masks the pad rows past the true corpus size to -inf,
takes its local top-k (min(k, rows) wide, padded with -inf), offsets the
ids by rank * rows, and one all_gather of the (Q, k) candidates gives
every rank the exact global top-k. Candidates are shard-major and each
shard's are in (score descending, id ascending) order, so ties taken to
the lower position are ties to the lower global id, as in the JAX
shard_map.

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

from ..utils import profiling

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
    with profiling.span("search.topk"):
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


def _merge(scores, k: int, n_true, shard: int, group):
    """A shard's scores (Q, rows) → the global (scores (Q, k), ids (Q, k))
    on every rank of `group` (see the module docstring)."""
    rows = scores.shape[1]
    if (shard + 1) * rows > n_true:          # this shard holds pad rows
        ids = shard * rows + torch.arange(rows, device=scores.device)
        scores = torch.where(ids[None, :] < n_true, scores,
                             torch.full_like(scores, -torch.inf))
    s, idx = topk_lower_index(scores, min(k, rows))
    if s.shape[1] < k:
        pad = k - s.shape[1]
        s = torch.nn.functional.pad(s, (0, pad), value=-torch.inf)
        idx = torch.nn.functional.pad(idx, (0, pad))
    idx = idx + shard * rows
    from ..mesh import all_gather_rows
    s_all = all_gather_rows(s.T, group).T               # (Q, n * k)
    idx_all = all_gather_rows(idx.T, group).T
    best_s, pos = topk_lower_index(s_all.contiguous(), k)
    return best_s, idx_all.gather(1, pos)


def make_sharded_topk(mesh, k: int, quant: str = "none"):
    """The sharded exact top-k over the mesh's (replica, data) ranks.
    quant "none": fn(queries (Q, D), corpus_shard (rows, D), n_true);
    "int8": fn(queries, codes_shard int8 (rows, D), scales_shard fp32
    (rows,), n_true). Every rank passes the same queries and its own shard
    (shard_corpus / shard_corpus_int8); each gets (scores (Q, k) fp32,
    global ids (Q, k))."""
    from ..mesh import BATCH_AXES, axis_group, axis_index
    if quant not in QUANTS:
        raise ValueError(f"quant {quant!r}: expected one of {QUANTS}")
    group = axis_group(mesh, *BATCH_AXES)
    shard = axis_index(mesh, *BATCH_AXES)

    def fn(queries, corpus_shard, *rest):
        if quant == "int8":
            from ..ops.matmul_int8 import int8_matmul_fused
            scales, n_true = rest
            qq, qs = quantize_rows(queries)
            scores = int8_matmul_fused(qq, qs, corpus_shard, scales, None,
                                       out_dtype=torch.float32)
        else:
            (n_true,) = rest
            scores = queries.float() @ corpus_shard.float().T
        return _merge(scores, k, n_true, shard, group)

    return fn


def _shard_rows(x: np.ndarray, mesh, fill):
    """This rank's block of x's rows after padding them with `fill` to a
    multiple of the (replica, data) size."""
    from ..mesh import BATCH_AXES, axis_size, local_slice
    pad = (-x.shape[0]) % axis_size(mesh, *BATCH_AXES)
    if pad:
        x = np.concatenate([x, np.full((pad, *x.shape[1:]), fill, x.dtype)])
    return local_slice(x, mesh)


def shard_corpus(corpus: np.ndarray, mesh, device="cuda") -> torch.Tensor:
    """This rank's shard of the corpus rows (fp32 on `device`): zero rows
    pad the corpus to a multiple of the shard count, and the search masks
    them by n_true."""
    return torch.as_tensor(_shard_rows(np.asarray(corpus, np.float32), mesh,
                                       0.0), device=device)


def shard_corpus_int8(corpus_q: np.ndarray, corpus_scale: np.ndarray, mesh,
                      device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """shard_corpus for a quantized corpus: pad rows are zero codes with
    scale 1, codes and scales padded together."""
    q = _shard_rows(np.asarray(corpus_q, np.int8), mesh, 0)
    s = _shard_rows(np.asarray(corpus_scale, np.float32), mesh, 1.0)
    return torch.as_tensor(q, device=device), torch.as_tensor(s, device=device)


class StreamingSearcher:
    """Exact top-k over a corpus that arrives in chunks (device-memory
    bounded): each chunk is scored on `device`, its top-k merged on the
    host with the running best. quant="int8" quantizes each chunk on the
    host before its upload (quantize_rows_np) and the queries on the device
    (quantize_rows), as the JAX searcher does. With a mesh each chunk is
    sharded over the (replica, data) ranks and searched with
    make_sharded_topk (every rank passes the same queries and chunks and
    gets the same result); without one it is searched on one device."""

    def __init__(self, k: int, device="cuda", quant: str = "none",
                 mesh=None):
        if quant not in QUANTS:
            raise ValueError(f"quant {quant!r}: expected one of {QUANTS}")
        self.k = k
        self.device = torch.device(device)
        self.quant = quant
        self.mesh = mesh
        self._fn = None if mesh is None else \
            make_sharded_topk(mesh, k, quant)

    def _chunk_topk(self, q, chunk, k):
        if self.mesh is not None:
            if self.quant == "int8":
                cq, cs = shard_corpus_int8(*quantize_rows_np(chunk),
                                           self.mesh, self.device)
                return self._fn(q, cq, cs, chunk.shape[0])
            return self._fn(q, shard_corpus(chunk, self.mesh, self.device),
                            chunk.shape[0])
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
                  device="cuda", mesh=None) -> dict:
    """Query-to-query retrieval for near-duplicate detection: the query
    embeddings are also the corpus, and self-matches are kept (the
    reference's distributed_parallel_self_retrieve). → a TREC-style run."""
    scores, indices = StreamingSearcher(k, device, mesh=mesh).search(
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

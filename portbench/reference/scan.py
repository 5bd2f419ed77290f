"""The exact top-k of a corpus for a block of queries, in float64.

The corpus is read in blocks of rows, so that its float64 copy never
exists whole; scores of the program's own ids are read back the same way.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def topk64(queries: torch.Tensor, corpus: torch.Tensor, k: int,
           block: int = 65536):
    """→ (scores (Q, k) float64 descending, ids (Q, k)) over all rows."""
    q = queries.to(corpus.device, torch.float64)
    best_s = best_i = None
    for lo in range(0, corpus.shape[0], block):
        s = q @ corpus[lo:lo + block].double().T
        s, i = s.topk(min(k, s.shape[1]), dim=1)
        i = i + lo
        if best_s is not None:
            s, j = torch.cat([best_s, s], 1).topk(k, dim=1)
            i = torch.cat([best_i, i], 1).gather(1, j)
        best_s, best_i = s, i
    return best_s, best_i


@torch.no_grad()
def scores_of(queries: torch.Tensor, corpus: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """Float64 scores of the rows `ids` (Q, k) for each query."""
    q = queries.to(corpus.device, torch.float64)
    rows = corpus[ids.to(corpus.device).reshape(-1).long()].double()
    return (rows.reshape(*ids.shape, -1) * q[:, None]).sum(-1)

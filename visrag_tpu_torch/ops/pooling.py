"""Sequence pooling for dense retrieval embeddings.

Counterpart of visrag_tpu/ops/pooling.py. All functions take (B, S, D)
hidden states and a (B, S) attention mask and return (B, D); sums run in
fp32 and the result is cast back to the hidden dtype.

  wmean            — position-weighted mean (token i of the valid prefix,
                     1-indexed, weighs i); the VisRAG-Ret default.
  mean             — masked mean.
  lasttoken        — the last valid position (position -1 if every row of
                     the batch is left-padded).
  simple_lasttoken — position -1.
  cls              — position 0.

The training-only drop_wmean/drop_mean modes are not ported yet.
"""

from __future__ import annotations

import torch


def wmean_pool(hidden, mask):
    w = (mask * torch.cumsum(mask, dim=1)).float()
    s = torch.einsum("bsd,bs->bd", hidden.float(), w)
    return (s / w.sum(dim=1, keepdim=True)).to(hidden.dtype)


def mean_pool(hidden, mask):
    m = mask.float()
    s = torch.einsum("bsd,bs->bd", hidden.float(), m)
    return (s / m.sum(dim=1, keepdim=True)).to(hidden.dtype)


def last_token_pool(hidden, mask):
    b, s = mask.shape
    left_padded = mask[:, -1].sum() == b
    idx = torch.where(left_padded, s - 1, mask.sum(dim=1).long() - 1)
    return hidden[torch.arange(b, device=hidden.device), idx]


def pool(hidden, mask, mode: str = "wmean"):
    if mode == "wmean":
        return wmean_pool(hidden, mask)
    if mode == "mean":
        return mean_pool(hidden, mask)
    if mode == "lasttoken":
        return last_token_pool(hidden, mask)
    if mode == "simple_lasttoken":
        return hidden[:, -1, :]
    if mode == "cls":
        return hidden[:, 0, :]
    raise ValueError(f"unknown pooling mode {mode!r}")


def l2_normalize(x, eps: float = 1e-12):
    """F.normalize(dim=-1) semantics: divide by max(‖x‖, eps), in fp32."""
    xf = x.float()
    n = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True))
    return (xf / torch.clamp(n, min=eps)).to(x.dtype)

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
  drop_wmean/drop_mean — wmean/mean with Dropout1d(0.3) on the weighted
                     token rows in training: whole (batch, seq) rows are
                     zeroed and the kept ones scaled by 1/(1 - 0.3). The
                     keep mask comes from the caller's torch.Generator, so
                     a replay from the same generator state drops the same
                     rows. Outside training they equal wmean/mean.
"""

from __future__ import annotations

import torch

DROPOUT_RATE = 0.3


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


def dropout1d(x, rate: float, generator=None):
    """torch Dropout1d on (B, S, D) as the reference feeds it (S acts as
    channels): each (b, s) row is kept with probability 1 - rate and
    scaled by 1/(1 - rate)."""
    keep = torch.rand(x.shape[:2], generator=generator,
                      device=x.device) < 1.0 - rate
    return x * keep[:, :, None].to(x.dtype) / (1.0 - rate)


def _drop_pool(hidden, w, training, generator):
    h = hidden.float() * w[:, :, None]
    if training:
        h = dropout1d(h, DROPOUT_RATE, generator)
    return (h.sum(dim=1) / w.sum(dim=1, keepdim=True)).to(hidden.dtype)


def pool(hidden, mask, mode: str = "wmean", *, training: bool = False,
         generator=None):
    """training and generator matter only to the drop_* modes."""
    if mode == "wmean":
        return wmean_pool(hidden, mask)
    if mode == "mean":
        return mean_pool(hidden, mask)
    if mode == "drop_wmean":
        return _drop_pool(hidden, (mask * torch.cumsum(mask, dim=1)).float(),
                          training, generator)
    if mode == "drop_mean":
        return _drop_pool(hidden, mask.float(), training, generator)
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

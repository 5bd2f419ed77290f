"""Ulysses sequence parallelism: all_to_all seq ↔ heads around attention.

Counterpart of visrag_tpu/parallel/ulysses.py. The JAX package runs
`lax.all_to_all` inside shard_map over the mesh's `seq` axis; the port
runs `all_to_all_single` over the seq process group inside an autograd
Function whose backward is the inverse all_to_all.

Layout: each rank of the seq group holds a contiguous block of the
sequence, (B, S/n, H, D); attention runs head-sharded on the whole
sequence, (B, S, H/n, D), through `ops.attention.flash_attention` (the
segment kernel K4 on the card, forward, dq and dk/dv); the output returns
to the sequence block. Segment ids and lengths are the replicated
full-sequence values: cheap, and they keep the collectives to three for
q/k/v and one for the output. The head count must be a multiple of the
seq size.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..mesh import SEQ, axis_group, axis_index, axis_size
from ..ops.attention import flash_attention


def _all_to_all(x, group, scatter_dim: int, gather_dim: int):
    n = dist.get_world_size(group)
    parts = torch.stack(x.chunk(n, dim=scatter_dim)).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    return torch.cat(out.unbind(0), dim=gather_dim)


class _AllToAll(torch.autograd.Function):
    """Rank j receives chunk j of every rank's x along scatter_dim and
    concatenates them along gather_dim in rank order; the backward sends
    the gradient's pieces back the inverse way."""

    @staticmethod
    def forward(ctx, x, group, scatter_dim, gather_dim):
        ctx.args = (group, gather_dim, scatter_dim)
        return _all_to_all(x, group, scatter_dim, gather_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), *ctx.args), None, None, None


def seq_to_heads(x, group):
    """(B, S/n, H, D) → (B, S, H/n, D)."""
    return _AllToAll.apply(x, group, 2, 1)


def heads_to_seq(x, group):
    """(B, S, H/n, D) → (B, S/n, H, D)."""
    return _AllToAll.apply(x, group, 1, 2)


def ulysses_attention(q, k, v, group, *, q_seg=None, kv_seg=None,
                      lengths=None, causal=False, **kw):
    """Sequence-parallel flash attention over the seq group: q/k/v the
    local (B, S/n, H, D) blocks, q_seg / kv_seg (B, S) or lengths (B,) the
    full-sequence values."""
    o = flash_attention(seq_to_heads(q, group), seq_to_heads(k, group),
                        seq_to_heads(v, group), q_seg, kv_seg,
                        lengths=lengths, causal=causal, **kw)
    return heads_to_seq(o, group)


def sp_flash_attention(q, k, v, *, q_seg=None, kv_seg=None, lengths=None,
                       causal=False, mesh=None, backend: str = "ulysses"):
    """A model's attention, sequence-parallel over the mesh's seq axis.

    q/k/v: this rank's (B, S/n, H, D) blocks of its batch rows; q_seg /
    kv_seg (B, S) or lengths (B,) full-sequence. Without a mesh or at
    seq 1 this is plain flash_attention. Otherwise lengths become segment
    masks (one signature for both), grouped kv heads are repeated by
    n // gcd(kv heads, n) so that they split over the seq ranks, and
    backend "ulysses" (heads % n == 0) or "ring" (parallel/ring.py, no
    head constraint, kv heads repeated to H) runs."""
    n = axis_size(mesh, SEQ)
    if n <= 1:
        return flash_attention(q, k, v, q_seg, kv_seg, lengths=lengths,
                               causal=causal)
    b, s_loc, h, _ = q.shape
    s = s_loc * n
    if lengths is not None and q_seg is None:
        q_seg = (torch.arange(s, device=q.device)[None, :]
                 < lengths.to(q.device)[:, None]).to(torch.int32)
        kv_seg = q_seg
    if q_seg is None:
        q_seg = kv_seg = torch.ones((b, s), dtype=torch.int32,
                                    device=q.device)
    group = axis_group(mesh, SEQ)
    hk = k.shape[2]
    if backend == "ring":
        from .ring import ring_attention
        if hk != h:
            k = k.repeat_interleave(h // hk, dim=2)
            v = v.repeat_interleave(h // hk, dim=2)
        r = axis_index(mesh, SEQ)
        return ring_attention(q, k, v, group, causal=causal,
                              segment_ids=q_seg[:, r * s_loc:(r + 1) * s_loc])
    if backend != "ulysses":
        raise ValueError(f"sp backend {backend!r}: expected 'ulysses' or "
                         "'ring'")
    validate_heads(h, n)
    if hk % n:
        rep = n // math.gcd(hk, n)
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return ulysses_attention(q, k, v, group, q_seg=q_seg, kv_seg=kv_seg,
                             causal=causal)


def pad_seq_for_ulysses(x, seq_size: int, dim: int = 1):
    """Pad the sequence dim with zeros to a multiple of the SP degree.
    → (padded, original length)."""
    s = x.shape[dim]
    pad = (-s) % seq_size
    if pad == 0:
        return x, s
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim), s


def validate_heads(num_heads: int, sp_size: int):
    if num_heads % sp_size != 0:
        raise ValueError(f"{num_heads} heads not divisible by sp={sp_size} "
                         "(reference ulysses.py:323-327)")

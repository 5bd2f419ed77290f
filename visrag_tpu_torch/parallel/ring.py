"""Ring attention: context parallelism over the mesh's seq axis.

Counterpart of visrag_tpu/parallel/ring.py. The JAX version is plain jnp
with `lax.ppermute` (no Pallas kernel), so plain PyTorch with P2P sends is
its port. Each rank holds a contiguous block of the sequence; the K/V
blocks and their segment ids travel around the ring (rank i sends to
i + 1) while each rank folds its queries' attention over the block it
holds into a running (max, sum, accumulator), the log-sum-exp
combination. Peak memory per rank is one block's scores and one K/V
block in flight.

Gradients: the shift is an autograd Function whose backward sends the
gradient around the reverse ring (what ppermute transposes to in JAX), so
autograd through the steps is the gradient of full attention.

Rows that see no key come out exactly 0 (the port's contract for every
attention kernel); the JAX version leaves an average there, on rows
every caller masks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

NEG = -1e30


def _shift(x, group, step: int):
    """Send x to the rank `step` places on in the group's ring and receive
    the block of the rank `step` places back."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (me + step) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _local_attend(q, k, v, allow, sm_scale):
    """One ring step's partial: q (B, Sq, H, D), k/v (B, Sk, H, D), allow
    (B, Sq, Sk). → (num (B, Sq, H, D) fp32, m, l (B, Sq, H) fp32)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    allow = allow[:, None]
    s = torch.where(allow, s, torch.full_like(s, NEG))
    m = s.amax(dim=-1)
    p = torch.where(allow, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    num = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    return num, m.transpose(1, 2), l.transpose(1, 2)


def ring_attention(q, k, v, group, *, causal: bool = False,
                   segment_ids=None, sm_scale: Optional[float] = None):
    """q/k/v: this rank's (B, S/n, H, D) blocks, blocks in group-rank
    order; segment_ids: this rank's (B, S/n) block (ids <= 0 are padding,
    visibility within equal ids; None: one segment). Causal masking uses
    global positions. → this rank's (B, S/n, H, D) block of full
    attention."""
    b, s_loc, h, d = q.shape
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if segment_ids is None:
        segment_ids = torch.ones((b, s_loc), dtype=torch.int32,
                                 device=q.device)
    q_seg = segment_ids.to(torch.int32)
    q_pos = idx * s_loc + torch.arange(s_loc, device=q.device)
    acc = torch.zeros((b, s_loc, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, s_loc, h), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, s_loc, h), dtype=torch.float32, device=q.device)
    k_t, v_t, seg_t = k, v, q_seg
    for t in range(n):
        src = (idx - t) % n
        allow = (q_seg[:, :, None] == seg_t[:, None, :]) \
            & (q_seg[:, :, None] > 0)
        if causal:
            kv_pos = src * s_loc + torch.arange(s_loc, device=q.device)
            allow = allow & (q_pos[:, None] >= kv_pos[None, :])[None]
        num, m_blk, l_blk = _local_attend(q, k_t, v_t, allow, sm_scale)
        m_new = torch.maximum(m, m_blk)
        c_old, c_blk = torch.exp(m - m_new), torch.exp(m_blk - m_new)
        acc = acc * c_old[..., None] + num * c_blk[..., None]
        l = l * c_old + l_blk * c_blk
        m = m_new
        if t + 1 < n:
            k_t = _RingShift.apply(k_t, group)
            v_t = _RingShift.apply(v_t, group)
            seg_t = _shift(seg_t, group, 1)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)

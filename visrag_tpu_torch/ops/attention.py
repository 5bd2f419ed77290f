"""Plain attention for the serving path.

Counterpart of two functions of visrag_tpu/ops/attention.py:

  * `chunk_attention` (`xla_chunk_attention`): the chunked-prefill
    attention. The JAX package runs it as plain XLA, not as a Pallas kernel,
    so plain PyTorch is its port: chunk queries at global positions
    start + arange(C) attend the gathered cache rows [0, L) under the
    global-position causal mask, with an online softmax over kv blocks so
    that a long prefix never materializes a (C, L) score plane.
  * `segment_attention_reference` (`mha_reference`): segment-id masked
    attention, optionally causal, the oracle the tests hold the kernels to.
"""

from __future__ import annotations

import torch

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _group(q, kvh):
    """(B, S, H, D) → (B, S, kvh, H // kvh, D): query head h belongs to kv
    head h // (H // kvh)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, kvh, h // kvh, d)


def segment_attention_reference(q, k, v, q_seg=None, kv_seg=None, *,
                                causal=False, sm_scale=None):
    """q (B, Sq, H, D), k/v (B, Sk, H_kv, D); a pair attends iff the ids are
    equal (and, when causal, key <= query). Rows that see no key are zeros.
    fp32 math, → q's dtype."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    if q_seg is None:
        q_seg = torch.ones((b, sq), dtype=torch.int32, device=q.device)
    if kv_seg is None:
        kv_seg = torch.ones((b, sk), dtype=torch.int32, device=q.device)
    allow = q_seg[:, :, None] == kv_seg[:, None, :]
    if causal:
        allow = allow & (torch.arange(sq, device=q.device)[:, None]
                         >= torch.arange(sk, device=q.device)[None, :])
    scores = torch.einsum("bqgrd,bkgd->bgrqk", _group(q.float(), kvh),
                          k.float()) * sm_scale
    scores = scores.masked_fill(~allow[:, None, None], MASK_VALUE)
    p = torch.softmax(scores, dim=-1)
    p = p * allow.any(-1)[:, None, None, :, None]
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def chunk_attention(q, k_all, v_all, start, *, sm_scale=None,
                    kv_block: int = 1024):
    """Chunked-prefill attention: q (B, C, H, D) at global positions
    start + arange(C) (start (B,) int); k_all/v_all (B, L, H_kv, D) cover
    [0, L) with this chunk already written. Mask: key <= start + query.
    fp32 scores and online softmax over kv_block-key blocks; P rounded to
    the cache's dtype for P.V with fp32 accumulation. → (B, C, H, D)."""
    b, cq, h, d = q.shape
    L, kvh = k_all.shape[1], k_all.shape[2]
    rep = h // kvh
    if sm_scale is None:
        sm_scale = d ** -0.5
    q32 = _group(q.float() * sm_scale, kvh)                 # (B,C,g,r,D)
    qpos = start.to(q.device).long()[:, None] \
        + torch.arange(cq, device=q.device)[None]           # (B, C)
    m = torch.full((b, kvh, rep, cq), float("-inf"), device=q.device)
    l = torch.zeros((b, kvh, rep, cq), device=q.device)
    acc = torch.zeros((b, kvh, rep, cq, d), device=q.device)
    for base in range(0, L, kv_block):
        kb = k_all[:, base:base + kv_block]
        vb = v_all[:, base:base + kv_block]
        s = torch.einsum("bqgrd,bkgd->bgrqk", q32, kb.float())
        ki = base + torch.arange(kb.shape[1], device=q.device)
        allow = (ki[None, None, :] <= qpos[:, :, None])[:, None, None]
        s = torch.where(allow, s, torch.full_like(s, MASK_VALUE))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(allow, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]          # (B,g,r,C,D)
    return o.permute(0, 3, 1, 2, 4).reshape(b, cq, h, d).to(q.dtype)

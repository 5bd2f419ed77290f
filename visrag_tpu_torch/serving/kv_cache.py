"""Dense slot-cache decode attention.

Counterpart of visrag_tpu/serving/kv_cache.py: one token per slot attends
a dense (slots, L_max, kv_heads, d) cache. The serving engine reads the
paged pool instead (serving/paged_kv.py, K5); this is the decode path of
`Qwen25VL.decode` without a block table, which the tests use.
"""

from __future__ import annotations

import math

import torch


def decode_attention(q, k_cache, v_cache, lengths, sm_scale=None):
    """q (slots, H, d); k_cache/v_cache (slots, L_max, kvh, d); lengths
    (slots,) INCLUDING this step's token. Grouped-query attention by
    reshaping q to (slots, kvh, rep, d); fp32 scores, P rounded to the
    cache's dtype, fp32 accumulation. → (slots, H, d) in q's dtype."""
    s, h, d = q.shape
    kvh = k_cache.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qg = q.reshape(s, kvh, h // kvh, d)
    scores = torch.einsum("sgrd,slgd->sgrl", qg.float(),
                          k_cache.float()) * sm_scale
    mask = (torch.arange(k_cache.shape[1], device=q.device)[None, :]
            < lengths.to(q.device)[:, None])[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("sgrl,slgd->sgrd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(s, h, d).to(q.dtype)

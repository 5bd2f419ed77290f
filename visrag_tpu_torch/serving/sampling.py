"""Token sampling for the serving engine.

Counterpart of visrag_tpu/serving/sampling.py: the vLLM SamplingParams
surface EVisRAG uses (temperature, top_p, repetition_penalty, max_tokens,
logit_bias for the image-token ban). `sample_vec` is the engine's
per-request sampler: an exact categorical draw by inverse CDF with ONE
uniform per row, taken from a `torch.Generator` or handed in (`uniform`),
so that a test can feed both frameworks the same draw.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0                 # 0 = disabled
    repetition_penalty: float = 1.0
    max_tokens: int = 2048
    stop_token_ids: Sequence[int] = ()
    # per-request additive logit bias ((token_id, bias), ...), applied to
    # the logits before sampling in every engine path
    logit_bias: Tuple[Tuple[int, float], ...] = ()


def banned_ids_bias(token_ids: Sequence[int],
                    bias: float = -100.0) -> Tuple[Tuple[int, float], ...]:
    """The image-token ban as a logit_bias tuple ({image_token_id: -100})."""
    return tuple((int(t), float(bias)) for t in token_ids)


def bias_arrays(sp: SamplingParams, width: int):
    """A request's logit_bias padded to fixed-width (ids, vals) numpy
    arrays; id 0 / bias 0.0 padding is a no-op under scatter-add."""
    if len(sp.logit_bias) > width:
        raise ValueError(
            f"logit_bias has {len(sp.logit_bias)} entries; the engine "
            f"supports at most {width}")
    ids = np.zeros((width,), np.int32)
    vals = np.zeros((width,), np.float32)
    for j, (t, b) in enumerate(sp.logit_bias):
        ids[j] = t
        vals[j] = b
    return ids, vals


def apply_repetition_penalty(logits, seen_mask, penalty: float):
    """Logits of already-seen tokens are divided by `penalty` if positive,
    multiplied if negative. seen_mask: (B, V) bool."""
    if penalty == 1.0:
        return logits
    scaled = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen_mask, scaled, logits)


def _top_p_filter(lt, top_p):
    """Keep the smallest prefix of sorted tokens with cumulative prob >=
    top_p (per row); the rest → -inf."""
    sorted_l = torch.sort(lt, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p[:, None]).sum(dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_l, 1, cutoff_idx.clamp(max=lt.shape[1] - 1))
    return torch.where(lt < cutoff, torch.full_like(lt, float("-inf")), lt)


def sample(logits, params: SamplingParams, seen_mask=None,
           generator: Optional[torch.Generator] = None):
    """logits (B, V) → token ids (B,) with one SamplingParams for the whole
    batch. Greedy when temperature == 0."""
    logits = logits.float()
    if seen_mask is not None:
        logits = apply_repetition_penalty(logits, seen_mask,
                                          params.repetition_penalty)
    if params.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / params.temperature
    if params.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -params.top_k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if params.top_p < 1.0:
        logits = _top_p_filter(logits, torch.full(
            (logits.shape[0],), params.top_p, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def sample_vec(logits, temperature, top_p, repetition_penalty, seen_mask, *,
               generator: Optional[torch.Generator] = None, uniform=None,
               all_greedy: Optional[bool] = None,
               any_top_p: Optional[bool] = None):
    """Per-request sampling: logits (B, V); temperature, top_p,
    repetition_penalty (B,) tensors; seen_mask (B, V) bool. → (tokens (B,)
    int32, logp (B,) fp32), logp being the chosen token's log-probability
    under the RAW logits. Rows with temperature 0 decode greedily.

    uniform (B,) in [0, 1) replaces the generator's draw. all_greedy and
    any_top_p let a caller that knows them on the host skip the device
    checks (each is a host sync on a card)."""
    raw = logits.float()
    rp = repetition_penalty.float()[:, None]
    scaled = torch.where(raw > 0, raw / rp, raw * rp)
    lm = torch.where(seen_mask, scaled, raw)
    greedy = torch.argmax(lm, dim=-1).to(torch.int32)
    if all_greedy is None:
        all_greedy = bool((temperature == 0).all())
    if all_greedy:
        tok = greedy
    else:
        lt = lm / torch.clamp(temperature.float(), min=1e-6)[:, None]
        if any_top_p is None:
            any_top_p = bool((top_p < 1.0).any())
        if any_top_p:
            lt = _top_p_filter(lt, top_p.float())
        p = torch.exp(lt - lt.amax(dim=-1, keepdim=True))
        cum = torch.cumsum(p, dim=-1)
        if uniform is None:
            uniform = torch.rand((lt.shape[0],), generator=generator,
                                 device=lt.device)
        # u in (0, total]: the first index with cum >= u is an exact draw
        u = (1.0 - uniform.float().to(lt.device))[:, None] * cum[:, -1:]
        idx = (cum < u).sum(dim=-1).clamp(max=lt.shape[1] - 1)
        tok = torch.where(temperature == 0, greedy, idx.to(torch.int32))
    logz = torch.logsumexp(raw, dim=-1)
    logp = torch.gather(raw, 1, tok[:, None].long())[:, 0] - logz
    return tok, logp

"""Beam search for the weighted-selection generation strategy.

Counterpart of visrag_tpu/serving/beam.py. The reference scores each
candidate page's answer with HF beam search (num_beams=3,
repetition_penalty=1.2) and weights exp(sequences_scores) by the softmaxed
retrieval score. Beams are coupled (step t's survivors come from one top-2k
over all beams x vocab), so beam search runs outside the engine's slots on
dense per-beam caches: prefill once per prompt (K1), copy the prompt's K/V
to the k beams, then one batched decode step per token through the model's
`decode` without a block table (serving/kv_cache.decode_attention, plain
PyTorch, as the JAX step is plain XLA), with HF-parity bookkeeping on the
host (`_BeamState`, the JAX package's numpy code as it is):

  log_softmax -> repetition penalty (logprob * p on seen tokens, on
  post-softmax scores) -> + beam score -> top-2k over k*vocab -> EOS
  candidates ranked < k become finished hypotheses (score incl. the EOS
  logprob, sequence WITHOUT the EOS token) -> the first k non-EOS
  candidates continue; done by HF's early_stopping=False test; finalize
  adds the running beams when short of k. sequences_score = sum logprob /
  generated_len ** length_penalty.

`beam_search_batched` runs P prompts' k-beam loops in one (P*k,)-batched
decode step per token; the bookkeeping stays per prompt, so ids and scores
equal the sequential path's. A prompt that is done keeps its frozen rows in
the batch. The caches are layer-stacked (layers, P*k, L, kvh, d) tensors
written in place; a reorder gathers the beams' rows.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


class _BeamState:
    """Host-side HF-parity bookkeeping for ONE prompt's k beams."""

    def __init__(self, k: int, prompt_ids: np.ndarray, vocab_hint: int,
                 logp0: np.ndarray, base: int, s: int):
        self.k = k
        self.tokens: List[List[int]] = [[] for _ in range(k)]
        self.scores = np.full((k,), -1e9, np.float64)
        self.scores[0] = 0.0
        seen = np.zeros((vocab_hint,), bool)
        seen[prompt_ids] = True
        self.seen = [seen.copy() for _ in range(k)]
        self.finished: List[Tuple[float, float, List[int]]] = []
        self.logp0 = logp0          # (vocab,) prompt-last logprobs
        self.base = base            # first generated token's position
        self.s = s                  # prompt length (cache rows filled)
        self.done = False
        self.stopped_early = False
        # frozen continuation rows for done prompts (keep the batch static)
        self.parents = np.arange(k, dtype=np.int32)
        self.next_tokens = [0] * k

    def select(self, logp: np.ndarray, step: int, eos: set,
               repetition_penalty: float, length_penalty: float):
        """logp (k, vocab) -> choose next beams; update finished/done."""
        k, vocab = self.k, logp.shape[-1]
        cand = np.empty((k, vocab), np.float64)
        for b in range(k):
            row = np.asarray(logp[b], np.float64)
            if repetition_penalty != 1.0:
                row = row.copy()
                # HF RepetitionPenaltyLogitsProcessor on log-softmax
                # scores: scores are <= 0, so penalized tokens multiply
                idx = np.nonzero(self.seen[b])[0]
                row[idx] = np.where(row[idx] < 0,
                                    row[idx] * repetition_penalty,
                                    row[idx] / repetition_penalty)
            cand[b] = row + self.scores[b]
        flat = cand.reshape(-1)
        # HF takes max(2, 1 + n_eos) * k candidates so that even if every
        # beam's top pick is an EOS variant, >= k non-EOS survivors remain
        n_cand = max(2, 1 + len(eos)) * k
        order = np.argsort(-flat)[:n_cand]
        next_beams = []      # (parent, token, score_sum)
        for rank, fi in enumerate(order):
            parent, token = divmod(int(fi), vocab)
            score = float(flat[fi])
            if token in eos:
                if rank >= k:
                    continue
                # hypothesis = tokens before the EOS; score includes the
                # EOS logprob; generated_len counts the EOS (HF
                # _beam_search: generated_len = cur_len - prompt_len + 1)
                gen_len = step + 1
                norm = score / (gen_len ** length_penalty)
                self.finished.append((norm, score,
                                      list(self.tokens[parent])))
            else:
                next_beams.append((parent, token, score))
            if len(next_beams) == k:
                break
        self.finished.sort(key=lambda x: -x[0])
        self.finished = self.finished[:k]
        while len(next_beams) < k:
            # unreachable under the n_cand guarantee unless vocab < n_cand;
            # pad with never-winning beams so the batched step holds
            next_beams.append((0, 0, -1e9))

        self.parents = np.asarray([p for p, _, _ in next_beams], np.int32)
        self.next_tokens = [t for _, t, _ in next_beams]
        self.scores = np.asarray([sc for _, _, sc in next_beams], np.float64)
        self.tokens = [self.tokens[p] + [t]
                       for p, t in zip(self.parents, self.next_tokens)]
        self.seen = [self.seen[p].copy() for p in self.parents]
        for b, t in enumerate(self.next_tokens):
            self.seen[b][t] = True

        # HF early_stopping=False done heuristic
        if len(self.finished) >= k:
            best_running = float(self.scores.max())
            gen_len = step + 1
            if min(f[0] for f in self.finished) >= \
                    best_running / (gen_len ** length_penalty):
                self.stopped_early = True
                self.done = True

    def finalize(self, length_penalty: float) -> Tuple[List[int], float]:
        # (HF BeamSearchScorer.finalize): unless the done heuristic fired,
        # ALL running beams join the hypothesis pool and compete on the
        # length-normalized score — a finished-via-EOS hypothesis must not
        # win over a better still-running beam just because it finished
        finished = list(self.finished)
        if not self.stopped_early:
            for b in range(self.k):
                gen_len = max(len(self.tokens[b]), 1)
                norm = float(self.scores[b]) / (gen_len ** length_penalty)
                finished.append((norm, float(self.scores[b]),
                                 list(self.tokens[b])))
        finished.sort(key=lambda x: -x[0])
        best = finished[0]
        return best[2], best[0]


def _prefill_one(model, prompt: dict, device):
    """→ (logp0 (vocab,) np, k/v (layers, 1, bucket, kvh, d) on the
    device, s, base, prompt ids)."""
    input_ids = np.asarray(prompt["input_ids"], np.int32)
    s = len(input_ids)
    positions = prompt.get("positions")
    bucket = -(-s // 64) * 64
    ids = np.zeros((1, bucket), np.int64)
    ids[0, :s] = input_ids
    mask = np.zeros((1, bucket), np.int32)
    mask[0, :s] = 1
    if positions is None:
        positions = np.broadcast_to(np.arange(s), (3, s))
    pos = np.zeros((3, 1, bucket), np.int64)
    pos[:, 0, :s] = positions
    vision_batch = prompt.get("vision_batch")
    vb = {kk: torch.as_tensor(np.asarray(v), device=device)
          for kk, v in vision_batch.items()} \
        if vision_batch is not None else None
    sm = None
    if prompt.get("slot_map") is not None:
        sm = np.full((1, bucket), -1, np.int64)
        sm[0, :s] = prompt["slot_map"]
        sm = torch.as_tensor(sm, device=device)
    last, kp, vp = model.prefill(
        torch.as_tensor(ids, device=device),
        attention_mask=torch.as_tensor(mask, device=device),
        positions=torch.as_tensor(pos, device=device), vision_batch=vb,
        slot_map=sm, last_pos=torch.tensor([s - 1], device=device))
    logp0 = torch.log_softmax(last[0].float(), dim=-1).cpu().numpy()
    base = int(np.max(positions)) + 1
    return logp0, kp, vp, s, base, input_ids


@torch.no_grad()
def beam_search_batched(model, prompts: Sequence[dict], *,
                        num_beams: int = 3, max_new_tokens: int = 64,
                        eos_token_ids: Sequence[int] = (),
                        length_penalty: float = 1.0,
                        repetition_penalty: float = 1.0,
                        ) -> List[Tuple[List[int], float]]:
    """HF-semantics beam search over P prompts in one (P*k,)-batched decode
    loop → [(best output ids, sequences_score)] per prompt, identical to
    running `beam_search` per prompt. Prompts: dicts with input_ids
    [+ positions, vision_batch, slot_map]; the model's device is used."""
    device = next(model.parameters()).device
    P = len(prompts)
    k = num_beams
    eos = set(int(e) for e in eos_token_ids)

    pre = [_prefill_one(model, p, device) for p in prompts]
    kp0 = pre[0][1]
    layers, kvh, d = kp0.shape[0], kp0.shape[3], kp0.shape[4]
    max_len = max(s for _, _, _, s, _, _ in pre) + max_new_tokens + 1
    kc = torch.zeros((layers, P * k, max_len, kvh, d), dtype=kp0.dtype,
                     device=device)
    vc = torch.zeros_like(kc)
    for p, (_, kp, vp, s, _, _) in enumerate(pre):
        kc[:, p * k:(p + 1) * k, :s] = kp[:, :, :s]
        vc[:, p * k:(p + 1) * k, :s] = vp[:, :, :s]
    del kp0
    states = [_BeamState(k, ids_, logp0.shape[-1], logp0, base, s)
              for (logp0, _, _, s, base, ids_) in pre]
    del pre
    lengths = np.concatenate([np.full((k,), st.s, np.int32)
                              for st in states])
    toks = None

    for step in range(max_new_tokens):
        if step == 0:
            logp = np.stack([st.logp0 for st in states])       # (P, vocab)
            logp = np.broadcast_to(logp[:, None, :],
                                   (P, k, logp.shape[-1]))
        else:
            pos = np.concatenate([
                np.full((k,), st.base + step - 1, np.int64)
                for st in states])
            pos3 = torch.as_tensor(pos, device=device)[None, :, None] \
                .expand(3, P * k, 1)
            logits = model.decode(toks[:, None], pos3, kc, vc,
                                  torch.as_tensor(lengths, device=device))
            logp = torch.log_softmax(logits.float(), dim=-1).cpu().numpy() \
                .reshape(P, k, -1)
        for p, st in enumerate(states):
            if not st.done:
                st.select(logp[p], step, eos,
                          repetition_penalty, length_penalty)

        if all(st.done for st in states) or step + 1 == max_new_tokens:
            break
        # done prompts freeze: identity parents, token 0 (their rows keep
        # stepping in the batch; results are already locked in st.finished)
        parents = np.concatenate([
            (np.arange(k, dtype=np.int32) if st.done else st.parents)
            + p * k for p, st in enumerate(states)])
        new_tokens = [t for st in states
                      for t in (([0] * k) if st.done else st.next_tokens)]
        # step-0 beams are k identical copies of the prompt: any parent
        # permutation is a no-op on the caches
        if step > 0 and not np.array_equal(
                parents, np.arange(P * k, dtype=np.int32)):
            idx = torch.as_tensor(parents, dtype=torch.long, device=device)
            kc = kc.index_select(1, idx)
            vc = vc.index_select(1, idx)
        toks = torch.as_tensor(new_tokens, dtype=torch.long, device=device)
        lengths = lengths + 1

    return [st.finalize(length_penalty) for st in states]


def beam_search(model, input_ids, positions=None, *, vision_batch=None,
                slot_map=None, num_beams: int = 3, max_new_tokens: int = 64,
                eos_token_ids: Sequence[int] = (),
                length_penalty: float = 1.0,
                repetition_penalty: float = 1.0,
                ) -> Tuple[List[int], float]:
    """→ (best output ids, sequences_score) for one prompt, with HF
    generate() semantics (see the module docstring); the score is the
    length-normalized sum of logprobs the reference exponentiates."""
    prompt = dict(input_ids=input_ids, positions=positions,
                  vision_batch=vision_batch, slot_map=slot_map)
    return beam_search_batched(
        model, [prompt], num_beams=num_beams,
        max_new_tokens=max_new_tokens, eos_token_ids=eos_token_ids,
        length_penalty=length_penalty,
        repetition_penalty=repetition_penalty)[0]

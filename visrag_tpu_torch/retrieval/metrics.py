"""IR metrics: nDCG@k, Recall@k (pytrec_eval/trec_eval-compatible), MRR@k.

Pure-NumPy replacement for the reference's pytrec_eval dependency
(reference src/openmatch/driver/eval.py:281-304) plus the manual MRR
(utils.py:285-308). trec_eval semantics:
  * ranking: sort by score desc, ties broken by doc id DESCENDING (string);
  * ndcg_cut.k: DCG = Σ gain_i / log2(i+2) over the top-k of the run ranking,
    IDCG from the qrels' own sorted gains (all relevant, not only retrieved);
  * recall.k: |relevant ∩ top-k| / |relevant| with graded rels counted rel>0;
  * aggregate = mean over queries evaluated (qid present in run ∩ qrels for
    MRR; pytrec_eval evaluates every run qid that appears in qrels).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

Run = Mapping[str, Mapping[str, float]]     # qid -> {docid: score}
Qrels = Mapping[str, Mapping[str, int]]     # qid -> {docid: relevance}


def _ranked_docs(doc_scores: Mapping[str, float]):
    """trec_eval tie-break: score desc, then docid desc."""
    return [d for d, _ in sorted(doc_scores.items(),
                                 key=lambda kv: (-kv[1], _desc_key(kv[0])))]


def _desc_key(s: str):
    # invert character order so ascending sort yields descending docids
    return tuple(-ord(c) for c in s)


def ndcg_at_k(run: Run, qrels: Qrels, k: int = 10) -> Dict[str, float]:
    out = {}
    for qid, doc_scores in run.items():
        if qid not in qrels:
            continue
        rels = qrels[qid]
        ranked = _ranked_docs(doc_scores)[:k]
        dcg = sum(rels.get(d, 0) / math.log2(i + 2)
                  for i, d in enumerate(ranked) if rels.get(d, 0) > 0)
        ideal = sorted((r for r in rels.values() if r > 0), reverse=True)[:k]
        idcg = sum(r / math.log2(i + 2) for i, r in enumerate(ideal))
        out[qid] = dcg / idcg if idcg > 0 else 0.0
    return out


def recall_at_k(run: Run, qrels: Qrels, k: int = 10) -> Dict[str, float]:
    out = {}
    for qid, doc_scores in run.items():
        if qid not in qrels:
            continue
        relevant = {d for d, r in qrels[qid].items() if r > 0}
        if not relevant:
            out[qid] = 0.0
            continue
        top = set(_ranked_docs(doc_scores)[:k])
        out[qid] = len(top & relevant) / len(relevant)
    return out


def mrr_at_k(run: Run, qrels: Qrels, k: int = 10) -> Dict[str, float]:
    """Reference eval_mrr parity (utils.py:285-308): iterates qrels' qids,
    skips ones missing from the run, ties broken by insertion order of the
    run dict (sort is stable on score only)."""
    out = {}
    total, n = 0.0, 0
    for qid in qrels:
        if qid not in run:
            continue
        n += 1
        ranked = sorted(run[qid].items(), key=lambda kv: kv[1], reverse=True)
        rr = 0.0
        for i, (docid, _) in enumerate(ranked):
            if i >= k:
                break
            if qrels[qid].get(docid, 0) > 0:
                rr = 1.0 / (i + 1)
                break
        out[qid] = rr
        total += rr
    out["all"] = total / n if n else 0.0
    return out


def evaluate_run(run: Run, qrels: Qrels, k: int = 10) -> Dict[str, float]:
    """Aggregate metrics dict like the reference's test_result.log."""
    ndcg = ndcg_at_k(run, qrels, k)
    rec = recall_at_k(run, qrels, k)
    mrr = mrr_at_k(run, qrels, k)

    def mean(d):
        vals = [v for q, v in d.items() if q != "all"]
        return sum(vals) / len(vals) if vals else 0.0

    return {f"ndcg_cut_{k}": mean(ndcg), f"recall_{k}": mean(rec),
            f"mrr_{k}": mrr["all"]}

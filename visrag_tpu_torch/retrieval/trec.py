"""TREC run files + qrels IO, format-compatible with the reference
(reference src/openmatch/utils.py:125-175 save/load, driver/eval.py
load_beir_qrels)."""

from __future__ import annotations

import os
from typing import Dict, List, Tuple, Union

Run = Dict[str, Dict[str, float]]


def save_as_trec(rank_result: Run, output_path: str,
                 run_id: str = "visrag_tpu") -> None:
    """<qid>\tQ0\t<docid>\t<rank>\t<score>\t<run_id>, rank by score desc."""
    parent = os.path.dirname(output_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(output_path, "w") as f:
        for qid in rank_result:
            ordered = sorted(rank_result[qid].items(), key=lambda x: x[1],
                             reverse=True)
            for i, (doc_id, score) in enumerate(ordered):
                f.write(f"{qid}\tQ0\t{doc_id}\t{i + 1}\t{score}\t{run_id}\n")


def load_from_trec(input_path: str, as_list: bool = False,
                   max_len_per_q: int = None) -> Union[Run, Dict[str, List[Tuple[str, float]]]]:
    rank_result: dict = {}
    cnt = 0
    with open(input_path) as f:
        for line in f:
            content = line.strip().split("\t")
            if len(content) == 6:
                qid, _, doc_id, _, score, _ = content
            elif len(content) == 3:
                qid, doc_id, score = content
            else:
                raise ValueError(f"invalid TREC line: {line!r}")
            if qid not in rank_result:
                rank_result[qid] = [] if as_list else {}
                cnt = 0
            if max_len_per_q is None or cnt < max_len_per_q:
                if as_list:
                    rank_result[qid].append((doc_id, float(score)))
                else:
                    rank_result[qid][doc_id] = float(score)
            cnt += 1
    return rank_result


def load_beir_qrels(qrels_path: str) -> Dict[str, Dict[str, int]]:
    """BEIR tsv qrels: header 'query-id\tcorpus-id\tscore'."""
    qrels: Dict[str, Dict[str, int]] = {}
    with open(qrels_path) as f:
        for i, line in enumerate(f):
            parts = line.strip().split("\t")
            if i == 0 and not parts[-1].lstrip("-").isdigit():
                continue  # header
            qid, docid, score = parts[0], parts[1], int(float(parts[2]))
            qrels.setdefault(qid, {})[docid] = score
    return qrels


def merge_runs_by_score(runs: List[Run], topk: int = None) -> Run:
    """Union of per-shard runs keeping max score per (qid, docid); optionally
    re-truncate to topk (reference merge_retrieval_results_by_score,
    utils.py:258-275)."""
    merged: Run = {}
    for run in runs:
        for qid, docs in run.items():
            tgt = merged.setdefault(qid, {})
            for docid, score in docs.items():
                if docid not in tgt or score > tgt[docid]:
                    tgt[docid] = score
    if topk is not None:
        for qid in merged:
            merged[qid] = dict(sorted(merged[qid].items(),
                                      key=lambda x: x[1],
                                      reverse=True)[:topk])
    return merged

"""The port's copy of visrag_tpu/generation/qa_eval.py (pure Python).

Generation-quality evaluation.

Two protocols, both with reference parity:

1. EVisRAG QA metrics (reference src/evisrag/eval.py:39-151):
   normalize (lowercase, strip punctuation/articles/whitespace), per-prediction
   EM / token-set-subset Acc / token-F1 / hallucination, max over gold answers;
   aggregate split by answer sufficiency, where insufficient queries get the
   gold set {"no relevant information", "insufficient to answer",
   "insufficient to answer the question"} (eval.py:182-188).

2. VisRAG-Gen per-dataset answer checking
   (reference visrag_scripts/generate/generate.py:496-586 +
   generation_utils.py): substring/exact match on normalized text with 5%
   numeric tolerance for chart datasets.
"""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

INSUFFICIENT_GOLD = ["no relevant information", "insufficient to answer",
                     "insufficient to answer the question"]


def normalize_answer_qa(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.strip().split())


def extract_answer_tag(text: str) -> str:
    """<answer>…</answer> extraction (eval.py:114-117)."""
    if "<answer>" in text:
        return text.split("<answer>")[1].split("</answer>")[0]
    return text


def qa_metrics(pred: str, gold_answers: Sequence[str]) -> Dict[str, float]:
    """Per-prediction metrics, max over gold answers (eval.py:53-99)."""
    out = {"em": 0.0, "acc": 0.0, "f1": 0.0, "hallucination": 0.0}
    npred = normalize_answer_qa(pred)
    pred_tokens = npred.split()
    for answer in gold_answers:
        ngold = normalize_answer_qa(answer)
        em = float(npred == ngold)
        acc = float(set(ngold.split()).issubset(set(pred_tokens)))
        gold_tokens = ngold.split()
        common = Counter(pred_tokens) & Counter(gold_tokens)
        num_same = sum(common.values())
        if num_same == 0:
            # reference `continue`s before updating any metric on zero overlap
            continue
        precision = num_same / len(pred_tokens)
        recall = num_same / len(gold_tokens)
        f1 = 2 * precision * recall / (precision + recall + 1e-7)
        hallucination = 1.0
        if ngold == "no relevant information" or npred == "no relevant information":
            if ngold != npred:
                hallucination = 0.0
        out["em"] = max(out["em"], em)
        out["acc"] = max(out["acc"], acc)
        out["f1"] = max(out["f1"], f1)
        out["hallucination"] = max(out["hallucination"], hallucination)
    return out


def evaluate_qa(preds: Sequence[str], golds: Sequence[Sequence[str]],
                is_sufficient: Sequence[bool]) -> Dict[str, float]:
    """Aggregate global/issuff/unsuff (eval.py:103-151). Callers must already
    have replaced insufficient golds with INSUFFICIENT_GOLD."""
    g_em, g_acc, g_f1 = [], [], []
    s_em, s_acc, s_f1 = [], [], []
    u_em = []
    for pred, gold, suff in zip(preds, golds, is_sufficient):
        m = qa_metrics(extract_answer_tag(pred), gold)
        g_em.append(m["em"])
        g_acc.append(m["acc"])
        g_f1.append(m["f1"])
        if suff:
            s_em.append(m["em"])
            s_acc.append(m["acc"])
            s_f1.append(m["f1"])
        else:
            u_em.append(m["em"])

    def mean(xs):
        return sum(xs) / len(xs) if xs else 0.0

    return {"global_em": mean(g_em), "global_acc": mean(g_acc),
            "global_f1": mean(g_f1), "issuff_em": mean(s_em),
            "issuff_acc": mean(s_acc), "issuff_f1": mean(s_f1),
            "unsuff_em": mean(u_em), "cnt_global": len(g_em),
            "cnt_issuff": len(s_em), "cnt_unsuff": len(u_em)}


# --- VisRAG-Gen answer checking --------------------------------------------


def is_numeric(text: str) -> bool:
    try:
        float(text)
        return True
    except (TypeError, ValueError):
        return False


def within_5_percent(pred: str, answer: str) -> bool:
    """Relaxed numeric accuracy (generation_utils.py:113-121)."""
    a = float(answer)
    p = float(pred)
    if a == 0:
        return p == 0
    return abs((p - a) / a) * 100 <= 5


def vqa_normalize(text: str) -> str:
    """Light VQA normalization (whitespace, punctuation spacing) as applied by
    preprocess_text before matching (generation_utils.py:39-104 subset:
    lowercase, strip, collapse whitespace, drop trailing periods)."""
    text = text.replace("\n", " ").replace("\t", " ").strip().lower()
    text = re.sub(r"(?<!\d)\.(?!\d)", "", text)
    return " ".join(text.split())


def check_answer(pred: str, gold: str, *, numeric_tolerance: bool = True) -> bool:
    """Per-dataset correctness: exact/substring on normalized text; 5% numeric
    tolerance when both parse as numbers (generate.py:496-586)."""
    p, g = vqa_normalize(pred), vqa_normalize(gold)
    if numeric_tolerance and is_numeric(p) and is_numeric(g):
        return within_5_percent(p, g)
    return g == p or (len(g) > 0 and g in p)

"""The port's copy of visrag_tpu/generation/gen_eval.py (pure Python).

VisRAG-Gen per-dataset evaluation protocol.

Parity with the reference's visrag_scripts/generate/generate.py:
  * per-dataset prompt construction for the text backend (`get_input_text`,
    :301-352) and image backends (`get_input_image`, :387-418) across
    ChartQA / ArxivQA / PlotQA / MP-DocVQA / SlideVQA / InfoVQA, including
    ArxivQA option-letter prefixing;
  * per-dataset answer checking (`check_responses`, :496-586): VQA text
    normalization, %-symbol reconciliation, 5% numeric tolerance (ChartQA
    always; PlotQA only for originally-non-string golds), option-letter
    compare (ArxivQA), multi-gold lists (MP-DocVQA / InfoVQA);
  * `get_flatten_table` (ChartQA csv → "Table: col | v | v & ..." string,
    generation_utils.py:20-37) and the full `preprocess_text` VQA
    normalization (:39-104). The punct/contraction/number tables are
    evaluation-protocol constants extracted verbatim from the reference into
    data/vqa_normalize.json — paraphrasing them would change scores.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

DATASETS = ("ChartQA", "ArxivQA", "PlotQA", "MP-DocVQA", "SlideVQA",
            "InfoVQA")

_DATA = os.path.join(os.path.dirname(__file__), "data", "vqa_normalize.json")
with open(_DATA) as _f:
    _N = json.load(_f)
_PUNCT: List[str] = _N["punct"]
_CONTRACTIONS: Dict[str, str] = _N["contractions"]
_MANUAL_MAP: Dict[str, str] = _N["manual_map"]
_ARTICLES: List[str] = _N["articles"]
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")


def get_flatten_table(csv_file_path: str) -> str:
    """ChartQA table csv → flat string (generation_utils.py:20-37)."""
    import pandas as pd

    df = pd.read_csv(csv_file_path)
    parts = ["Table:"]
    for column in df.columns:
        parts.append(f" {column}")
        for value in df[column]:
            parts.append(f" | {value}")
        parts.append(" &")
    out = "".join(parts)
    return out.rstrip(" &")


def preprocess_text(text: str) -> str:
    """Full VQA answer normalization (generation_utils.py:39-104)."""
    text = text.replace("\n", " ").replace("\t", " ").strip()
    for p in _PUNCT:
        if (p + " " in text or " " + p in text) or \
                (re.search(_COMMA_STRIP, text) is not None):
            text = text.replace(p, "")
        else:
            text = text.replace(p, " ")
    text = _PERIOD_STRIP.sub("", text, re.UNICODE)
    words = text.lower().split()
    processed = [w for w in (_MANUAL_MAP.get(w, w) for w in words)
                 if w not in _ARTICLES]
    return " ".join(_CONTRACTIONS.get(w, w) for w in processed)


def is_numeric_data(text) -> bool:
    try:
        float(text)
        return True
    except (TypeError, ValueError):
        return False


def is_within_5_percent(responds, answer) -> bool:
    answer = float(answer)
    responds = float(responds)
    return abs((responds - answer) / answer) * 100 <= 5


def _format_options(options: Sequence[str]) -> str:
    """ArxivQA options block with letter prefixes (generate.py:311-330)."""
    options = list(options)
    if any(not o.startswith(chr(65 + i)) for i, o in enumerate(options)):
        options = [f"{chr(65 + i)}. {o.strip()}" for i, o in enumerate(options)]
    return "Options:\n" + "".join(f"{o}\n" for o in options)


_QA_SUFFIX = ("Answer the question using a single word or phrase.\n"
              "Question:{query}\nAnswer:")


def build_text_prompt(dataset: str, query: str, docs: Sequence[str],
                      example: Optional[dict] = None) -> str:
    """Text-RAG prompt (generate.py get_input_text :301-352). `docs` are the
    retrieved text contents (for ChartQA: already-flattened tables)."""
    doc = "\n".join(docs)
    if dataset == "ArxivQA":
        return (f"Hint: {doc}\nQuestion: {query}\n"
                + _format_options(example["options"])
                + "Answer directly with the letter of the correct option"
                  " as the first character.")
    if dataset in DATASETS:
        return f"Image:{doc}\n" + _QA_SUFFIX.format(query=query)
    raise ValueError(f"unknown dataset {dataset}")


def build_image_prompt(dataset: str, query: str,
                       example: Optional[dict] = None) -> str:
    """Page-image prompt (generate.py get_input_image :387-418)."""
    if dataset == "ArxivQA":
        return (f"Question: {query}\n" + _format_options(example["options"])
                + "Answer directly with the letter of the correct option"
                  " as the first character.")
    if dataset in DATASETS:
        return _QA_SUFFIX.format(query=query)
    raise ValueError(f"unknown dataset {dataset}")


def _reconcile_percent(responds: str, answer: str) -> Tuple[str, str]:
    if "%" in responds and "%" not in answer:
        responds = responds.replace("%", "")
    if "%" not in responds and "%" in answer:
        answer = answer.replace("%", "")
    return responds, answer


def check_response(dataset: str, responds: str, answer) -> Tuple[int, str, object]:
    """Per-dataset correctness (generate.py check_responses :496-586).
    Returns (correct, normalized_responds, normalized_answer)."""
    correct = 0
    if dataset == "ChartQA":
        responds = preprocess_text(responds)
        answer = preprocess_text(answer)
        responds, answer = _reconcile_percent(responds, answer)
        if responds == answer:
            correct = 1
        elif is_numeric_data(responds) and is_numeric_data(answer) \
                and answer != "0" and is_within_5_percent(responds, answer):
            correct = 1
    elif dataset == "ArxivQA":
        responds = responds[0].upper()
        answer = answer[0].upper()
        correct = int(responds == answer)
    elif dataset == "PlotQA":
        responds = preprocess_text(responds)
        is_str = isinstance(answer, str)
        answer = preprocess_text(str(answer))
        responds, answer = _reconcile_percent(responds, answer)
        if responds == answer:
            correct = 1
        elif is_numeric_data(responds) and not is_str \
                and float(answer) != 0.0 \
                and is_within_5_percent(responds, answer):
            correct = 1
    elif dataset in ("MP-DocVQA", "InfoVQA"):
        responds = preprocess_text(responds)
        answers = answer if isinstance(answer, list) else [answer]
        answers = [preprocess_text(a) for a in answers]
        if "%" in responds and "%" not in answers[0]:
            responds = responds.replace("%", "")
        if "%" not in responds and "%" in answers[0]:
            answers = [a.replace("%", "") for a in answers]
        correct = int(any(responds == a for a in answers))
        answer = answers
    elif dataset == "SlideVQA":
        responds = preprocess_text(responds)
        answer = preprocess_text(answer)
        responds, answer = _reconcile_percent(responds, answer)
        correct = int(responds == answer)
    else:
        raise ValueError(f"unknown dataset {dataset}")
    return correct, responds, answer


def oracle_docids(qid: str, dataset: str) -> List[str]:
    """Oracle positive page ids from the qid (generate.py :273-283):
    SlideVQA qids are '<doc1>tcy6<doc2>...query_number<n>' (multi-page);
    other datasets strip the trailing '-<suffix>'."""
    if dataset == "SlideVQA":
        return qid.split("query_number")[0].split("tcy6")
    return [qid[:-1 - len(qid.split("-")[-1])]]


def topk_docids(run_for_qid: Dict[str, float], topk: int
                ) -> Tuple[List[str], List[float]]:
    """Top-k page ids + scores from a TREC run row (generate.py :287-298)."""
    items = sorted(run_for_qid.items(), key=lambda kv: kv[1], reverse=True)
    if len(items) < topk:
        raise ValueError("len(docid) < topk!")
    docids = [k for k, _ in items[:topk]]
    scores = [v for _, v in items[:topk]]
    return docids, scores


def gpt4o_backend(api_key: Optional[str] = None, base_url: Optional[str] = None,
                  max_retries: int = 10):
    """GPT-4o answer backend with the reference's retry loop
    (generate.py:353-383). Gated: requires the `openai` package and network
    egress; returns a callable(prompt, images?, max_new_tokens) → str|None."""
    try:
        from openai import OpenAI
    except ImportError as e:  # pragma: no cover - env without openai
        raise RuntimeError("openai package not available in this image") from e
    client = OpenAI(api_key=api_key, base_url=base_url)

    def call(prompt: str, max_new_tokens: int = 20) -> Optional[str]:
        for retry in range(max_retries):
            try:
                resp = client.chat.completions.create(
                    model="gpt-4o",
                    messages=[{"role": "user", "content": [
                        {"type": "text", "text": prompt}]}],
                    max_tokens=max_new_tokens)
                return resp.choices[0].message.content
            except Exception:
                continue
        return None

    return call

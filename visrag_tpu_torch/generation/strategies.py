"""The port's copy of visrag_tpu/generation/strategies.py (pure Python).

VisRAG-Gen generation strategies over retrieved pages.

Parity with the reference (README.md:154-174; visrag_scripts/generate/
generate.py:40, :240-267; openmatch/generation_utils.py concat helpers;
modeling/weighted_selection/MiniCPMV20:394-424):

  page_concatenation — retrieved page images concatenated into ONE image
      (horizontal or vertical, aspect-preserving resize to common height/
      width) → single-image generation;
  multi_image — all top-k pages passed as separate images;
  weighted_selection — generate one answer per single page, weight each
      answer's sequence probability by the softmax of retrieval scores,
      return the argmax: score_i = softmax(doc_scores)_i * exp(seq_logprob_i).
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

from PIL import Image


def horizontal_concat(images: Sequence[Image.Image]) -> Image.Image:
    if not images:
        raise ValueError("empty image list")
    max_h = max(im.height for im in images)
    resized = [im.resize((max(1, round(im.width * max_h / im.height)), max_h),
                         Image.Resampling.BICUBIC) for im in images]
    out = Image.new("RGB", (sum(im.width for im in resized), max_h))
    x = 0
    for im in resized:
        out.paste(im, (x, 0))
        x += im.width
    return out


def vertical_concat(images: Sequence[Image.Image]) -> Image.Image:
    if not images:
        raise ValueError("empty image list")
    max_w = max(im.width for im in images)
    resized = [im.resize((max_w, max(1, round(im.height * max_w / im.width))),
                         Image.Resampling.BICUBIC) for im in images]
    out = Image.new("RGB", (max_w, sum(im.height for im in resized)))
    y = 0
    for im in resized:
        out.paste(im, (0, y))
        y += im.height
    return out


def concat_pages(images: Sequence[Image.Image]) -> Image.Image:
    """Pick concat axis by average aspect (wide pages stack vertically)."""
    avg_ratio = sum(im.width / im.height for im in images) / len(images)
    return vertical_concat(images) if avg_ratio > 1.2 else horizontal_concat(images)


def softmax(xs: Sequence[float]) -> List[float]:
    m = max(xs)
    es = [math.exp(x - m) for x in xs]
    z = sum(es)
    return [e / z for e in es]


def weighted_selection(answers: Sequence[str], seq_logprobs: Sequence[float],
                       doc_scores: Sequence[float]) -> Tuple[str, int]:
    """score_i = softmax(doc_scores)_i * exp(seq_logprob_i); returns
    (best answer, index). Reference weighted_selection/...:394-424."""
    weights = softmax(doc_scores)
    best_i, best = 0, -math.inf
    for i, (w, lp) in enumerate(zip(weights, seq_logprobs)):
        score = w * math.exp(lp)
        if score > best:
            best, best_i = score, i
    return answers[best_i], best_i


def generate_with_strategy(task_type: str, query: str,
                           pages: Sequence[Image.Image],
                           doc_scores: Sequence[float],
                           generate_fn: Callable[[str, List[Image.Image]], Tuple[str, float]],
                           prompt_builder: Callable[[str, int], str],
                           score_fn: Callable[[str, List[Image.Image]],
                                              Tuple[str, float]] = None):
    """Dispatch like generate.py:40 task types.

    generate_fn(prompt, images) → (text, seq_logprob).
    prompt_builder(query, n_images) → prompt string.
    score_fn: beam-scored variant for weighted_selection (the reference
    scores candidates with num_beams=3 sequences_scores, MiniCPMV20
    modeling_minicpmv.py:360-392) — falls back to generate_fn's
    single-sequence cum_logprob when absent (a documented deviation;
    engine backends pass Engine.beam_search here). When score_fn carries a
    `.batched` attribute — score_fn.batched(items) with items a list of
    (prompt, images) → list of (text, score) — weighted_selection scores
    all top-k pages in ONE batched beam call (Engine.beam_search_batched).
    """
    if task_type == "text":
        text, _ = generate_fn(prompt_builder(query, 0), [])
        return text
    if task_type == "page_concatenation":
        img = concat_pages(list(pages))
        text, _ = generate_fn(prompt_builder(query, 1), [img])
        return text
    if task_type == "multi_image":
        text, _ = generate_fn(prompt_builder(query, len(pages)), list(pages))
        return text
    if task_type == "weighted_selection":
        if not pages:
            raise ValueError("weighted_selection needs at least one page")
        fn = score_fn if score_fn is not None else generate_fn
        batched = getattr(fn, "batched", None)
        if batched is not None:
            results = batched([(prompt_builder(query, 1), [img])
                               for img in pages])
            answers = [t for t, _ in results]
            lps = [lp for _, lp in results]
        else:
            answers, lps = [], []
            for img in pages:
                text, lp = fn(prompt_builder(query, 1), [img])
                answers.append(text)
                lps.append(lp)
        best, _ = weighted_selection(answers, lps, list(doc_scores))
        return best
    raise ValueError(f"unknown task_type {task_type!r}")

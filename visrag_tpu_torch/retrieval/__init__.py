"""Encoding and exact top-k search on the GPU, IR metrics and TREC run
files (copies of visrag_tpu's jax-free modules)."""

from .metrics import evaluate_run

__all__ = ["evaluate_run"]

"""Encoding and exact top-k search on the GPU; the metrics are
visrag_tpu's jax-free evaluation, shared as it is."""

from visrag_tpu.retrieval.metrics import evaluate_run

__all__ = ["evaluate_run"]

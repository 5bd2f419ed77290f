"""The exact top-k scan of a batch of queries over the corpus: the
program's `search.topk` span (retrieval.search.topk_single), CUDA events,
ms."""

from portbench import program_spans


def read(run, tracer, result):
    return program_spans.mean_device_ms(tracer, "search.topk")

"""The top-k scan of a batch of queries over the corpus (CUDA events
around retrieval.search.topk_single), ms."""

from portbench import readers


def read(run, tracer, result):
    return readers.mean_ms(tracer, "scan")

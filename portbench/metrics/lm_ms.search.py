"""MiniCPM-2B's time on a batch of queries (CUDA events from the forward
hooks on the LM), ms."""

from portbench import readers


def read(run, tracer, result):
    return readers.mean_ms(tracer, "lm")

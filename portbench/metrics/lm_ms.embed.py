"""MiniCPM-2B's time on an encode batch of pages (CUDA events from the
forward hooks on the LM), ms."""

from portbench import readers


def read(run, tracer, result):
    return readers.mean_ms(tracer, "lm")

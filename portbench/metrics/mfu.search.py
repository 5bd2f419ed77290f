"""Model FLOPs of the window's query batches (the LM on the valid tokens,
the scan) over the window, over the bf16 peak, %."""

from portbench import readers


def read(run, tracer, result):
    return readers.mfu(result, tracer)

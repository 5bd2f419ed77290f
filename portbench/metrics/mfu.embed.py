"""Model FLOPs of the window's page batches (ViT, resampler and LM on the
valid patches and tokens) over the window, over the bf16 peak, %."""

from portbench import readers


def read(run, tracer, result):
    return readers.mfu(result, tracer)

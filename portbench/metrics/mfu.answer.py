"""Model FLOPs of the window's answers (vision tower, prefill, decode and
the LM head on what they need) over the window, over the bf16 peak, %."""

from portbench import readers


def read(run, tracer, result):
    return readers.mfu(result, tracer)

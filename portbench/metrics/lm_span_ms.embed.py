"""MiniCPM-2B's time on an encode batch of pages: the program's
`minicpmv.lm` span, CUDA events, ms."""

from portbench import program_spans


def read(run, tracer, result):
    return program_spans.mean_device_ms(tracer, "minicpmv.lm")

"""The device finish of an encode batch (uploads, pixel normalisation, the
bicubic position operators): the program's `preprocess.finish` span, CUDA
events, ms."""

from portbench import program_spans


def read(run, tracer, result):
    return program_spans.mean_device_ms(tracer, "preprocess.finish")

"""Qwen2.5-VL's vision tower on a request's pages, whether whole or
chunked prefill runs it: the program's `qwen.vision` span
(Qwen25VL.encode_images), CUDA events, ms a request."""

from portbench import program_spans


def read(run, tracer, result):
    return program_spans.mean_device_ms(tracer, "qwen.vision")

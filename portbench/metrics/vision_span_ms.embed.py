"""ViT and resampler time of an encode batch: the program's
`minicpmv.vision` span (MiniCPMV.get_vision_embedding), CUDA events, ms."""

from portbench import program_spans


def read(run, tracer, result):
    return program_spans.mean_device_ms(tracer, "minicpmv.vision")

"""ViT and resampler time of an encode batch (CUDA events from the forward
hooks on the ViT's start and the resampler's end), ms."""

from portbench import readers


def read(run, tracer, result):
    return readers.mean_ms(tracer, "vision")

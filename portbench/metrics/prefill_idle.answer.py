"""Device idle inside the prefills: the idle gaps of the profiled part
whose innermost program span is `engine.prefill` or `qwen.vision`, over
the `engine.prefill` spans' time on the trace's clock, %."""

from portbench import program_spans


def read(run, tracer, result):
    return program_spans.idle_share(tracer, ("engine.prefill",
                                             "qwen.vision"))

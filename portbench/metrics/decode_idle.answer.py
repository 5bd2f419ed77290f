"""Device idle inside the decode loop: the idle gaps of the profiled part
whose innermost program span is `engine.decode`, `engine.decode.step` or
`engine.decode.model`, over the `engine.decode` spans' time on the
trace's clock, %."""

from portbench import program_spans


def read(run, tracer, result):
    return program_spans.idle_share(tracer, ("engine.decode",
                                             "engine.decode.step",
                                             "engine.decode.model"))

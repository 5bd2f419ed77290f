"""Live slots a decode step: the program's `engine.live_slots` at the start
of each profiled decode chunk, their mean, in slots."""

from portbench import program_spans


def read(run, tracer, result):
    return program_spans.mean(program_spans.counters(tracer,
                                                     "engine.live_slots"))

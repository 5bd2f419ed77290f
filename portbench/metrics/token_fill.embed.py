"""Valid tokens over token slots of the profiled encode batches, counted
where the batch is finished (the program's `preprocess.tokens`), %."""

from portbench import program_spans


def read(run, tracer, result):
    return program_spans.fill(tracer, "preprocess.tokens")

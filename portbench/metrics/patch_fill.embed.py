"""Valid patches over slice slots × the patch bucket of the profiled
encode batches, counted where the batch is finished (the program's
`preprocess.patches`), %."""

from portbench import program_spans


def read(run, tracer, result):
    return program_spans.fill(tracer, "preprocess.patches")

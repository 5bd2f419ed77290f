"""The host's time enqueuing the model's decode of one step (28 layers):
the host ms of the `engine.decode.model` spans, their mean, ms."""

from portbench import program_spans


def read(run, tracer, result):
    return program_spans.mean(
        [s.host_ms for s in program_spans.spans(tracer,
                                                "engine.decode.model")])

"""The host's time on one decode step (the model's enqueue, the logit
bias, sampling and the slot state's update): the host ms of the
`engine.decode.step` spans, their mean, ms."""

from portbench import program_spans


def read(run, tracer, result):
    return program_spans.mean(
        [s.host_ms for s in program_spans.spans(tracer,
                                                "engine.decode.step")])

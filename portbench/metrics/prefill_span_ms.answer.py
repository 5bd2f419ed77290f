"""A request's prefill: the device ms of its `engine.prefill` spans (start,
chunks, whole or batched, a batched one split evenly among its requests),
summed per request over the requests whose whole prefill was recorded,
their mean, ms."""

from portbench import program_spans


def read(run, tracer, result):
    return program_spans.mean(
        program_spans.request_prefill_ms(tracer, run).values())

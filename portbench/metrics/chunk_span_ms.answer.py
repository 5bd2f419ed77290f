"""One chunk of chunked prefill: the device ms of an `engine.prefill` span
of kind chunk, their mean, ms."""

from portbench import program_spans


def read(run, tracer, result):
    return program_spans.mean(
        [s.device_ms for s in program_spans.spans(tracer, "engine.prefill")
         if s.attrs.get("kind") == "chunk"])

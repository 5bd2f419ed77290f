"""One decode step of all slots: the device ms of the `engine.decode`
spans (one a decode chunk) over their steps, ms."""

from portbench import program_spans


def read(run, tracer, result):
    chunks = [s for s in program_spans.spans(tracer, "engine.decode")
              if s.device_ms is not None]
    steps = sum(s.attrs.get("steps", 0) for s in chunks)
    return sum(s.device_ms for s in chunks) / steps if steps else None

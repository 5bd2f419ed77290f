"""Device operations a decode step: those that start inside an
`engine.decode` span on the trace's clock, over the spans' steps."""

from portbench import program_spans


def read(run, tracer, result):
    n = program_spans.ops_inside(tracer, "engine.decode")
    steps = sum(s.attrs.get("steps", 0)
                for s in program_spans.spans(tracer, "engine.decode"))
    return n / steps if n is not None and steps else None

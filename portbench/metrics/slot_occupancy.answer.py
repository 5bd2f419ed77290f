"""Live slots a decode step, from the engine's `active` at the start of
each decode chunk, averaged over the window's chunks, in slots."""

import statistics


def read(run, tracer, result):
    states = tracer.counters.get("decode")
    if not states:
        return None
    return statistics.fmean(float(s[1].sum()) for _, s in states)

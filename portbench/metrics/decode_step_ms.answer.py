"""One decode step of all slots: the engine's decode chunks, each
bracketed by device syncs, over their steps, ms."""


def read(run, tracer, result):
    ms = tracer.ms("decode")
    if not ms:
        return None
    return sum(ms) / (len(ms) * run.chunk)

"""Prefill time of a request: the engine's prefill entries (the vision
tower, whole, batched and chunked prefill), each bracketed by device
syncs, summed over the window and divided by the requests served, ms."""


def read(run, tracer, result):
    ms = tracer.ms("prefill")
    if not ms or not result["attempted"]:
        return None
    return sum(ms) / result["attempted"]

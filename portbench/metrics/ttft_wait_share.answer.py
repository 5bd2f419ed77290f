"""The share of a request's time to its first token that is not its own
prefill (other requests' prefills and chunks, decode chunks between
rounds, the host): the median over the requests whose whole prefill was
recorded of 100 × (1 − own prefill device ms ÷ (t_first − t_enqueue)),
%."""

import statistics

from portbench import program_spans


def read(run, tracer, result):
    own = program_spans.request_prefill_ms(tracer, run)
    by_id = {r.request_id: r for _, r in getattr(run, "served", [])}
    shares = []
    for rid, ms in own.items():
        r = by_id[rid]
        if r.t_first is not None and r.t_first > r.t_enqueue:
            shares.append(100.0 * (1.0 - ms / ((r.t_first - r.t_enqueue)
                                                * 1e3)))
    return statistics.median(shares) if shares else None

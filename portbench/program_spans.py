"""What the readers of the program's own spans and counters share
(visrag_tpu_torch/utils/profiling: `span` and `count`, recorded while a
torch profiler runs, so in the profiled part of a traced window alone).

The spans keep host times on `time.time_ns()`, the clock of the
benchmark's own host spans, which `Trace.read` placed on the device
trace's clock by its marker kernel; the same shift places the program's
spans there. Every function returns None where it finds nothing to read:
no trace (the CPU), or a program that records no spans."""

from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional


def _read(tracer):
    """{"spans": [...], "counters": [...]} the program recorded inside the
    profiled part, read once a run; None where there is none."""
    if not hasattr(tracer, "program"):
        tracer.program = None
        shift = clock_shift(tracer)
        try:
            from visrag_tpu_torch.utils import profiling
        except ImportError:
            return None
        recorded = getattr(profiling, "recorded", None)
        if shift is None or recorded is None:
            return None
        spans, counters, _ = recorded()
        lo, hi = (t - shift for t in tracer.trace.window_bounds())
        tracer.program = {
            "spans": [s for s in spans
                      if s.end_ns is not None and lo <= s.start_ns <= hi],
            "counters": [c for c in counters if lo <= c.t_ns <= hi]}
    return tracer.program


def clock_shift(tracer) -> Optional[int]:
    """ns to add to a host time.time_ns() to place it on the trace's
    clock: the first profiled benchmark span's start there less its host
    start (the shift Trace.read measured from its marker)."""
    t = tracer.trace
    if t is None or len(t.spans) < 2 or not tracer.host_spans:
        return None
    return t.spans[1][1] - tracer.host_spans[0][1]


def spans(tracer, name: str) -> list:
    p = _read(tracer)
    return [] if p is None else [s for s in p["spans"] if s.name == name]


def counters(tracer, name: str) -> list:
    p = _read(tracer)
    return [] if p is None else [c.value for c in p["counters"]
                                 if c.name == name]


def mean(values):
    values = [v for v in values if v is not None]
    return statistics.fmean(values) if values else None


def mean_device_ms(tracer, name: str):
    return mean(s.device_ms for s in spans(tracer, name))


def self_device_ms(tracer, name: str) -> List[float]:
    """Each `name` span's device ms less its child spans'."""
    p = _read(tracer)
    if p is None:
        return []
    children: Dict[int, float] = {}
    for s in p["spans"]:
        if s.parent is not None and s.device_ms is not None:
            children[s.parent] = children.get(s.parent, 0.0) + s.device_ms
    return [s.device_ms - children.get(s.id, 0.0)
            for s in spans(tracer, name) if s.device_ms is not None]


def fill(tracer, name: str):
    """100 × the summed first over the summed second of a counter's
    (valid, slots) pairs, %."""
    pairs = counters(tracer, name)
    slots = sum(b for _, b in pairs)
    return 100.0 * sum(a for a, _ in pairs) / slots if slots else None


def on_trace(tracer) -> list:
    """[(span, start, end)] of the program's spans on the trace's clock."""
    p = _read(tracer)
    if p is None:
        return []
    shift = clock_shift(tracer)
    return [(s, s.start_ns + shift, s.end_ns + shift) for s in p["spans"]]


def idle_gaps(tracer) -> list:
    """[(innermost program span around the gap's middle or None, seconds)]
    of every gap between device operations inside the profiled part (the
    harness's rule, with the program's spans), computed once a run."""
    p = _read(tracer)
    if p is None or tracer.trace is None:
        return []
    if "gaps" not in p:
        t = tracer.trace
        lo, hi = t.window_bounds()
        edges = [lo] + [x for iv in t.busy_intervals() for x in iv] + [hi]
        # a sweep over the spans by start: open spans nest, so the
        # innermost around a point is the top of the stack of those open
        order = sorted(on_trace(tracer), key=lambda x: x[1])
        stack, i, out = [], 0, []
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            mid = (a + b) // 2
            while i < len(order) and order[i][1] <= mid:
                while stack and stack[-1][2] < order[i][1]:
                    stack.pop()
                stack.append(order[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            out.append((stack[-1][0] if stack else None, (b - a) / 1e9))
        p["gaps"] = out
    return p["gaps"]


def idle_share(tracer, names) -> Optional[float]:
    """Device idle in gaps whose innermost program span is named in
    `names`, over the time of the outermost of those spans (clipped to
    the profiled part), %."""
    t = tracer.trace
    placed = on_trace(tracer)
    if t is None or not placed:
        return None
    lo, hi = t.window_bounds()
    ids = {s.id: s for s, _, _ in placed}
    inside = [(s, a, b) for s, a, b in placed if s.name in names
              and (s.parent not in ids or ids[s.parent].name not in names)]
    span_s = sum(max(0, min(b, hi) - max(a, lo))
                 for _, a, b in inside) / 1e9
    idle = sum(sec for s, sec in idle_gaps(tracer)
               if s is not None and s.name in names)
    return 100.0 * idle / span_s if span_s > 0 else None


def idle_split(tracer) -> Dict[str, float]:
    """Device idle seconds by the innermost program span's name."""
    out: Dict[str, float] = {}
    for s, sec in idle_gaps(tracer):
        key = "outside the program's spans" if s is None else s.name
        out[key] = out.get(key, 0.0) + sec
    return out


def ops_inside(tracer, name: str) -> Optional[int]:
    """Device operations that start inside a `name` span on the trace's
    clock."""
    t = tracer.trace
    placed = [(a, b) for s, a, b in on_trace(tracer) if s.name == name]
    if t is None or not placed:
        return None
    starts = [o[1] for o in t.ops]           # Trace.read sorts them
    return sum(bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)
               for a, b in placed)


# ---- the engine's requests ------------------------------------------------


def _rids(s) -> tuple:
    r = s.attrs.get("rid")
    return r if isinstance(r, tuple) else (r,)


def request_prefill_ms(tracer, run) -> Dict[int, float]:
    """{request id: its prefill's device ms} over the requests whose whole
    prefill was recorded (a batched prefill split evenly among its
    requests): every real token counted in a recorded `engine.prefill`,
    chunked ones with their start."""
    by_id = {r.request_id: r for _, r in getattr(run, "served", [])}
    ms: Dict[int, float] = {}
    tokens: Dict[int, int] = {}
    whole = set()
    for s in spans(tracer, "engine.prefill"):
        rids = _rids(s)
        kind = s.attrs.get("kind")
        t = s.attrs.get("tokens", 0)
        for j, rid in enumerate(rids):
            if s.device_ms is not None:
                ms[rid] = ms.get(rid, 0.0) + s.device_ms / len(rids)
            tokens[rid] = tokens.get(rid, 0) + \
                (t[j] if isinstance(t, tuple) else t)
            if kind in ("one", "many", "start"):
                whole.add(rid)
    return {rid: v for rid, v in ms.items()
            if rid in whole and rid in by_id
            and tokens[rid] == len(by_id[rid].input_ids)}

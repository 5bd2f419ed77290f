"""The program's spans in one traced run of a cell, and the recorder's
own cost, on a card.

    python3 portbench/span_report.py --workload <cell> --seed <n> \
        --seconds <s> [--out <file.json>]
    python3 portbench/span_report.py --workload <cell> --seed <n> \
        --launches <batches> [--out <file.json>]
    python3 portbench/span_report.py --span-cost [--out <file.json>]

The first runs the cell as `run.py --trace 1` does and prints, as its last
line, one JSON object: the run's per-layer metrics and `correct`; for
each program span name its count and its device and host ms (total and
mean); the device's idle seconds by the innermost program span around
each gap, and the idle outside every program span by the benchmark's
own span there, with its longest gaps; the benchmark's own spans over
the profiled part (the twins' other side); and the live slots by the
benchmark's own `decode` counter over the profiled chunks.

With --launches (a retriever cell), it profiles host and device over a
few batches after the warm-up and gives each kernel's device time to the
program span whose host region launched it: the stage that holds a
kernel, where the host runs ahead of the device and times cannot tell.

--span-cost times `profiling.span()` and `profiling.count()` (and their
parts: a pair of CUDA events, `record_function`) with no profiler
running and with one running (device activity only, as a traced run's),
in ns a call less an empty call's.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _ms(a, b) -> float:
    return a.elapsed_time(b) if hasattr(a, "elapsed_time") else (b - a) * 1e3


def _gap_bounds(t):
    """The trace's idle gaps as (start, end) ns, in Trace.idle_gaps' order."""
    lo, hi = t.window_bounds()
    edges = [lo] + [x for iv in t.busy_intervals() for x in iv] + [hi]
    out = []
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b))
    return out


def launches(cell_name: str, seed: int, batches: int) -> dict:
    """Device time of each kernel by the program span whose host region
    launched it (a profile of host and device activity over `batches`
    batches of a retriever cell, after its warm-up): {span: {"kernel <-
    launching operation": s}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness
    from visrag_tpu_torch.utils import profiling
    cell = harness.load_cell(cell_name)
    kind = harness.load_module(harness.HERE / "traffic"
                               / f"{cell.mix['kind']}.py")
    run = kind.Run(cell, seed, torch.device("cuda"), False)
    run.warmup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in run.batches[:batches]:
            run.apply(**b["raw"]).float().cpu()
        torch.cuda.synchronize()
    names = {s.name for s in profiling.recorded()[0]}
    out = defaultdict(lambda: defaultdict(float))
    for evt in prof.events():
        if not evt.kernels:
            continue
        owner = evt
        while owner is not None and owner.name not in names:
            owner = owner.cpu_parent
        key = "outside the program's spans" if owner is None else owner.name
        for k in evt.kernels:
            out[key][f"{k.name[:80]} <- {evt.name}"] += k.duration / 1e6
    return {"cell": cell_name, "batches": batches, "by_span": {
        k: sorted(v.items(), key=lambda kv: -kv[1])[:8]
        for k, v in out.items()}}


def _placement(tracer) -> dict:
    """The device near each span's start, as the clock shift places it:
    the median over a name's spans of the last operation to end before
    the start and the first to start after it, us from the start."""
    from portbench import program_spans
    t = tracer.trace
    starts = [o[1] for o in t.ops]
    ends = sorted(o[2] for o in t.ops)
    near = defaultdict(list)
    for s, a, _ in program_spans.on_trace(tracer):
        i = bisect.bisect_left(starts, a)
        j = bisect.bisect_left(ends, a) - 1
        if i < len(starts) and j >= 0:
            near[s.name].append(((ends[j] - a) / 1e3,
                                 (starts[i] - a) / 1e3, t.ops[i][0][:60]))
    out = {}
    for name, v in near.items():
        firsts = [x[2] for x in v]
        out[name] = {"n": len(v),
                     "last_end_us": statistics.median(x[0] for x in v),
                     "first_start_us": statistics.median(x[1] for x in v),
                     "first_op": max(set(firsts), key=firsts.count)}
    return out


def report(cell_name: str, seed: int, seconds: float) -> dict:
    from portbench import harness, program_spans
    from visrag_tpu_torch.utils import profiling
    cell = harness.load_cell(cell_name)
    seen = {}

    def patch(run):
        inner = run.instrument

        def instrument(tracer):
            seen["tracer"] = tracer
            inner(tracer)
        run.instrument = instrument
        seen["run"] = run

    out = harness.run_cell(cell, seed, seconds, True, device="cuda",
                           t_start=T_START, patch=patch)
    tracer = seen["tracer"]
    program = program_spans._read(tracer) or {"spans": [], "counters": []}
    by_name = defaultdict(list)
    for s in program["spans"]:
        by_name[s.name].append(s)
    spans = {}
    for name, ss in by_name.items():
        dev = [s.device_ms for s in ss if s.device_ms is not None]
        host = [s.host_ms for s in ss]
        spans[name] = {"n": len(ss), "device_ms": sum(dev),
                       "device_ms_mean": statistics.fmean(dev) if dev
                       else None, "host_ms": sum(host),
                       "host_ms_mean": statistics.fmean(host)}
    t = tracer.trace
    outside = defaultdict(float)
    top = []
    if t is not None:
        lo = t.window_bounds()[0]
        placed = sorted(program_spans.on_trace(tracer), key=lambda x: x[2])
        ends = [e for _, _, e in placed]
        gaps = program_spans.idle_gaps(tracer)
        # the harness names the same gaps, in the same order, by its spans
        for (s, sec), (bname, _), (a, b) in zip(gaps, t.idle_gaps(),
                                                _gap_bounds(t)):
            if s is not None:
                continue
            outside[bname] += sec
            before = bisect.bisect_right(ends, (a + b) // 2) - 1
            top.append(((a - lo) / 1e6, sec * 1e3, bname,
                        placed[before][0].name if before >= 0 else None))
        top.sort(key=lambda x: -x[1])
    bench = {}
    for name, marks in tracer.marks.items():
        ms = [_ms(a, b) for a, b, profiled in marks if profiled]
        if ms:
            bench[name] = {"n": len(ms), "ms_mean": statistics.fmean(ms),
                           "ms": sum(ms)}
    live = [float(state[1].sum()) for profiled, state
            in tracer.counters.get("decode", []) if profiled]
    return {
        "cell": cell_name, "seed": seed, "correct": out.correct,
        "metrics": {k: v["value"] for k, v in out.metrics.items()},
        "device": out.device, "program_spans": spans,
        "dropped": profiling.recorded()[2],
        "idle_by_program_span": program_spans.idle_split(tracer),
        "idle_s": (t.window_s - t.busy_s()) if t is not None else None,
        "bench_spans_profiled": bench,
        "outside_idle_by_bench_span": outside,
        "outside_gaps_top": top[:12],
        "placement": _placement(tracer) if t is not None else {},
        "live_slots_bench_profiled": statistics.fmean(live) if live
        else None}


def span_cost(n: int = 20_000) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from visrag_tpu_torch.utils import profiling
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()

    def empty():
        pass

    def one_span():
        with profiling.span("x"):
            pass

    def one_span_attrs():
        with profiling.span("engine.prefill", kind="chunk", rid=3,
                            tokens=2048, padded=2048):
            pass

    def one_count():
        profiling.count("c", 1)

    def events():
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        b.record()

    def record_function():
        with torch.profiler.record_function("x"):
            pass

    fns = {"span": one_span, "span_with_attrs": one_span_attrs,
           "count": one_count, "two_cuda_events": events,
           "record_function": record_function}

    def per_call(fn):
        best = None
        for _ in range(3):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                fn()
            ns = (time.perf_counter_ns() - t0) / n
            best = ns if best is None else min(best, ns)
        return best

    base = per_call(empty)
    off = {k: per_call(f) - base for k, f in fns.items()}
    profiling.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        assert profiling.recording()
        base_on = per_call(empty)
        on = {k: per_call(f) - base_on for k, f in fns.items()}
        torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    spans, counters, dropped = profiling.recorded()
    read_ns = (time.perf_counter_ns() - t0) / max(1, len(spans))
    profiling.clear()
    return {"ns_off": off, "ns_on": on, "empty_call_ns": base,
            "recorded_spans": len(spans), "recorded_counters": len(counters),
            "dropped": dropped, "recorded_ns_per_span": read_ns,
            "device": torch.cuda.get_device_name(0), "calls": n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--span-cost", action="store_true")
    ap.add_argument("--launches", type=int, default=0,
                    help="batches of a retriever cell to attribute "
                    "kernels by launching span (host and device profile)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("span_report: needs a CUDA device", file=sys.stderr)
        return 3
    if args.span_cost:
        res = span_cost()
    elif args.launches:
        res = launches(args.workload, args.seed, args.launches)
    else:
        res = report(args.workload, args.seed, args.seconds)
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

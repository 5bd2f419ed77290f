"""The harness: find a cell's files by the names in BENCHMARK.json, set up
its traffic kind, warm up, measure for the window, judge the outputs
against the plain reference, and print the result line.

A cell is an entry of BENCHMARK.json's `workloads`. Its files:

  configs/<config>.json   the configuration as it is run (BENCHMARK.json's
                          `configs[].file`)
  mixes/<traffic>.json    the traffic mix: its `kind` and every parameter
  traffic/<kind>.py       the general generator and runner of that kind
  limits/<cell>.json      the limit of each number that decides `correct`
  metrics/<metric>.py     one reader per per-layer metric

Every timing of a traced run (`--trace 1`) comes from the instrumentation
that `Tracer` installs; the measured run (`--trace 0`) installs none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "visrag_tpu")


def load_module(path: Path):
    """Import a file of the benchmark by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def load_cell(name: str, bench_path: Path = None) -> Cell:
    """The cell `name` with its configuration, mix, limits and metrics."""
    bench = json.loads((bench_path or ROOT / "BENCHMARK.json").read_text())
    works = {w["name"]: w for w in bench["workloads"]}
    if name not in works:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(works)})")
    w = works[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((HERE / "mixes" / f"{w['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, w, config, mix, limits, e2e, per_layer)


def log(msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole (visrag_tpu_torch is not visrag_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def judge(readings, limits: dict):
    """[(name, value)] against the cell's limits → (whether every value is
    finite and within its limit, [(name, value, limit)])."""
    compared = [(name, value, float(limits[name]["limit"]))
                for name, value in readings]
    return all(math.isfinite(v) and v <= lim for _, v, lim in compared), \
        compared


# ---- tracing ----------------------------------------------------------------


def maybe_span(tracer, name: str):
    """tracer.span(name), or nothing without a tracer."""
    return contextlib.nullcontext() if tracer is None else tracer.span(name)


class Tracer:
    """Spans, timers and counters of a traced run; all off when `on` is
    False. On a card the timers are CUDA events read after the window, and
    the profiled part of the window is a torch.profiler trace of the
    device's activity alone (recording every host operation as well slowed
    the host-paced decode loop threefold); the benchmark's own spans are
    kept on the host's clock and placed on the trace's by a marker kernel."""

    def __init__(self, on: bool, device):
        self.on = on
        self.cuda = torch.device(device).type == "cuda"
        self.marks: Dict[str, list] = defaultdict(list)
        self.open: Dict[str, tuple] = {}
        self.counters: Dict[str, list] = defaultdict(list)
        self.trace = None            # the profiled part, once read
        self.profiling = False       # inside the profiled part
        self.profiled: dict = {}     # what the kind did while profiling
        self.host_spans: List[tuple] = []   # (name, start ns, end ns)
        self.overhead_s = 0.0        # the profiler's own start and stop

    def _stamp(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def begin(self, name: str):
        if self.on:
            self.open[name] = (self._stamp(), time.time_ns())

    def end(self, name: str):
        if not self.on:
            return
        start, t0 = self.open.pop(name)
        self.marks[name].append((start, self._stamp(), self.profiling))
        if self.profiling:
            self.host_spans.append((name, t0, time.time_ns()))

    @contextlib.contextmanager
    def span(self, name: str):
        self.begin(name)
        try:
            yield
        finally:
            self.end(name)

    def hook(self, module, name: str, end_module=None):
        """Time `module`'s forward (to the end of `end_module`'s, when
        given) as the span `name`."""
        if not self.on:
            return
        module.register_forward_pre_hook(lambda *a: self.begin(name))
        (end_module or module).register_forward_hook(
            lambda *a: self.end(name))

    def sync_wrap(self, obj, method: str, name: str, before=None):
        """Replace obj.method by a call bracketed by device syncs and timed
        on the host as the span `name`; before(*args) runs first."""
        if not self.on:
            return
        fn = getattr(obj, method)

        def timed(*a, **kw):
            if before is not None:
                before(*a, **kw)
            if self.cuda:
                torch.cuda.synchronize()
            t0, ns = time.perf_counter(), time.time_ns()
            out = fn(*a, **kw)
            if self.cuda:
                torch.cuda.synchronize()
            self.marks[name].append((t0, time.perf_counter(),
                                     self.profiling))
            if self.profiling:
                self.host_spans.append((name, ns, time.time_ns()))
            return out
        setattr(obj, method, timed)

    def count(self, name: str, value):
        if self.on:
            self.counters[name].append(value)

    def ms(self, name: str) -> List[float]:
        """Durations of the span `name` in ms (after the window's sync)."""
        out = []
        for a, b, _ in self.marks.get(name, []):
            out.append(a.elapsed_time(b) if hasattr(a, "elapsed_time")
                       else (b - a) * 1e3)
        return out

    @contextlib.contextmanager
    def profile(self):
        """The profiled part of a traced window (on a card only); a kind
        may end it early with stop_profile(). The trace is read after the
        window (read_trace), outside its time."""
        self.start_profile()
        try:
            yield
        finally:
            self.stop_profile()

    def start_profile(self):
        if not (self.on and self.cuda):
            return
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        t = time.perf_counter()
        prof = profile(activities=[ProfilerActivity.CUDA],
                       record_shapes=False, with_stack=False,
                       profile_memory=False)
        prof.__enter__()
        self.profiling = True
        marker = time.time_ns()
        torch.cuda._sleep(1000)          # spin_kernel: the clocks' link
        torch.cuda.synchronize()
        self._prof = (prof, marker, time.perf_counter(), time.time_ns())
        self.overhead_s += self._prof[2] - t

    def stop_profile(self):
        if getattr(self, "_prof", None) is None:
            return
        prof, marker, t0, ns0 = self._prof
        self._prof = None
        torch.cuda.synchronize()
        t1, ns1 = time.perf_counter(), time.time_ns()
        self.profiling = False
        prof.__exit__(None, None, None)
        self.overhead_s += time.perf_counter() - t1
        self._done = (prof, t1 - t0, marker, (ns0, ns1))

    def read_trace(self):
        """Read the profiled part's trace (after the window closed)."""
        done = getattr(self, "_done", None)
        if done is not None:
            prof, window_s, marker, ns = done
            self.trace = Trace.read(prof, window_s, marker, ns,
                                    self.host_spans)
            self._done = None


def _ns(e, what):
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, what + "_us")() * 1000)


@dataclasses.dataclass
class Trace:
    """The device operations and the benchmark's host spans of the
    profiled part of a window, on one clock (ns)."""
    ops: List[tuple]           # (name, start, end) on the device
    spans: List[tuple]         # (name, start, end) host spans of the bench
    window_s: float

    @classmethod
    def read(cls, prof, window_s: float, marker_ns: int, window_ns: tuple,
             host_spans: List[tuple]) -> "Trace":
        """The device's operations from the profiler; the host spans and
        the window moved onto the trace's clock by the marker kernel,
        launched at host time marker_ns."""
        ops = []
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                start = _ns(e, "start")
                ops.append((e.name(), start, start + _ns(e, "duration")))
        ops.sort(key=lambda t: t[1])
        spin = [o for o in ops if "spin_kernel" in o[0]]
        shift = spin[0][1] - marker_ns if spin else 0
        ops = [o for o in ops if "spin_kernel" not in o[0]]
        spans = [("window", window_ns[0] + shift, window_ns[1] + shift)]
        spans += [(n, a + shift, b + shift) for n, a, b in host_spans]
        return cls(ops, spans, window_s)

    def kernel_s(self, *needles: str) -> float:
        """Seconds of the device operations whose name holds a needle."""
        return sum(e - s for n, s, e in self.ops
                   if any(k in n for k in needles)) / 1e9

    def busy_intervals(self):
        merged = []
        for _, s, e in self.ops:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def window_bounds(self):
        w = [s for s in self.spans if s[0] == "window"]
        if w:
            return w[0][1], w[0][2]
        if not self.ops:
            return 0, 0
        return self.ops[0][1], self.ops[-1][2]

    def idle_gaps(self):
        """[(host span covering the gap, seconds)] of every gap between
        device operations inside the window, named by the innermost
        benchmark span around its middle."""
        lo, hi = self.window_bounds()
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        inner = [s for s in self.spans if s[0] != "window"]
        out = []
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            mid = (a + b) // 2
            around = [s for s in inner if s[1] <= mid <= s[2]]
            name = min(around, key=lambda s: s[2] - s[1])[0] if around \
                else "outside the benchmark's spans"
            out.append((name, (b - a) / 1e9))
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops = defaultdict(float)
        for n, s, e in self.ops:
            ops[n[:160]] += (e - s) / 1e9
        gaps = defaultdict(float)
        for n, sec in self.idle_gaps():
            gaps[n] += sec
        best = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(ops), "idle_gaps": best(gaps)}


# ---- one run of a cell ---------------------------------------------------


@dataclasses.dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    compared: List[tuple]          # (name, value, limit)
    breakdown: Optional[dict] = None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", tiny: bool = False, t_start: float = None,
             patch=None) -> Outcome:
    """One run: set-up, warm-up, the window, the check. `tiny` builds the
    configuration's small test preset (CPU tests); `patch(run)` is called
    after set-up, before the warm-up (the tests plant faults with it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    kind = load_module(HERE / "traffic" / f"{cell.mix['kind']}.py")
    log(f"{cell.name}: imports {time.perf_counter() - t_start:.1f} s")
    run = kind.Run(cell, seed, device, tiny)
    if patch is not None:
        patch(run)
    log(f"{cell.name}: set-up {time.perf_counter() - t_start:.1f} s")
    run.warmup()
    tracer = Tracer(trace, device)
    run.instrument(tracer)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"{cell.name}: warm-up done, setup_s {setup_s:.1f}")
    result = run.window(seconds, tracer)
    if device.type == "cuda":
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    t_read = time.perf_counter()
    tracer.read_trace()
    if trace:
        log(f"{cell.name}: trace read {time.perf_counter() - t_read:.1f} s")
    metrics = {}
    per_layer = {}
    if trace:
        for m in cell.per_layer:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py")
            value = reader.read(run, tracer, result)
            if value is not None:
                per_layer[m["name"]] = {"value": value, "unit": m["unit"]}
        metrics = per_layer
    else:
        values = dict(result["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    log(f"{cell.name}: window {result['elapsed']:.1f} s, "
        f"{result['attempted']} attempted, metrics {result['metrics']}")
    run.release()
    t_check = time.perf_counter()
    within, compared = judge(run.check(), cell.limits)
    log(f"{cell.name}: check {time.perf_counter() - t_check:.1f} s")
    correct = within and result["failed"] == 0
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = Outcome(correct, result["attempted"], result["failed"], metrics,
                  dev, compared)
    if trace and tracer.trace is not None:
        dev["busy_s"] = tracer.trace.busy_s()
        dev["window_s"] = tracer.trace.window_s
        out.breakdown = tracer.trace.breakdown()
    return out


def result_line(out: Outcome) -> dict:
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": out.metrics,
            "device": out.device}
    if out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["compared"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in out.compared}
    return line


def main(args, t_start: float) -> int:
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad} (jax, jaxlib, flax or "
              f"the JAX package); no result", file=sys.stderr)
        return 4
    for name, v, lim in out.compared:
        print(f"portbench: {name} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result_line(out)), flush=True)
    return 0

"""Profiling: torch.profiler traces, and the program's spans and counters.

Counterpart of visrag_tpu/utils/profiling.py: `trace(logdir)` records
the host and, where there is a card, its kernels (CUPTI) and writes a
Chrome trace (`logdir/trace.json`, for chrome://tracing or Perfetto).
utils/tracker.py times host phases.

    with profiling.trace("prof/") as prof:
        out = step(...)
        torch.cuda.synchronize()
    prof.key_averages()

`span(name, **attrs)` marks one stage of the program (the encode's
finish, ViT and LM, the scan, the engine's prefills and decode steps) and
`count(name, value)` records a quantity where the work happens. Both
record only while a torch profiler runs, whatever its activities; with
none running, `span()` returns one shared no-op object (no clock read, no
event) and `count()` returns at once. A recorded span keeps its name, its
id and the id of the span around it on its thread, its attributes, its
host start and end (`time.time_ns()`), and on a CUDA device a pair of CUDA
events on the current stream, read as `device_ms` by `recorded()` (after
the caller's sync). It also enters `torch.profiler.record_function(name)`,
so that a trace that records host activity shows it beside the kernels.

    with profiling.trace("prof/"):
        with profiling.span("engine.prefill", kind="one", rid=7):
            ...
    spans, counters, dropped = profiling.recorded()
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

TRACE_FILE = "trace.json"
MAX_RECORDS = 200_000        # spans and counters kept until clear()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA where available) → the profiler,
    whose Chrome trace is written to logdir/trace.json on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


# ---- spans and counters ------------------------------------------------


@dataclasses.dataclass
class Span:
    name: str
    id: int
    parent: Optional[int]           # the enclosing span on this thread
    attrs: Dict[str, Any]
    start_ns: int                   # host, time.time_ns()
    end_ns: Optional[int] = None    # None while open
    device_ms: Optional[float] = None
    _events: Any = dataclasses.field(default=None, repr=False)

    @property
    def host_ms(self) -> Optional[float]:
        return None if self.end_ns is None \
            else (self.end_ns - self.start_ns) / 1e6


@dataclasses.dataclass
class Counter:
    name: str
    value: Any
    t_ns: int                       # host, time.time_ns()


class _NoSpan:
    """What span() returns while no profiler runs."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Recorder:
    def __init__(self, cap: int):
        self.cap = cap
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count(1)
        self.spans: List[Span] = []
        self.counters: List[Counter] = []
        self.dropped = 0

    def stack(self) -> List[Span]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def admit(self) -> bool:
        """Room for one more record (under the lock); else one more
        dropped."""
        if len(self.spans) + len(self.counters) < self.cap:
            return True
        self.dropped += 1
        return False


_REC = _Recorder(MAX_RECORDS)


def recording() -> bool:
    """Whether a torch profiler runs, so that spans and counters record."""
    return _autograd_profiler._is_profiler_enabled


class _LiveSpan:
    __slots__ = ("span", "rf")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.span = Span(name, 0, None, attrs, 0)
        self.rf = None

    # the span's clocks are read first on entry and last on exit, so that
    # its own cost lies inside it
    def __enter__(self):
        s = self.span
        s.start_ns = time.time_ns()
        st = _REC.stack()
        with _REC.lock:
            if not _REC.admit():
                self.span = None
                return self
            s.id = next(_REC.ids)
            _REC.spans.append(s)
        s.parent = st[-1].id if st else None
        st.append(s)
        if torch.cuda.is_initialized():
            s._events = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
            s._events[0].record()
        self.rf = torch.profiler.record_function(s.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        s = self.span
        if s is None:
            return False
        self.rf.__exit__(*exc)
        st = _REC.stack()
        if st and st[-1] is s:
            st.pop()
        if s._events is not None:
            s._events[1].record()
        s.end_ns = time.time_ns()
        return False


def span(name: str, **attrs):
    """A context manager marking one stage of the program; recorded only
    while a torch profiler runs (else the shared no-op NO_SPAN)."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return _LiveSpan(name, attrs)


def count(name: str, value) -> None:
    """Record `value` under `name` (only while a torch profiler runs)."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    c = Counter(name, value, time.time_ns())
    with _REC.lock:
        if _REC.admit():
            _REC.counters.append(c)


def recorded() -> Tuple[List[Span], List[Counter], int]:
    """→ (the spans in the order they opened, the counters, how many of
    either were dropped at the cap). Reads each closed span's CUDA events
    into device_ms, waiting for its end event, and each tensor in a
    counter's value (or in a tuple that is its value) into a list, so that
    recording a device quantity costs no sync; call it after the work's
    sync."""
    with _REC.lock:
        spans, counters, dropped = list(_REC.spans), list(_REC.counters), \
            _REC.dropped
    for s in spans:
        if s._events is not None and s.end_ns is not None:
            start, end = s._events
            end.synchronize()
            s.device_ms = start.elapsed_time(end)
            s._events = None
    for c in counters:
        if isinstance(c.value, torch.Tensor):
            c.value = c.value.tolist()
        elif isinstance(c.value, tuple) and any(
                isinstance(x, torch.Tensor) for x in c.value):
            c.value = tuple(x.tolist() if isinstance(x, torch.Tensor) else x
                            for x in c.value)
    return spans, counters, dropped


def clear() -> None:
    """Forget every recorded span and counter."""
    with _REC.lock:
        _REC.spans.clear()
        _REC.counters.clear()
        _REC.dropped = 0

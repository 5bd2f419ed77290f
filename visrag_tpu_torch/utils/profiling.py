"""Profiling: torch.profiler traces.

Counterpart of visrag_tpu/utils/profiling.py: `trace(logdir)` records
the host and, where there is a card, its kernels (CUPTI) and writes a
Chrome trace (`logdir/trace.json`, for chrome://tracing or Perfetto);
`maybe_trace()` traces only when VISRAG_PROFILE_DIR names a directory;
`annotate(name)` marks a region on the timeline. utils/tracker.py times
host phases and utils/flops.py gives MFU.

    with profiling.trace("prof/") as prof:
        out = step(...)
        torch.cuda.synchronize()
    prof.key_averages()
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch

TRACE_FILE = "trace.json"


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


@contextlib.contextmanager
def maybe_trace(env: str = "VISRAG_PROFILE_DIR") -> Iterator[Optional[str]]:
    """Trace only when the env var names a directory; yields it (or
    None)."""
    logdir = os.environ.get(env)
    if not logdir:
        yield None
        return
    with trace(logdir):
        yield logdir


def annotate(name: str):
    """A named region on the trace's timeline."""
    return torch.profiler.record_function(name)

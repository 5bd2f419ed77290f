"""What the per-layer metric readers share: means of the benchmark's
spans, the window's model FLOPs over the bf16 peak, the device's idle
share and the kernels' roofline shares from the profiled part of the
window. Every function returns None where it finds nothing to read."""

from __future__ import annotations

import statistics

from portbench import counts

K1 = "attention_fwd_wgmma_kernel"
K3 = "band_fwd_kernel"
K5 = "paged_decode_kernel"


def mean_ms(tracer, name: str):
    ms = tracer.ms(name)
    return statistics.fmean(ms) if ms else None


def mfu(result: dict, tracer):
    """Model FLOPs the window's inputs need, over its length less the
    profiler's own start and stop, over the bf16 peak of one H100, %."""
    seconds = result.get("elapsed", 0.0) - tracer.overhead_s
    if seconds <= 0:
        return None
    return 100.0 * result["flops"] / seconds / counts.PEAK_BF16_FLOPS


def idle(tracer):
    """Share of the profiled window in which no device operation ran, %."""
    t = tracer.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s() / t.window_s)


def roofline(tracer, kernel: str, bound_s: float):
    """The kernel's least time for the profiled part's work over the time
    it took there, in %."""
    t = tracer.trace
    if t is None or bound_s <= 0:
        return None
    spent = t.kernel_s(kernel)
    return 100.0 * bound_s / spent if spent > 0 else None

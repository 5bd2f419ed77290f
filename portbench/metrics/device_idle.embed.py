"""Share of the profiled part of the window in which no operation ran on
the device (torch.profiler's device activity), %."""

from portbench import readers


def read(run, tracer, result):
    return readers.idle(tracer)

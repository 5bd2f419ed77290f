"""Model FLOPs of the window's prefills (the vision tower on every page,
the text stack on every prompt token, the LM head at the prompt's end)
over the time of the engine's prefill entries (each bracketed by device
syncs), over the bf16 peak, %."""

from portbench import counts


def read(run, tracer, result):
    ms = tracer.ms("prefill")
    if not ms:
        return None
    flops = sum(run.pool[i]["flops"] for i, _ in run.served)
    return 100.0 * flops / (sum(ms) / 1e3) / counts.PEAK_BF16_FLOPS

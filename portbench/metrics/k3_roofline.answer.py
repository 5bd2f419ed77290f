"""K3 (csrc/attention_kvgrid_hopper.cu) in the profiled burst: the least
time of the vision tower's attention (the window layers within each
window, the full layers within each image; 16 heads of 80), one launch a
layer a request, over its device time, %."""

from portbench import counts, readers


def read(run, tracer, result):
    v = run.ref_cfg["vision_config"]
    heads = v["num_heads"]
    d = v["hidden_size"] // heads
    n_full = len(v["fullatt_block_indexes"])
    bound = 0.0
    for profiled, i in tracer.counters.get("vision", []):
        if not profiled:
            continue
        win, imgs = [], []
        for h, w in run.pool[i]["sizes"]:
            ws, n = run.windows(h, w)
            win += ws
            imgs.append(n)
        bound += (v["depth"] - n_full) * counts.bound_s(
            *counts.k3_counts(win, heads, d)) \
            + n_full * counts.bound_s(*counts.k3_counts(imgs, heads, d))
    return readers.roofline(tracer, readers.K3, bound)

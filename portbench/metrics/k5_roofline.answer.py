"""K5 (csrc/paged_decode_hopper.cu) in the profiled burst: the least time
of each decode step's attention over the live slots' cached tokens (28
heads, 4 kv heads of 128, bf16 pools), one launch a layer a step, over its
device time, %."""

from portbench import counts, readers


def read(run, tracer, result):
    t = run.ref_cfg
    heads, kvh = t["num_attention_heads"], t["num_key_value_heads"]
    d = t["hidden_size"] // heads
    bound = 0.0
    for profiled, (lengths, active, gen_left) in \
            tracer.counters.get("decode", []):
        if not profiled:
            continue
        for step in range(run.chunk):
            live = [int(n) + step + 1 for n, a, g in
                    zip(lengths, active, gen_left) if a and step < g]
            if live:
                bound += t["num_hidden_layers"] * counts.bound_s(
                    *counts.k5_counts(live, heads, kvh, d))
    return readers.roofline(tracer, readers.K5, bound)

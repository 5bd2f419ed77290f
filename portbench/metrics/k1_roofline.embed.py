"""K1 (csrc/attention_lengths_hopper.cu) in the profiled encode batches:
the least time of its flat launches (the ViT: each slice's valid patches,
16 heads of 72, not causal) and stacked launches (the LM: each prompt's
tokens, 36 heads of 64, causal), one per layer, over its device time, %."""

from portbench import counts, readers


def read(run, tracer, result):
    v, llm = run.ref_cfg["vision"], run.ref_cfg["llm"]
    bound = 0.0
    for i in tracer.profiled.get("batches", []):
        b = run.batches[i % len(run.batches)]
        flat = counts.k1_counts(b["slices"], v["num_heads"],
                                v["embed_dim"] // v["num_heads"], False)
        heads = llm["num_attention_heads"]
        stacked = counts.k1_counts(b["tokens"], heads,
                                   llm["hidden_size"] // heads, True,
                                   llm["num_key_value_heads"])
        bound += v["depth"] * counts.bound_s(*flat) \
            + llm["num_hidden_layers"] * counts.bound_s(*stacked)
    return readers.roofline(tracer, readers.K1, bound)

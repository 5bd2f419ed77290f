"""K8 (csrc/attention_chunk_hopper.cu) in the profiled burst: the least
time of chunked prefill's attention, one launch a layer a chunk, over its
device time, %. The program records each launch's shape as the counter
`attention.chunk` (heads, kv heads, d, C, L, each batch row's start); a
program without it (no chunk kernel) reads nothing."""

from portbench import counts, program_spans, readers

# K8's instance of the Hopper forward body: the only kernel whose name
# holds its mask policy's
K8 = "ChunkMask"


def k8_counts(heads, kv_heads, d, c, L, starts):
    """QK^T and PV over each row's visible keys (key <= start + query, key
    < L); q and the output at `heads`, the gathered k and v at `kv_heads`,
    each read or written once. → (flops, bytes)."""
    visible = sum(min(s + i + 1, L) for s in starts for i in range(c))
    flops = 4 * visible * heads * d
    nbytes = counts.BF16 * len(starts) * d * (2 * c * heads + 2 * L * kv_heads)
    return flops, nbytes


def read(run, tracer, result):
    bound = sum(counts.bound_s(*k8_counts(*v))
                for v in program_spans.counters(tracer, "attention.chunk"))
    return readers.roofline(tracer, K8, bound) if bound > 0 else None

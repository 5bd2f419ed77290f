"""`k8_roofline.answer`: the least time of K8's work, worked out by hand at
a tiny size, over the device time of the launches its needle matches; and
nothing read where the program recorded no `attention.chunk` counter (the
retriever cells, or a program without the chunk kernel) or the trace holds
no K8 launch."""

import pytest

from portbench import counts, harness
from visrag_tpu_torch.utils import profiling

READER = harness.load_module(harness.HERE / "metrics" /
                             "k8_roofline.answer.py")
K8_NAME = ("void visrag::hopper::attention_fwd_wgmma_kernel<128, false, "
           "(anonymous namespace)::ChunkMask>(visrag::hopper::FwdMaps, "
           "visrag::hopper::FwdParams, (anonymous namespace)::ChunkMask::"
           "Params)")
K1_NAME = ("void visrag::hopper::attention_fwd_wgmma_kernel<128, false, "
           "(anonymous namespace)::LengthsMask<true> >(visrag::hopper::"
           "FwdMaps, visrag::hopper::FwdParams, (anonymous namespace)::"
           "LengthsMask<true>::Params)")


def _tracer(monkeypatch, counters, ops):
    """A traced run whose profiled part (host 0-10,000 ns) holds the
    program's counters and these device operations."""
    tracer = harness.Tracer(True, "cpu")
    tracer.host_spans = [("batch", 1000, 9000)]
    tracer.trace = harness.Trace(ops, [("window", 500, 10_500),
                                       ("batch", 1500, 9500)], 10e-6)
    monkeypatch.setattr(profiling, "recorded",
                        lambda: ([], list(counters), 0))
    return tracer


def test_k8_counts_by_hand():
    """2 heads over 1 kv head of 4, a 3-row chunk at start 2 over L 5: the
    rows see 3, 4 and 5 keys, 12 pairs: 4 x 12 x 2 x 4 = 384 operations;
    q and o 2 x 3 x 2 x 4 bf16 values, k and v 2 x 5 x 1 x 4: 176 bytes,
    which bound the call. A row at start 4 sees at most L keys."""
    assert READER.k8_counts(2, 1, 4, 3, 5, [2]) == (384, 176)
    assert counts.bound_s(384, 176) == 176 / counts.PEAK_BYTES
    # start 4: 5, 5, 5 keys (L caps them); two batch rows add up
    assert READER.k8_counts(2, 1, 4, 3, 5, [4])[0] == 4 * 15 * 2 * 4
    assert READER.k8_counts(2, 1, 4, 3, 5, [2, 4]) == (
        384 + 4 * 15 * 2 * 4, 352)


def test_k8_roofline_over_the_needles_launches(monkeypatch):
    """The summed bound of the profiled counters over the time of the
    launches whose name holds "ChunkMask", and not K1's on the same
    body."""
    counters = [profiling.Counter("attention.chunk", (2, 1, 4, 3, 5, [2]),
                                  1000),
                profiling.Counter("attention.chunk", (2, 1, 4, 3, 5, [2]),
                                  2000),
                profiling.Counter("other", 7, 3000)]
    ops = [(K8_NAME, 1000, 1500), (K1_NAME, 2000, 4000),
           (K8_NAME, 5000, 5500)]
    tracer = _tracer(monkeypatch, counters, ops)
    want = 100.0 * 2 * (176 / counts.PEAK_BYTES) / 1e-6
    assert READER.read(None, tracer, {}) == pytest.approx(want)


@pytest.mark.parametrize("counters,ops", [
    ([], [(K8_NAME, 1000, 1500)]),
    ([profiling.Counter("attention.chunk", (2, 1, 4, 3, 5, [2]), 1000)],
     [(K1_NAME, 1000, 1500)]),
    ([profiling.Counter("engine.live_slots", 3, 1000)], [])],
    ids=["no_counter", "no_k8_launch", "other_counters"])
def test_k8_roofline_reads_nothing(monkeypatch, counters, ops):
    tracer = _tracer(monkeypatch, counters, ops)
    assert READER.read(None, tracer, {}) is None

"""The readers of the program's own spans and counters
(portbench/program_spans.py and the metrics that use it): the clock shift
and the idle attribution on a synthetic trace, the per-request prefill
and wait, the readers on a program that records no spans, and every new
reader returning None in the CPU dry run (no profiler runs there)."""

import json
import types

import pytest

from portbench import harness, program_spans
from visrag_tpu_torch.utils import profiling

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NEW = [m["name"] for m in BENCH["per_layer"] if "program_spans" in
       (harness.HERE / "metrics" / f"{m['name']}.py").read_text()]
SHIFT = 500


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def _span(name, sid, parent, start, end, device_ms=None, **attrs):
    return profiling.Span(name, sid, parent, attrs, start, end, device_ms)


def _tracer(monkeypatch, spans, counters=()):
    """A traced run: the benchmark's span `batch` at host 1000-9000 placed
    at 1500-9500 on the trace's clock (a shift of 500 ns), the window
    500-10500 there, device operations at 1000-2000, 3000-4000 and
    8000-9000, and the program's recorded spans and counters."""
    tracer = harness.Tracer(True, "cpu")
    tracer.host_spans = [("batch", 1000, 9000)]
    ops = [("k", 1000, 2000), ("k", 3000, 4000), ("k", 8000, 9000)]
    tracer.trace = harness.Trace(ops, [("window", 500, 10_500),
                                       ("batch", 1500, 9500)], 10e-6)
    monkeypatch.setattr(profiling, "recorded",
                        lambda: (list(spans), list(counters), 0))
    return tracer


def _decode_spans():
    # host times; on the trace's clock each is 500 ns later
    return [_span("engine.decode", 1, None, 1000, 8000, 7.0, steps=2),
            _span("engine.decode.step", 2, 1, 1800, 2800, 1.0),
            _span("engine.decode.model", 3, 2, 1900, 2100, 0.5),
            _span("engine.decode.step", 4, 1, 2900, 7900, 1.0),
            _span("outside", 5, None, 20_000, 30_000)]   # past the window


def test_clock_shift_and_idle_attribution(monkeypatch):
    tracer = _tracer(monkeypatch, _decode_spans())
    assert program_spans.clock_shift(tracer) == SHIFT
    assert [s.name for s in program_spans.spans(tracer, "outside")] == []
    got = [(None if s is None else s.name, sec)
           for s, sec in program_spans.idle_gaps(tracer)]
    # gaps 500-1000, 2000-3000, 4000-8000, 9000-10500 by their middles
    assert got == [(None, pytest.approx(500e-9)),
                   ("engine.decode.model", pytest.approx(1000e-9)),
                   ("engine.decode.step", pytest.approx(4000e-9)),
                   (None, pytest.approx(1500e-9))]
    split = program_spans.idle_split(tracer)
    assert split["outside the program's spans"] == pytest.approx(2000e-9)
    # the decode loop's idle over the chunk's 7000 ns on the trace
    assert _reader("decode_idle.answer").read(None, tracer, {}) == \
        pytest.approx(100 * 5000 / 7000)
    # operations starting at 3000 and 8000 lie in the chunk (1500-8500)
    assert _reader("kernels_per_step.answer").read(None, tracer, {}) == 1.0
    assert _reader("decode_span_ms.answer").read(None, tracer, {}) == 3.5
    assert _reader("decode_host_ms.answer").read(None, tracer, {}) == \
        pytest.approx((1000 + 5000) / 2 / 1e6)
    assert _reader("decode_model_host_ms.answer").read(None, tracer, {}) \
        == pytest.approx(200 / 1e6)
    assert _reader("prefill_idle.answer").read(None, tracer, {}) is None


def test_self_time_fill_and_counters(monkeypatch):
    spans = [_span("preprocess.finish", 1, None, 1000, 1500, 2.0),
             _span("visrag_ret.forward", 2, None, 1500, 8000, 10.0),
             _span("minicpmv.vision", 3, 2, 1600, 4000, 4.0),
             _span("minicpmv.lm", 4, 2, 4000, 7000, 5.0)]
    counters = [profiling.Counter("preprocess.tokens", (30, 100), 1000),
                profiling.Counter("preprocess.tokens", (10, 100), 2000),
                profiling.Counter("engine.live_slots", 3, 3000),
                profiling.Counter("engine.live_slots", 4, 4000)]
    tracer = _tracer(monkeypatch, spans, counters)
    assert _reader("encode_self_ms.embed").read(None, tracer, {}) == 1.0
    assert _reader("finish_span_ms.embed").read(None, tracer, {}) == 2.0
    assert _reader("vision_span_ms.embed").read(None, tracer, {}) == 4.0
    assert _reader("lm_span_ms.embed").read(None, tracer, {}) == 5.0
    assert _reader("token_fill.embed").read(None, tracer, {}) == 20.0
    assert _reader("patch_fill.embed").read(None, tracer, {}) is None
    assert _reader("live_slots.answer").read(None, tracer, {}) == 3.5


def test_requests_prefill_and_wait(monkeypatch):
    spans = [_span("engine.prefill", 1, None, 1000, 1100, 6.0,
                   kind="many", rid=(0, 1), tokens=(5, 7), padded=16),
             _span("engine.prefill", 2, None, 1100, 1200, 3.0,
                   kind="start", rid=2),
             _span("qwen.vision", 3, 2, 1110, 1190, 2.0),
             _span("engine.prefill", 4, None, 1200, 1300, 4.0,
                   kind="chunk", rid=2, tokens=16, padded=16),
             _span("engine.prefill", 5, None, 1300, 1400, 5.0,
                   kind="chunk", rid=2, tokens=4, padded=16),
             # request 3's start fell before the profiled part
             _span("engine.prefill", 6, None, 1400, 1500, 1.0,
                   kind="chunk", rid=3, tokens=4, padded=16)]
    reqs = [types.SimpleNamespace(request_id=i, input_ids=[0] * n,
                                  t_enqueue=0.0, t_first=t)
            for i, n, t in ((0, 5, 0.010), (1, 7, 0.003), (2, 20, 0.024),
                            (3, 20, 0.05))]
    run = types.SimpleNamespace(served=[(i, r) for i, r in enumerate(reqs)])
    tracer = _tracer(monkeypatch, spans)
    assert program_spans.request_prefill_ms(tracer, run) == \
        {0: 3.0, 1: 3.0, 2: 12.0}
    assert _reader("prefill_span_ms.answer").read(run, tracer, {}) == 6.0
    assert _reader("chunk_span_ms.answer").read(run, tracer, {}) == \
        pytest.approx(10 / 3)
    assert _reader("vision_span_ms.answer").read(run, tracer, {}) == 2.0
    # waits: 1 - 3/10, 1 - 3/3, 1 - 12/24
    assert _reader("ttft_wait_share.answer").read(run, tracer, {}) == \
        pytest.approx(50.0)


def test_readers_without_the_programs_spans(monkeypatch):
    tracer = _tracer(monkeypatch, _decode_spans())
    monkeypatch.delattr(profiling, "recorded")
    run = types.SimpleNamespace(served=[])
    for name in NEW:
        assert _reader(name).read(run, tracer, {}) is None, name


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_new_readers_read_nothing_in_the_cpu_dry_run(cell):
    c = harness.load_cell(cell)
    seen = {}

    def patch(run):
        inner = run.instrument

        def instrument(tracer):
            seen["tracer"] = tracer
            inner(tracer)
        run.instrument = instrument
        seen["run"] = run

    out = harness.run_cell(c, 2 ** 33 + 19, 0.5, True, device="cpu",
                           tiny=True, patch=patch)
    assert out.correct
    mine = [m["name"] for m in c.per_layer if m["name"] in NEW]
    assert mine
    for name in mine:
        assert _reader(name).read(seen["run"], seen["tracer"], {}) is None

"""The port's spans and counters (visrag_tpu_torch/utils/profiling.py) on
the CPU.

  * off (no profiler running): span() is the shared no-op object and
    nothing is recorded;
  * on, under a CPU torch.profiler: parent ids nest, two threads keep
    separate stacks, the cap drops records and counts them, and the span
    names appear in profiling.trace's trace.json;
  * a tiny Qwen2.5-VL engine run with whole, batched and chunked prefill
    and a vision prompt: the prefill and decode spans come in the
    engine's schedule order (sched_log), `engine.live_slots` is the live
    slots at each decode chunk, each served request's id is on its
    prefill spans, and the vision tower's span sits in its prefill;
  * a tiny VisRAG-Ret encode and scan: the finish, the forward with the
    vision and LM spans inside it, the scan, and fill counters equal to
    the masks' sums.
"""

import json
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from visrag_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _fresh():
    profiling.clear()
    yield
    profiling.clear()


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_records_nothing():
    assert not profiling.recording()
    sp = profiling.span("engine.prefill", kind="one", rid=1)
    assert sp is profiling.NO_SPAN
    assert profiling.span("x") is sp
    with sp:
        profiling.count("engine.live_slots", 3)
    assert profiling.recorded() == ([], [], 0)


def test_on_nests_and_times_on_the_host():
    with _profile():
        assert profiling.recording()
        with profiling.span("outer", kind="a"):
            with profiling.span("inner", rid=(1, 2)):
                profiling.count("c", 5)
            with profiling.span("inner"):
                pass
        with profiling.span("after"):
            pass
    spans, counters, dropped = profiling.recorded()
    assert [s.name for s in spans] == ["outer", "inner", "inner", "after"]
    outer, in1, in2, after = spans
    assert outer.parent is None and after.parent is None
    assert in1.parent == outer.id and in2.parent == outer.id
    assert len({s.id for s in spans}) == 4
    assert outer.attrs == {"kind": "a"} and in1.attrs == {"rid": (1, 2)}
    assert outer.start_ns <= in1.start_ns <= in1.end_ns <= in2.start_ns \
        <= in2.end_ns <= outer.end_ns <= after.start_ns
    assert all(s.device_ms is None for s in spans)      # no card here
    assert [(c.name, c.value) for c in counters] == [("c", 5)]
    assert in1.start_ns <= counters[0].t_ns <= in1.end_ns
    assert dropped == 0


def test_threads_keep_separate_stacks():
    gate = threading.Barrier(2, timeout=30)

    def work(i):
        with profiling.span(f"outer{i}"):
            gate.wait()              # both outer spans open at once
            with profiling.span(f"inner{i}"):
                gate.wait()

    with _profile():
        threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    by = {s.name: s for s in profiling.recorded()[0]}
    assert set(by) == {"outer0", "outer1", "inner0", "inner1"}
    for i in (0, 1):
        assert by[f"inner{i}"].parent == by[f"outer{i}"].id
        assert by[f"outer{i}"].parent is None


def test_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(profiling._REC, "cap", 3)
    with _profile():
        with profiling.span("a"):
            for _ in range(3):
                with profiling.span("b"):
                    pass
            profiling.count("c", 1)
    spans, counters, dropped = profiling.recorded()
    assert [s.name for s in spans] == ["a", "b", "b"]
    assert counters == [] and dropped == 2
    profiling.clear()
    assert profiling.recorded() == ([], [], 0)


def test_span_names_in_the_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "p")) as prof:
        with profiling.span("visrag_region"):
            torch.ones(16, 16) @ torch.ones(16, 16)
    names = {e.get("name") for e in json.loads(
        (tmp_path / "p" / profiling.TRACE_FILE).read_text())["traceEvents"]}
    assert "visrag_region" in names
    assert any(e.key == "visrag_region" for e in prof.key_averages())
    assert [s.name for s in profiling.recorded()[0]] == ["visrag_region"]


# ---- the engine ------------------------------------------------------------


def _vision_prompt(rng, cfg, prefix):
    from visrag_tpu_torch.models.mrope import get_rope_index
    from visrag_tpu_torch.preprocess.qwen_vision import prepare_vision_batch
    img = Image.fromarray(rng.integers(0, 255, (112, 112, 3), dtype=np.uint8))
    vb = prepare_vision_batch([img], head_dim=cfg.vision.head_dim,
                              min_pixels=16 * 16, max_pixels=112 * 112,
                              device_mode=True)
    ids = np.concatenate([np.asarray(prefix, np.int32),
                          np.full((vb.n_tokens,), cfg.image_token_id),
                          rng.integers(0, 100, size=(4,))]).astype(np.int32)
    slot = np.full(ids.shape, -1, np.int32)
    slot[ids == cfg.image_token_id] = np.arange(vb.n_tokens)
    return dict(input_ids=ids,
                positions=get_rope_index(ids, vb.grid_thw, cfg.image_token_id),
                vision_batch={k: getattr(vb, k) for k in (
                    "patches", "rot_cos", "rot_sin", "seg_window", "seg_full",
                    "reverse_index")},
                slot_map=slot)


def test_engine_spans_follow_the_schedule():
    from visrag_tpu_torch.driver.common import build_qwen25_vl
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    from visrag_tpu_torch.serving.engine import Engine
    from visrag_tpu_torch.serving.sampling import SamplingParams
    cfg = Qwen25VLConfig.tiny()
    model = build_qwen25_vl(cfg, device="cpu")
    eng = Engine(model, num_slots=3, max_len=128, prompt_buckets=(16, 64),
                 chunked_prefill_tokens=16, decode_chunk=4)
    eng.record_schedule = True
    rng = np.random.default_rng(5)
    prompts = [dict(input_ids=rng.integers(0, 100, size=(n,)).astype(
        np.int32)) for n in (5, 7, 40)]
    prompts.append(_vision_prompt(rng, cfg, [7, 8, 9]))
    prompts.append(dict(input_ids=np.arange(6, dtype=np.int32)))
    live = []
    chunk = eng._decode_chunk

    def decode_chunk():
        live.append(int(eng.active.sum()))
        chunk()
    eng._decode_chunk = decode_chunk
    sp = SamplingParams(temperature=0.0, max_tokens=6)
    rids = [eng.add_request(sampling=sp, **p) for p in prompts]
    reqs = list(eng.queue)
    with _profile():
        eng.run()
    spans, counters, dropped = profiling.recorded()
    assert dropped == 0 and all(r.done for r in reqs)
    by = _by_name(spans)

    # prefill and decode spans in the schedule's order
    sched = {"one": "P", "many": "P", "chunk": "C"}
    got = [sched[s.attrs["kind"]] if s.name == "engine.prefill" else "D"
           for s in spans if s.name == "engine.decode"
           or (s.name == "engine.prefill" and s.attrs["kind"] != "start")]
    assert got == [c.upper() for c in eng.sched_log]
    assert {s.attrs["kind"] for s in by["engine.prefill"]} == \
        {"one", "many", "start", "chunk"}

    # the live slots at each decode chunk
    assert [c.value for c in counters if c.name == "engine.live_slots"] \
        == live and live

    # each request's id on its prefill spans, its real tokens all counted
    def rids_of(s):
        r = s.attrs["rid"]
        return r if isinstance(r, tuple) else (r,)

    for rid, req in zip(rids, reqs):
        mine = [s for s in by["engine.prefill"] if rid in rids_of(s)]
        assert mine
        tokens = 0
        for s in mine:
            t = s.attrs.get("tokens", 0)
            tokens += t[rids_of(s).index(rid)] if isinstance(t, tuple) else t
        assert tokens == len(req.input_ids)
    many = [s for s in by["engine.prefill"] if s.attrs["kind"] == "many"]
    assert many[0].attrs["padded"] == 16 * len(rids_of(many[0]))

    # the vision tower inside the vision prompt's prefill start
    ids = {s.id: s for s in spans}
    (vision,) = by["qwen.vision"]
    start = ids[vision.parent]
    assert start.name == "engine.prefill" and start.attrs == \
        {"kind": "start", "rid": rids[3]}

    # decode: steps inside chunks, the model inside steps
    for d in by["engine.decode"]:
        steps = [s for s in by["engine.decode.step"] if s.parent == d.id]
        assert len(steps) == d.attrs["steps"] == 4
        for st in steps:
            (m,) = [s for s in by["engine.decode.model"]
                    if s.parent == st.id]
            assert st.start_ns <= m.start_ns <= m.end_ns <= st.end_ns


# ---- the encode ------------------------------------------------------------


def test_encode_spans_and_fill_counters():
    from visrag_tpu_torch.config import ModelConfig
    from visrag_tpu_torch.driver.common import build_visrag_ret
    from visrag_tpu_torch.preprocess import MockTokenizer, build_encode_batch
    from visrag_tpu_torch.preprocess.device import (finish_encode_batch,
                                                    pos_table_tensor)
    from visrag_tpu_torch.retrieval.search import topk_single
    model, pcfg = build_visrag_ret(ModelConfig(), tiny=True, device="cpu")
    rng = np.random.default_rng(0)
    items = [("", Image.fromarray(rng.integers(0, 255, (40, 30, 3),
                                               dtype=np.uint8))),
             ("a text query", None)]
    raw = build_encode_batch(MockTokenizer(), items, pcfg, device_mode=True)
    table = pos_table_tensor(pcfg.src_grid, "cpu")
    with _profile(), torch.inference_mode():
        reps = model(finish_encode_batch(raw, table))
        topk_single(reps, reps, 1)
    spans, counters, _ = profiling.recorded()
    assert [s.name for s in spans] == [
        "preprocess.finish", "visrag_ret.forward", "minicpmv.vision",
        "minicpmv.lm", "search.topk"]
    finish, fwd, vision, lm, scan = spans
    assert finish.parent is None and fwd.parent is None
    assert vision.parent == fwd.id and lm.parent == fwd.id
    assert scan.parent is None
    assert finish.end_ns <= fwd.start_ns and vision.end_ns <= lm.start_ns
    am, pm = raw["attention_mask"], raw["patch_mask"]
    assert {c.name: c.value for c in counters} == {
        "preprocess.tokens": (int(am.sum()), am.size),
        "preprocess.patches": (int(pm.sum()), pm.size)}
    assert 0 < am.sum() < am.size and 0 < pm.sum() < pm.size

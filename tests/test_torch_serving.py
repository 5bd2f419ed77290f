"""visrag_tpu_torch serving engine and EVisRAG drivers against the JAX ones.

One tiny HF Qwen2.5-VL (tests/test_qwen25_vl.py's `_hf_tiny`, fp32, bf16 KV
pools as both engines default to) is loaded into the JAX model and, through
`qwen_from_jax_params`, into the port. Each case runs the same prompts
through both engines with greedy sampling (temperature 0, so no random
draw is involved) and asks for token-identical outputs and identical
scheduling: prefill counts and dispatches, prefix-cache hits, the schedule
trace, and every block back in the pool. The JAX engine runs its XLA paths
on the CPU, the port its plain PyTorch versions of the kernels.
"""

import json
import zlib

import jax
import numpy as np
import pytest
from PIL import Image

from visrag_tpu.models.hf_loader import convert_qwen25_vl
from visrag_tpu.models.qwen25_vl import Qwen25VL as JQwen
from visrag_tpu.models.qwen25_vl import Qwen25VLConfig as JConfig
from visrag_tpu.serving.engine import Engine as JEngine
from visrag_tpu.serving.sampling import SamplingParams as JSampling
from visrag_tpu_torch.models.hf_loader import qwen_from_jax_params
from visrag_tpu_torch.models.mrope import get_rope_index
from visrag_tpu_torch.models.qwen25_vl import Qwen25VL, Qwen25VLConfig
from visrag_tpu_torch.preprocess.qwen_vision import prepare_vision_batch
from visrag_tpu_torch.serving.engine import Engine
from visrag_tpu_torch.serving.sampling import SamplingParams


@pytest.fixture(scope="module")
def models():
    from test_qwen25_vl import _hf_tiny
    ref, _ = _hf_tiny()
    params = {"params": convert_qwen25_vl(dict(ref.state_dict()))}
    port = Qwen25VL(Qwen25VLConfig.tiny()).eval()
    qwen_from_jax_params(port, jax.tree.map(np.asarray, params))
    return JQwen(JConfig.tiny()), params, port


def _text(rng, *lens):
    return [dict(input_ids=rng.integers(0, 100, size=(n,)).astype(np.int32))
            for n in lens]


def _vision(rng, prefix, px=112, tail=4):
    """An image prompt with a text prefix before the image (the EVisRAG
    evidence-instruction layout)."""
    cfg = Qwen25VLConfig.tiny()
    img = Image.fromarray(rng.integers(0, 255, (px, px, 3), dtype=np.uint8))
    vb = prepare_vision_batch([img], head_dim=cfg.vision.head_dim,
                              min_pixels=16 * 16, max_pixels=px * px,
                              device_mode=True)
    ids = np.concatenate([np.asarray(prefix, np.int32),
                          np.full((vb.n_tokens,), cfg.image_token_id),
                          rng.integers(0, 100, size=(tail,))]).astype(np.int32)
    slot = np.full(ids.shape, -1, np.int32)
    slot[ids == cfg.image_token_id] = np.arange(vb.n_tokens)
    return dict(input_ids=ids,
                positions=get_rope_index(ids, vb.grid_thw, cfg.image_token_id),
                vision_batch={k: getattr(vb, k) for k in (
                    "patches", "rot_cos", "rot_sin", "seg_window", "seg_full",
                    "reverse_index")},
                slot_map=slot)


def _scenario(case):
    """→ (engine kwargs, prompts, sampling kwargs, n)."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    base = dict(num_slots=4, max_len=128, prompt_buckets=(16, 64))
    chunked = dict(base, chunked_prefill_tokens=16)
    if case == "continuous_batching":
        return (dict(num_slots=2, max_len=64, prompt_buckets=(16,)),
                _text(rng, 4, 7, 5, 9, 3), dict(max_tokens=4), 1)
    if case == "batched_prefill":
        return (dict(num_slots=8, max_len=64, prompt_buckets=(16,)),
                _text(rng, 6, 9, 4, 11, 7), dict(max_tokens=6), 1)
    if case == "n_sample_groups":
        return (dict(num_slots=3, max_len=64, prompt_buckets=(16,)),
                _text(rng, 11, 16), dict(max_tokens=6), 3)
    if case == "chunked_text":
        return chunked, _text(rng, 40, 33, 20), dict(max_tokens=6), 2
    if case == "chunked_vision":
        return (dict(num_slots=2, max_len=256, prompt_buckets=(16, 128),
                     chunked_prefill_tokens=16),
                [_vision(rng, rng.integers(0, 100, size=(5,))),
                 *_text(rng, 40)], dict(max_tokens=6), 1)
    if case == "prefix_cache":
        prefix = rng.integers(0, 100, size=(48,))
        ps = [dict(input_ids=np.concatenate(
            [prefix, rng.integers(0, 100, size=(n,))]).astype(np.int32))
            for n in (6, 9)]
        vp = [_vision(rng, prefix[:40]) for _ in range(2)]
        return (dict(chunked, num_slots=1, max_len=256,
                     prompt_buckets=(16, 128), prefix_cache=True),
                ps + [dict(input_ids=ps[0]["input_ids"].copy())] + vp,
                dict(max_tokens=5), 1)
    if case == "logit_bias":
        bias = tuple((t, -1e9) for t in range(0, 64, 8))
        return (chunked, _text(rng, 12, 12, 40),
                dict(max_tokens=6, logit_bias=bias), 2)
    if case == "backpressure":
        return (dict(num_slots=6, max_len=64, prompt_buckets=(16,),
                     cache_blocks=5), _text(rng, *[12] * 6),
                dict(max_tokens=8), 1)
    if case == "prefill_budget":
        return (dict(chunked, prefill_token_budget=16),
                _text(rng, 40, 6, 36, 9), dict(max_tokens=6), 1)
    raise KeyError(case)


def _run(engine, prompts, sampling, n):
    engine.record_schedule = True
    return engine.generate(prompts, sampling=sampling, n=n)


def _stats(e):
    return dict(prefill_count=e.prefill_count,
                prefill_dispatches=e.prefill_dispatches,
                prefix_hits=e.prefix_hits, sched_log=e.sched_log,
                free=len(e.allocator.free))


@pytest.mark.parametrize("case", [
    "continuous_batching", "batched_prefill", "n_sample_groups",
    "chunked_text", "chunked_vision", "prefix_cache", "logit_bias",
    "backpressure", "prefill_budget"])
def test_engine_matches_jax(models, case):
    jm, params, port = models
    kw, prompts, skw, n = _scenario(case)
    je = JEngine(jm, params, **kw)
    want = _run(je, prompts, JSampling(temperature=0.0,
                                       repetition_penalty=1.05, **skw), n)
    pe = Engine(port, **kw)
    got = _run(pe, prompts, SamplingParams(temperature=0.0,
                                           repetition_penalty=1.05, **skw), n)
    assert got == want
    assert _stats(pe) == _stats(je)
    assert all(len(o) == skw["max_tokens"] for o in got)
    if case == "logit_bias":
        banned = {t for t, _ in skw["logit_bias"]}
        assert not any(set(o) & banned for o in got)
    if case == "prefix_cache":
        assert pe.prefix_hits > 0
    if case == "chunked_vision":
        assert "P" not in pe.sched_log


def test_engine_sleep_wake_and_errors(models):
    """sleep() frees the pools and the next run reallocates them with the
    same outputs; a request the pool can never hold raises."""
    jm, params, port = models
    rng = np.random.default_rng(3)
    prompts = _text(rng, 6, 9)
    sp = SamplingParams(temperature=0.0, max_tokens=5)
    want = JEngine(jm, params, num_slots=2, max_len=64,
                   prompt_buckets=(16,)).generate(
        prompts, sampling=JSampling(temperature=0.0, max_tokens=5))
    eng = Engine(port, num_slots=2, max_len=64, prompt_buckets=(16,))
    assert eng.generate(prompts, sampling=sp) == want
    eng.sleep()
    assert eng.k_cache is None and eng.v_cache is None
    assert eng.generate(prompts, sampling=sp) == want
    eng.sleep()
    eng.wake()
    assert eng.k_cache.shape[0] == port.cfg.text.num_hidden_layers
    tiny = Engine(port, num_slots=2, max_len=64, prompt_buckets=(16,),
                  cache_blocks=1)
    with pytest.raises(RuntimeError, match="KV pool too small"):
        tiny.generate(prompts[:1], sampling=SamplingParams(
            temperature=0.0, max_tokens=40))
    with pytest.raises(ValueError, match="max_len"):
        eng.add_request(np.zeros(64, np.int32))


def test_engine_latency_bookkeeping(models):
    _, _, port = models
    eng = Engine(port, num_slots=2, max_len=64, prompt_buckets=(16,),
                 decode_chunk=4)
    reqs = eng.generate_detailed(_text(np.random.default_rng(5), 6, 8, 5),
                                 sampling=SamplingParams(temperature=0.0,
                                                         max_tokens=9))
    for r in reqs:
        assert r.done and len(r.output_ids) == 9
        assert r.t_first >= r.t_enqueue
        assert sum(n for _, n in r.emits) == 9
        assert np.isfinite(r.cum_logprob) and r.cum_logprob <= 0


# ---- drivers ----------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    from test_cli_smokes import tiny_ckpt as make
    return make.__wrapped__(tmp_path_factory)


def test_evisrag_predict_matches_jax_driver(tiny_ckpt, tmp_path):
    """The port's evisrag_predict.main on the tiny HF checkpoint (weights,
    config.json and tokenizer) on the CPU writes the JAX driver's
    predictions."""
    from visrag_tpu.driver.evisrag_predict import main as jmain
    from visrag_tpu_torch.driver.evisrag_predict import main
    rng = np.random.default_rng(0)
    imgs = []
    for i in range(2):
        p = tmp_path / f"page{i}.png"
        Image.fromarray(rng.integers(0, 255, (56, 42, 3),
                                     dtype=np.uint8)).save(p)
        imgs.append(str(p))
    inp = tmp_path / "top3.jsonl"
    with open(inp, "w") as f:
        for i in range(2):
            f.write(json.dumps({"qid": f"q{i}",
                                "query": f"what is on this page tok{i}",
                                "image": imgs}) + "\n")
    args = ["--input", str(inp), "--checkpoint", tiny_ckpt, "--topk", "2",
            "--max-tokens", "8"]
    assert jmain(args + ["--output", str(tmp_path / "jax.jsonl")]) == 0
    assert main(args + ["--output", str(tmp_path / "port.jsonl"),
                        "--device", "cpu"]) == 0
    want = [json.loads(line) for line in open(tmp_path / "jax.jsonl")]
    got = [json.loads(line) for line in open(tmp_path / "port.jsonl")]
    assert got == want and [r["qid"] for r in got] == ["q0", "q1"]


def test_evisrag_eval_driver(tmp_path, capsys):
    from visrag_tpu_torch.driver.evisrag_eval import main
    gold = tmp_path / "gold.jsonl"
    with open(gold, "w") as f:
        f.write(json.dumps({"qid": "q0", "answer": "paris",
                            "is_sufficient": True}) + "\n")
        f.write(json.dumps({"qid": "q1", "answer": "x",
                            "is_sufficient": False}) + "\n")
    preds = tmp_path / "preds.jsonl"
    with open(preds, "w") as f:
        f.write(json.dumps({"qid": "q0",
                            "pred": "<answer>paris</answer>"}) + "\n")
        f.write(json.dumps(
            {"qid": "q1",
             "pred": "<answer>no relevant information</answer>"}) + "\n")
    outp = tmp_path / "metrics.json"
    assert main(["--gold", str(gold), "--preds", str(preds),
                 "--output", str(outp)]) == 0
    m = json.load(open(outp))
    assert m["global_em"] == pytest.approx(1.0) and m["cnt_unsuff"] == 1
    with open(preds, "a") as f:
        f.write(json.dumps({"qid": "zz", "pred": "x"}) + "\n")
    assert main(["--gold", str(gold), "--preds", str(preds)]) == 1

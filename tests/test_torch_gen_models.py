"""visrag_tpu_torch's VisRAG-Gen models against the JAX package's.

MiniCPM-2B (MiniCPMForGeneration), MiniCPM-V 2.0 (MiniCPMVForGeneration)
and MiniCPM-V 2.6 (MiniCPMV26ForGeneration) at the JAX tiny configs in
fp32: each JAX model is initialised from a fixed key and carried into its
port twin by `generation_from_jax_params`. The same numpy inputs go
through both: prompts from the port's pipeline (MockTokenizer, one page
for 2.0, two images in one prompt for 2.6, as uint8 device-mode pixels).
On the CPU the JAX package runs its XLA paths, the port its plain PyTorch
versions of K1, K5 and K7.

  * prefill logits and K/V within 1e-4 relative (Frobenius, valid rows);
  * three decode steps on dense and on paged caches (the same caches fed
    to both) within 1e-4, and each step within 1e-4 of the port's own full
    forward over prompt + generated ids;
  * the engines' greedy outputs on two prompts identical, cum_logprob
    within 1e-4;
  * beam search (serving/beam.py, the weighted-selection strategy's
    HF-parity scorer) on MiniCPM-V 2.0 with a page prompt: the same ids
    and scores within 1e-5 as visrag_tpu.serving.beam.beam_search for
    num_beams 1 and 3 and repetition_penalty 1.0 and 1.2; and the port's
    batched search over a page prompt and two text prompts equal to its
    sequential calls (the engine's methods, as the backend calls them).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from visrag_tpu.models.minicpm import MiniCPMForGeneration as JMiniCPM
from visrag_tpu.models.minicpm import MiniCPMGenConfig as JMiniCPMCfg
from visrag_tpu.models.minicpmv import MiniCPMVForGeneration as JMiniCPMV
from visrag_tpu.models.minicpmv import MiniCPMVGenConfig as JMiniCPMVCfg
from visrag_tpu.models.minicpmv26 import MiniCPMV26Config as JV26Cfg
from visrag_tpu.models.minicpmv26 import MiniCPMV26ForGeneration as JV26
from visrag_tpu.serving.beam import beam_search as jbeam_search
from visrag_tpu.serving.engine import Engine as JEngine
from visrag_tpu.serving.sampling import SamplingParams as JSampling
from visrag_tpu_torch.models.hf_loader import generation_from_jax_params
from visrag_tpu_torch.models.minicpm import (MiniCPMForGeneration,
                                             MiniCPMGenConfig)
from visrag_tpu_torch.models.minicpmv import (MiniCPMVForGeneration,
                                              MiniCPMVGenConfig)
from visrag_tpu_torch.models.minicpmv26 import (MiniCPMV26Config,
                                                MiniCPMV26ForGeneration)
from visrag_tpu_torch.preprocess.pipeline import (PipelineConfig,
                                                  build_encode_batch,
                                                  build_multi_image_batch)
from visrag_tpu_torch.preprocess.tokenize import MockTokenizer
from visrag_tpu_torch.serving.beam import beam_search
from visrag_tpu_torch.serving.engine import Engine
from visrag_tpu_torch.serving.sampling import SamplingParams

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny models run fastest on one thread, and the suite's workers
    share the machine's cores: many threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-4
STEPS = 3
CASES = ("minicpm", "minicpmv", "minicpmv26")
V20_KEYS = ("patches", "patch_mask", "pos_matrix", "grid_h", "grid_w")
V26_KEYS = ("pixels", "patch_mask", "grid_h", "grid_w")


def _pcfg(query_num):
    return PipelineConfig(seq_len=512, query_num=query_num, patch_size=2,
                          src_grid=4, scale_resolution=8, max_patches=64)


def _image(rng, h, w):
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def _chatml(phs, q="what does the chart show?"):
    return ("<|im_start|>user\n" + "\n".join(phs) + "\n" + q +
            "<|im_end|>\n<|im_start|>assistant\n")


def gen_prompts(case, seed=0):
    """Two prompts of the case: dicts of numpy input_ids [+ vision_batch,
    slot_map]. MiniCPM-2B: two text prompts; 2.0: a one-page vision prompt
    and a text prompt; 2.6: one prompt holding two images (device-mode
    pixels) and a text prompt."""
    rng = np.random.default_rng(seed)
    tok = MockTokenizer()
    text = dict(input_ids=rng.integers(2, 250, size=(9,)).astype(np.int32))
    if case == "minicpm":
        return [dict(input_ids=rng.integers(2, 250, size=(13,))
                     .astype(np.int32)), text]
    if case == "minicpmv":
        arrs = build_encode_batch(tok, [("what is this?", _image(rng, 12,
                                                                 12))],
                                  _pcfg(4), n_slice_slots=8)
        s = int(arrs["attention_mask"][0].sum())
        return [dict(input_ids=arrs["input_ids"][0, :s],
                     vision_batch={k: arrs[k] for k in V20_KEYS},
                     slot_map=arrs["slot_map"][0, :s]), text]
    b = build_multi_image_batch(tok, [_image(rng, 20, 14),
                                      _image(rng, 10, 22)], _chatml,
                                _pcfg(4), device_mode=True)
    s = int(b["attention_mask"][0].sum())
    return [dict(input_ids=b["input_ids"][0, :s],
                 vision_batch={k: b[k] for k in V26_KEYS},
                 slot_map=b["slot_map"][0, :s]), text]


@functools.lru_cache(maxsize=None)
def build_pair(case, seed=0):
    """(JAX model, its params, the port model carrying them)."""
    jm, pm = {
        "minicpm": (JMiniCPM(JMiniCPMCfg.tiny()),
                    MiniCPMForGeneration(MiniCPMGenConfig.tiny())),
        "minicpmv": (JMiniCPMV(JMiniCPMVCfg.tiny()),
                     MiniCPMVForGeneration(MiniCPMVGenConfig.tiny())),
        "minicpmv26": (JV26(JV26Cfg.tiny()),
                       MiniCPMV26ForGeneration(MiniCPMV26Config.tiny())),
    }[case]
    p = gen_prompts(case)[0]
    kw = {}
    if "vision_batch" in p:
        kw = dict(vision_batch={k: jnp.asarray(v)
                                for k, v in p["vision_batch"].items()},
                  slot_map=jnp.asarray(p["slot_map"][None]))
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.asarray(p["input_ids"][None]), **kw)
    params = jax.tree.map(np.asarray, params)
    generation_from_jax_params(pm, params)
    return jm, params, pm.eval()


@pytest.fixture(scope="module", params=CASES)
def pair(request):
    return (request.param, *build_pair(request.param))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _padded(p, pad=5):
    """One prompt right-padded by `pad`: (ids, mask, (3, 1, S) positions,
    slot map or None), numpy."""
    s = len(p["input_ids"])
    S = s + pad
    ids = np.zeros((1, S), np.int32)
    ids[0, :s] = p["input_ids"]
    mask = (np.arange(S) < s).astype(np.int32)[None]
    pos = np.broadcast_to(np.arange(S), (3, 1, S)).astype(np.int32)
    sm = None
    if p.get("slot_map") is not None:
        sm = np.full((1, S), -1, np.int32)
        sm[0, :s] = p["slot_map"]
    return ids, mask, pos, sm


def _jax_kw(p, sm):
    if p.get("vision_batch") is None:
        return {}
    return dict(vision_batch={k: jnp.asarray(v)
                              for k, v in p["vision_batch"].items()},
                slot_map=jnp.asarray(sm))


def _port_kw(p, sm):
    if p.get("vision_batch") is None:
        return {}
    return dict(vision_batch={k: torch.from_numpy(np.asarray(v))
                              for k, v in p["vision_batch"].items()},
                slot_map=torch.from_numpy(sm).long())


def _both_prefill(jm, params, pm, p):
    ids, mask, pos, sm = _padded(p)
    jl, jk, jv = jax.jit(functools.partial(jm.apply, method=jm.prefill))(
        params, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        positions=jnp.asarray(pos), **_jax_kw(p, sm))
    with torch.no_grad():
        pl, pk, pv = pm.prefill(torch.from_numpy(ids).long(),
                                attention_mask=torch.from_numpy(mask),
                                positions=torch.from_numpy(pos).long(),
                                **_port_kw(p, sm))
    return (np.asarray(jl), np.asarray(jk), np.asarray(jv)), \
        (pl.numpy(), pk.numpy(), pv.numpy())


@pytest.fixture(scope="module")
def prefilled(pair):
    """The case's first prompt (the vision prompt of 2.0 and 2.6) through
    both prefills: (prompt, JAX (logits, k, v), port (logits, k, v))."""
    case, jm, params, pm = pair
    p = gen_prompts(case)[0]
    return (p, *_both_prefill(jm, params, pm, p))


def test_prefill_matches_jax(prefilled):
    p, (jl, jk, jv), (pl, pk, pv) = prefilled
    s = len(p["input_ids"])
    assert pl.shape == jl.shape and pk.shape == jk.shape
    for a, b in ((pl[:, :s], jl[:, :s]), (pk[:, :, :s], jk[:, :, :s]),
                 (pv[:, :, :s], jv[:, :, :s])):
        assert _rel(a, b) < RTOL
    assert np.isfinite(pl).all()


def _caches(k, v, s, paged, bs=4, seed=0):
    """Caches holding a prompt's K/V (layers, 1, S, kvh, d) numpy: dense
    (layers, 1, L, kvh, d), or paged pools (layers, n_blocks, kvh, bs, d)
    with the blocks in a shuffled order and their (1, mb) table."""
    layers, _, _, kvh, d = k.shape
    length = s + STEPS + 1
    if not paged:
        out = []
        for x in (k, v):
            c = np.zeros((layers, 1, length, kvh, d), np.float32)
            c[:, :, :s] = x[:, :, :s]
            out.append(c)
        return out[0], out[1], None
    mb = -(-length // bs)
    n_blocks = mb + 2
    order = np.random.default_rng(seed).permutation(n_blocks)[:mb]
    out = []
    for x in (k, v):
        pool = np.zeros((layers, n_blocks, kvh, bs, d), np.float32)
        for t in range(s):
            pool[:, order[t // bs], :, t % bs] = x[:, 0, t]
        out.append(pool)
    return out[0], out[1], order[None].astype(np.int32)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_matches_jax_and_full_forward(pair, prefilled, paged):
    case, jm, params, pm = pair
    p, (jl, _, _), (pl, pk, pv) = prefilled
    s = len(p["input_ids"])
    kc, vc, table = _caches(pk, pv, s, paged)
    jkc = tuple(jnp.asarray(x) for x in kc)
    jvc = tuple(jnp.asarray(x) for x in vc)
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    jt = None if table is None else jnp.asarray(table)
    tt = None if table is None else torch.from_numpy(table)
    jdecode = jax.jit(functools.partial(jm.apply, method=jm.decode))
    steps = [pl[0, s - 1]]
    toks = []
    want = jl[0, s - 1]
    for t in range(STEPS):
        tok = int(np.argmax(want))
        toks.append(tok)
        pos = np.full((3, 1, 1), s + t, np.int32)
        lens = np.array([s + t + 1], np.int32)
        want, jkc, jvc = jdecode(params, jnp.asarray([[tok]]),
                                 jnp.asarray(pos), jkc, jvc,
                                 jnp.asarray(lens), jt)
        with torch.no_grad():
            got = pm.decode(torch.tensor([[tok]]),
                            torch.from_numpy(pos).long(), tkc, tvc,
                            torch.from_numpy(lens), tt)
        want = np.asarray(want)[0]
        assert _rel(got[0].numpy(), want) < RTOL, (case, paged, t)
        steps.append(got[0].numpy())
    # the port's own full forward over prompt + generated ids
    full = np.concatenate([p["input_ids"], toks]).astype(np.int64)[None]
    kw = _port_kw(p, None if p.get("slot_map") is None else np.concatenate(
        [p["slot_map"], np.full((STEPS,), -1, np.int32)])[None])
    with torch.no_grad():
        logits, _ = pm(torch.from_numpy(full), **kw)
    for t, step in enumerate(steps):
        assert _rel(step, logits[0, s - 1 + t].numpy()) < RTOL, (case, t)


def test_engine_greedy_matches_jax(pair):
    case, jm, params, pm = pair
    prompts = gen_prompts(case, seed=1)
    kw = dict(num_slots=2, max_len=512, prompt_buckets=(64, 512),
              eos_token_ids=[])
    je = JEngine(jm, params, **kw)
    jp = [dict(p, vision_batch={k: jnp.asarray(v) for k, v in
                                p["vision_batch"].items()})
          if "vision_batch" in p else p for p in prompts]
    want = je.generate_detailed(jp, sampling=JSampling(temperature=0.0,
                                                       max_tokens=6))
    got = Engine(pm, **kw).generate_detailed(
        prompts, sampling=SamplingParams(temperature=0.0, max_tokens=6))
    assert [r.output_ids for r in got] == [r.output_ids for r in want]
    for g, w in zip(got, want):
        assert abs(g.cum_logprob - w.cum_logprob) < 1e-4


# ---- beam search -------------------------------------------------------

EOS = [205, 231]
NEW = 8


class _Jitted:
    """The JAX model with its `apply` under jax.jit (the beam search calls
    the prefill unjitted; the same computation, compiled once)."""

    def __init__(self, model):
        self.apply = jax.jit(model.apply, static_argnames=("method",))
        self.prefill, self.decode = model.prefill, model.decode


@pytest.fixture(scope="module")
def v20():
    jm, params, pm = build_pair("minicpmv")
    return _Jitted(jm), params, pm


def _jax_prompt(p):
    return dict(p, vision_batch={k: jnp.asarray(v) for k, v in
                                 p["vision_batch"].items()})


@pytest.mark.parametrize("rep", [1.0, 1.2])
@pytest.mark.parametrize("k", [1, 3])
def test_beam_search_matches_jax(v20, k, rep):
    jm, params, pm = v20
    p = gen_prompts("minicpmv")[0]
    jp = _jax_prompt(p)
    want_ids, want_score = jbeam_search(
        jm, params, jp["input_ids"], vision_batch=jp["vision_batch"],
        slot_map=jp["slot_map"], num_beams=k, max_new_tokens=NEW,
        eos_token_ids=EOS, repetition_penalty=rep)
    got_ids, got_score = beam_search(
        pm, p["input_ids"], vision_batch=p["vision_batch"],
        slot_map=p["slot_map"], num_beams=k, max_new_tokens=NEW,
        eos_token_ids=EOS, repetition_penalty=rep)
    assert got_ids == want_ids
    assert abs(got_score - want_score) < 1e-5


def test_beam_search_batched_matches_sequential(v20):
    _, _, pm = v20
    rng = np.random.default_rng(3)
    prompts = gen_prompts("minicpmv", seed=2) + [
        dict(input_ids=rng.integers(2, 250, size=(n,)).astype(np.int32))
        for n in (5, 17)]
    engine = Engine(pm, num_slots=2, max_len=256, prompt_buckets=(64, 256),
                    eos_token_ids=EOS)
    got = engine.beam_search_batched(prompts, num_beams=3,
                                     max_new_tokens=NEW,
                                     repetition_penalty=1.2)
    for p, (ids, score) in zip(prompts, got):
        want_ids, want_score = engine.beam_search(
            p, num_beams=3, max_new_tokens=NEW, repetition_penalty=1.2)
        assert ids == want_ids
        assert abs(score - want_score) < 1e-5

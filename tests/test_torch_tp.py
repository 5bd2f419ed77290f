"""Tensor parallelism on gloo ranks: `Engine(mesh=)` over the mesh's
`model` axis (mesh.shard_module_tp, serving/paged_kv.tp_head_layout) and
the hybrid RS-GRPO trainer (rollout over each model group, update FSDP2
over data), against the port's one process and the JAX package.

The models carry weights the JAX package drew (the tiny Qwen2.5-VL of
`__graft_entry__._dryrun_tp_serve_body`, the tiny MiniCPM-2B and MiniCPM-V
2.6 of tests/test_torch_gen_models.py), but for the kvh 8 geometry of
tests/test_serving.py, which torch draws; fp32 throughout. Greedy tokens
must be identical to the port's one-process engine in every case, and to
the JAX engine in one case a model family — its tp 2 engine itself for the
dryrun's prompts, its one-device engine for the MiniCPM models — with the
summed log-probabilities within 1e-4 (tests/test_torch_serving.py and
test_torch_paged_int8.py hold the one-process engine to the JAX engine on
chunked prefill, the prefix cache and int8 pools). A rank's modules
(the prefill's logits and its own kv heads' K/V, decode steps, the vision
tower, a whole forward's gathered logits) agree with the JAX forward within
1e-5. The hybrid trainer at (data 2, model 2) rolls out the tokens of the
port's data 4 trainer and of the JAX (data 4, model 2) trainer; its losses
and its weights after 2 steps agree with the port's data 4 trainer's
within 1e-5 and with the JAX trainer's at tests/test_rl.py's hybrid
tolerance.

The JAX side runs once, in this process; the ranks (one job of 2 and one
of 4, tests/torch_dist_workers.py) import no jax.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from visrag_tpu.config import MeshConfig as JMeshConfig
from visrag_tpu.config import RLConfig as JRLConfig
from visrag_tpu.mesh import build_mesh as jbuild_mesh
from visrag_tpu.models.qwen25_vl import Qwen25VL as JQwen
from visrag_tpu.models.qwen25_vl import Qwen25VLConfig as JConfig
from visrag_tpu.rl.trainer import RLTrainer as JRLTrainer
from visrag_tpu.serving.engine import Engine as JEngine
from visrag_tpu.serving.sampling import SamplingParams as JSampling
from visrag_tpu_torch.models.hf_loader import qwen_from_jax_params
from visrag_tpu_torch.models.mrope import get_rope_index
from visrag_tpu_torch.models.qwen25_vl import Qwen25VL, Qwen25VLConfig
from visrag_tpu_torch.preprocess.qwen_vision import prepare_vision_batch
from visrag_tpu_torch.serving.engine import Engine
from visrag_tpu_torch.serving.paged_kv import tp_head_layout
from visrag_tpu_torch.serving.sampling import SamplingParams
from test_torch_gen_models import build_pair, gen_prompts
from torch_dist_workers import RL_ENGINE, RL_TAGS, spawn, tp_job

TOL = dict(rtol=1e-5, atol=1e-5)
KVH8 = dict(hidden_size=64, num_attention_heads=8, num_key_value_heads=8,
            mrope_section=(2, 1, 1))
VB_KEYS = ("patches", "rot_cos", "rot_sin", "seg_window", "seg_full",
           "reverse_index")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny models run fastest on one thread, and the suite's workers
    (and this file's spawned ranks) share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- weights and prompts ----------------------------------------------------


def _jax_qwen():
    """A JAX tiny Qwen2.5-VL initialised as the TP dryrun does (PRNGKey 0;
    an image prompt creates the tower's weights too, and flax draws each
    weight from its module's path, so the text weights are the
    dryrun's), the port's numpy state carrying its weights, and the
    dryrun's prompt generator."""
    model, port = JQwen(JConfig.tiny()), Qwen25VL(Qwen25VLConfig.tiny())
    rng = np.random.default_rng(0)
    rng.integers(1, 90, size=(1, 8))          # the dryrun's dummy prompt
    p = _vision(np.random.default_rng(99))
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(p["input_ids"][None]),
        positions=jnp.asarray(p["positions"][:, None]),
        vision_batch={k: jnp.asarray(v) for k, v in
                      p["vision_batch"].items()},
        slot_map=jnp.asarray(p["slot_map"][None]))
    params = jax.tree.map(np.asarray, params)
    qwen_from_jax_params(port, params)
    state = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    return model, params, state, rng


def _port_state(text_over, seed):
    """The port's tiny Qwen2.5-VL with `text_over` on its text config,
    drawn by torch from `seed`, as a numpy state."""
    cfg = Qwen25VLConfig.tiny()
    torch.manual_seed(seed)
    port = Qwen25VL(dc.replace(cfg, text=dc.replace(cfg.text, **text_over)))
    return {k: v.numpy().copy() for k, v in port.state_dict().items()}


def _text(rng, *lens):
    return [dict(input_ids=rng.integers(1, 90, size=(n,)).astype(np.int32))
            for n in lens]


def _vision(rng, n_prefix=5, px=112, tail=4):
    """An image prompt with a text prefix before the image."""
    cfg = Qwen25VLConfig.tiny()
    img = Image.fromarray(rng.integers(0, 255, (px, px, 3), dtype=np.uint8))
    vb = prepare_vision_batch([img], head_dim=cfg.vision.head_dim,
                              min_pixels=16 * 16, max_pixels=px * px,
                              device_mode=True)
    ids = np.concatenate([rng.integers(1, 90, size=(n_prefix,)),
                          np.full((vb.n_tokens,), cfg.image_token_id),
                          rng.integers(1, 90, size=(tail,))]).astype(np.int32)
    slot = np.full(ids.shape, -1, np.int32)
    slot[ids == cfg.image_token_id] = np.arange(vb.n_tokens)
    return dict(input_ids=ids,
                positions=get_rope_index(ids, vb.grid_thw, cfg.image_token_id),
                vision_batch={k: getattr(vb, k) for k in VB_KEYS},
                slot_map=slot)


def _jax_prompts(prompts):
    return [dict(p, vision_batch={k: jnp.asarray(v) for k, v in
                                  p["vision_batch"].items()})
            if p.get("vision_batch") is not None else p for p in prompts]


def _jax_engine(model, params, kw, prompts, sampling, n=1, mesh=None):
    eng = JEngine(model, params, mesh=mesh, **kw)
    reqs = eng.generate_detailed(_jax_prompts(prompts),
                                 sampling=JSampling(**sampling), n=n)
    return dict(ids=[r.output_ids for r in reqs],
                logp=[r.cum_logprob for r in reqs])


def _port_engine(spec, kw, prompts, sampling, n=1):
    from torch_dist_workers import tp_model
    eng = Engine(tp_model(spec), **kw)
    eng.record_schedule = True
    reqs = eng.generate_detailed(prompts, SamplingParams(**sampling), n=n)
    return dict(ids=[r.output_ids for r in reqs],
                logp=[r.cum_logprob for r in reqs],
                prefills=(eng.prefill_count, eng.prefill_dispatches),
                prefix_hits=eng.prefix_hits, sched=eng.sched_log,
                free=len(eng.allocator.free))


# ---- the cases --------------------------------------------------------------

GREEDY = dict(temperature=0.0, max_tokens=5)
DRYRUN_KW = dict(num_slots=4, max_len=64, prompt_buckets=(16,))
CHUNKED_KW = dict(num_slots=2, max_len=128, prompt_buckets=(16, 64),
                  chunked_prefill_tokens=16, prefix_cache=True)
WHOLE_KW = dict(num_slots=4, max_len=128, prompt_buckets=(16, 64))
INT8_KW = dict(num_slots=4, max_len=64, prompt_buckets=(16, 32),
               cache_dtype="int8")
GEN_KW = dict(num_slots=2, max_len=512, prompt_buckets=(64, 512),
              eos_token_ids=[])


def _inputs():
    """The weights, prompts and cases, from the JAX inits alone."""
    jm, params, state, rng = _jax_qwen()
    dry = _text(rng, 6, 9, 4)                 # the dryrun's prompts
    rng = np.random.default_rng(43)
    long = _text(rng, 40, 20)                 # test_serving.py:720's
    prefix = dict(input_ids=np.concatenate(
        [long[0]["input_ids"][:32], rng.integers(1, 90, size=(7,))])
        .astype(np.int32))                    # a prefix-cache hit
    mixed = dry + long + [prefix, _vision(rng)]
    int8 = _text(np.random.default_rng(7), 6, 11)
    qwen = ("qwen", state, {})
    six = dict(GREEDY, max_tokens=6)
    # name: (model spec, port engine kwargs, prompts, sampling, n), and
    # the JAX engine that is the reference (model, params, kwargs): one a
    # model family (the Qwen one is the JAX tp 2 engine: run()); the
    # port's one-process engine, which tests/test_torch_serving.py and
    # test_torch_paged_int8.py hold to the JAX engine, is the reference
    # of every case
    cases = dict(
        dryrun=((qwen, DRYRUN_KW, dry, GREEDY, 1), None),
        chunked=((qwen, CHUNKED_KW, mixed, GREEDY, 1), None),
        int8=((qwen, INT8_KW, int8, GREEDY, 2), None),
        kvh8=((("qwen", _port_state(KVH8, 13), KVH8), DRYRUN_KW,
               _text(np.random.default_rng(13), 6, 9, 4), six, 1), None))
    for kind in ("minicpmv26", "minicpm"):
        gm, gparams, pm = build_pair(kind)
        spec = (kind, {k: v.numpy().copy()
                       for k, v in pm.state_dict().items()}, {})
        cases[kind] = ((spec, GEN_KW, gen_prompts(kind, seed=1), six, 1),
                       (gm, gparams, GEN_KW))
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 90, size=(1, 13)).astype(np.int32)
    mask = (np.arange(13) < 10).astype(np.int32)[None]
    modules = (qwen, ids, mask, ids[0, 10:13].tolist(),
               _vision(np.random.default_rng(8))["vision_batch"])
    rng = np.random.default_rng(3)
    fit_prompts = [dict(input_ids=rng.integers(1, 90, size=(6,))
                        .astype(np.int32), ground_truth="<answer>x</answer>")
                   for _ in range(4)]
    return cases, modules, fit_prompts, (jm, params, state)


def _jax_modules(jm, params, _spec, ids, mask, steps, vb):
    """The JAX forward the ranks' modules are held to: the prefill of a
    right-padded prompt (logits at every position, as
    tests/test_parallel.py:75's forward gives them, and K/V), three decode
    steps over a dense cache, and the vision tower on one image."""
    s = int(mask.sum())
    apply = jax.jit(jm.apply, static_argnames=("method",))
    logits, k, v = apply(params, jnp.asarray(ids),
                         attention_mask=jnp.asarray(mask), method=jm.prefill)
    layers, _, _, kvh, d = k.shape
    kc = np.zeros((layers, 1, s + len(steps), kvh, d), np.float32)
    vc = np.zeros_like(kc)
    kc[:, :, :s], vc[:, :, :s] = np.asarray(k)[:, :, :s], \
        np.asarray(v)[:, :, :s]
    jk = tuple(jnp.asarray(x) for x in kc)
    jv = tuple(jnp.asarray(x) for x in vc)
    dec = []
    for i, tok in enumerate(steps):
        got, jk, jv = apply(
            params, jnp.asarray([[tok]], jnp.int32),
            jnp.full((3, 1, 1), s + i, jnp.int32), jk, jv,
            jnp.asarray([s + i + 1], jnp.int32), None, method=jm.decode)
        dec.append(np.asarray(got))
    vis = apply(params, {k: jnp.asarray(a) for k, a in vb.items()},
                method=jm.encode_images)
    return dict(prefill=(np.asarray(logits), np.asarray(k), np.asarray(v)),
                decode=np.stack(dec), vision=np.asarray(vis))


FIT_OVER = dict(rollout=dict(n=2, max_response_length=8, temperature=0.0),
                trainer=dict(total_steps=2, rollout_batch_size=4))


def _jax_hybrid(jm, params, prompts):
    """tests/test_rl.py:914's JAX (data 4, model 2) trainer on the tiny
    Qwen's weights: a greedy rollout, then two steps of fit."""
    cfg = JRLConfig()
    cfg = dc.replace(
        cfg, rollout=dc.replace(cfg.rollout, **FIT_OVER["rollout"]),
        actor=dc.replace(cfg.actor, lr=1e-3),
        trainer=dc.replace(cfg.trainer, **FIT_OVER["trainer"]))
    t = JRLTrainer(jm, {"params": params["params"]}, cfg,
                   tokenizer_decode=lambda ids: (
                       "<answer>x</answer>" if sum(ids) % 2 == 0
                       else "wrong"),
                   tag_token_ids=RL_TAGS, engine_kwargs=RL_ENGINE,
                   mesh=jbuild_mesh(JMeshConfig(data=4, model=2)))
    rb = t.rollout([dict(p) for p in prompts], jax.random.PRNGKey(5))
    assert t._engine.tp == 2
    hist = [m for _, m in t.fit(iter([prompts, prompts]))]
    after = Qwen25VL(Qwen25VLConfig.tiny())
    qwen_from_jax_params(after, jax.tree.map(np.asarray, t.params))
    return rb.responses, hist, {k: v.numpy()
                                for k, v in after.state_dict().items()}


@pytest.fixture(scope="module")
def run():
    """The port's one-process engines, then the ranks' jobs (2 ranks at
    tp 2; 4 ranks at tp 4 and the hybrid and data 4 trainers) while this
    process computes the JAX side."""
    from concurrent.futures import ThreadPoolExecutor
    cases, modules, fit_prompts, (jm, params, state) = _inputs()
    tp2, tp4 = dict(model=2, data=1), dict(model=4, data=1)
    two = [("engine", tp2, port) for port, _ in cases.values()]
    two += [("modules", tp2, modules), ("refusals", tp2, (modules[0],)),
            ("rl_mesh", None, (2,))]
    four = [("engine", tp4, cases[name][0]) for name in TP4]
    four.append(("modules", tp4, modules))
    fit = [("fit", mesh_kw, (fit_prompts, FIT_OVER, 2))
           for mesh_kw in (dict(data=2, model=2), dict(data=4))]
    one = {name: _port_engine(*port) for name, (port, _) in cases.items()}
    # the JAX programs compile with the GIL released: a few at a time
    with ThreadPoolExecutor(5) as pool:
        jobs = (pool.submit(spawn, tp_job, 2, two),
                pool.submit(spawn, tp_job, 4, four, (state, None, fit)))
        hybrid = pool.submit(_jax_hybrid, jm, params, fit_prompts)
        want = {name: pool.submit(_jax_engine, *ref, *port[2:])
                for name, (port, ref) in cases.items() if ref is not None}
        want["dryrun"] = pool.submit(
            _jax_engine, jm, params, DRYRUN_KW, *cases["dryrun"][0][2:],
            mesh=jbuild_mesh(JMeshConfig(model=2, data=1),
                             devices=jax.devices()[:2]))
        jmod = pool.submit(_jax_modules, jm, params, *modules)
        want = {k: f.result() for k, f in want.items()}
        jmod, hybrid = jmod.result(), hybrid.result()
        two, four = (j.result() for j in jobs)
    return dict(cases=cases, want=want, one=one, modules=jmod,
                hybrid=hybrid, two=two, four=four)


# ---- serving ----------------------------------------------------------------

TP2 = ("dryrun", "chunked", "int8", "kvh8", "minicpmv26", "minicpm")
TP4 = ("chunked", "kvh8", "dryrun")


def _text_cfg(spec):
    """The text config of a case's model (the engine's cfg.text)."""
    from visrag_tpu_torch.models.minicpm import MiniCPMGenConfig
    from visrag_tpu_torch.models.minicpmv26 import MiniCPMV26Config
    kind, _, over = spec
    if kind == "qwen":
        return dc.replace(Qwen25VLConfig.tiny().text, **over)
    return (MiniCPMGenConfig if kind == "minicpm"
            else MiniCPMV26Config).tiny(**over).text


def _check_engine(run, ranks, at, name, tp):
    """Every rank's engine emits the same requests; they equal one
    process's (tokens, log-probabilities, prefill counts, prefix-cache
    hits, schedule, blocks back in the pool) and, where the case has one,
    the JAX engine's tokens and log-probabilities."""
    spec = run["cases"][name][0][0]
    want, one = run["want"].get(name), run["one"][name]
    got = [r[0][at] for r in ranks]
    for g in got:
        assert g["ids"] == got[0]["ids"] and g["logp"] == got[0]["logp"]
    got = got[0]
    assert got["ids"] == one["ids"], name
    np.testing.assert_allclose(got["logp"], one["logp"], rtol=1e-4,
                               atol=1e-4)
    if want is not None:
        assert got["ids"] == want["ids"], name
        np.testing.assert_allclose(got["logp"], want["logp"], rtol=1e-4,
                                   atol=1e-4)
    for key in ("prefills", "prefix_hits", "sched", "free"):
        assert got[key] == one[key], key
    text = _text_cfg(spec)
    assert got["kv_heads"] == tp_head_layout(
        text.num_attention_heads, text.num_key_value_heads, tp, 0)[3]


@pytest.mark.parametrize("name", TP2)
def test_engine_tp2_matches_one_process_and_jax(run, name):
    """Engine(mesh=) at tp 2: the dryrun's prompts (whole and batched
    prefill; against the JAX Engine(mesh=MeshConfig(model=2)) itself),
    chunked prefill with the prefix cache and a vision prompt (the tower's
    heads split), int8 pools with n = 2 forks, kvh 8 (4/4 heads a rank),
    MiniCPM-V 2.6 with an image prompt (SigLIP's fused qkv cut by heads,
    the resampler whole) and MiniCPM-2B text."""
    _check_engine(run, run["two"], TP2.index(name), name, 2)


@pytest.mark.parametrize("name", TP4)
def test_engine_tp4_matches_one_process_and_jax(run, name):
    """tp 4: kvh 2 narrower than the group (ranks 0-1 hold kv head 0,
    ranks 2-3 kv head 1, 1/1 heads a rank; the vision tower's 2 heads stay
    whole) with chunked prefill and on the dryrun's prompts (against the
    JAX tp 2 engine's tokens), and kvh 8 (2/2 heads a rank,
    tests/test_serving.py:476)."""
    _check_engine(run, run["four"], TP4.index(name), name, 4)


def _check_modules(run, ranks, at, tp):
    want = run["modules"]
    text = Qwen25VLConfig.tiny().text
    valid = slice(0, 10)
    for rank, r in enumerate(ranks):
        got = r[0][at]
        k0, hk = tp_head_layout(text.num_attention_heads,
                                text.num_key_value_heads, tp, rank)[2:]
        logits, k, v = got["prefill"]
        np.testing.assert_allclose(logits[:, valid],
                                   want["prefill"][0][:, valid], **TOL)
        for g, w in ((k, want["prefill"][1]), (v, want["prefill"][2])):
            np.testing.assert_allclose(g[:, :, valid],
                                       w[:, :, valid, k0:k0 + hk], **TOL)
        np.testing.assert_allclose(got["decode"], want["decode"], **TOL)
        n = want["vision"].shape[0]
        np.testing.assert_allclose(got["vision"][:n], want["vision"], **TOL)
        np.testing.assert_allclose(got["forward"][:, valid],
                                   want["prefill"][0][:, valid], **TOL)


def test_rank_modules_tp2_match_jax(run):
    """Each rank's shard at tp 2 (2/1 text heads, 1 of the tower's 2
    heads, the tied embedding vocab-parallel): the prefill's logits and
    its own kv head's K/V, three decode steps, the vision tower, a
    forward's gathered logits, within 1e-5 of the JAX forward."""
    _check_modules(run, run["two"], len(TP2), 2)


def test_rank_modules_tp4_match_jax(run):
    """The same at tp 4 (1/1 heads a rank, kv head r // 2; the tower
    whole), whose gathered logits are tests/test_parallel.py:75's
    replicated logits."""
    _check_modules(run, run["four"], len(TP4), 4)


def test_tp_refuses_a_whole_model_and_int8_slices(run):
    """Engine(mesh=) serves a rank's shard and refuses the whole model;
    an int8 QuantLinear that the rule would slice raises (its activation
    scale is per whole row)."""
    for r in run["two"]:
        engine, int8 = r[0][len(TP2) + 1]
        assert "shard_module_tp" in engine
        assert "q_proj" in int8 and "int8" in int8


def test_rl_mesh_sizes_the_model_axis(run):
    """rl_main.rl_mesh with rollout.tensor_parallel_size 2 on 2 ranks
    builds a mesh whose model axis is 2 (as the JAX driver sizes it)."""
    for r in run["two"]:
        assert r[0][-1] == {"replica": 1, "data": 1, "seq": 1, "model": 2}


# ---- the hybrid trainer -----------------------------------------------------


def test_hybrid_trainer_matches_data4_and_jax(run):
    """RLTrainer on (data 2, model 2): the rollout tensor-parallel on each
    model group's shards (2 of the 4 prompts a group), the update FSDP2
    over data. Its greedy rollout tokens equal the port's data 4
    trainer's and the JAX (data 4, model 2) trainer's; both steps' losses
    and the weights after them agree with the data 4 trainer's within
    1e-5 and with the JAX trainer's at tests/test_rl.py's hybrid
    tolerance."""
    jresp, jhist, jstate = run["hybrid"]
    four = run["four"]
    (resp, hist, state, engine), (resp4, hist4, state4, engine4) = four[0][1]
    assert engine == (2, 2) and engine4 == (1, 1)
    for r in four[1:]:
        assert r[1][0][0] == resp
        assert [m["loss"] for m in r[1][0][1]] == [m["loss"] for m in hist]
    assert resp == resp4 == jresp
    for m, m4, jm in zip(hist, hist4, jhist):
        assert m["loss"] == pytest.approx(m4["loss"], rel=1e-5, abs=1e-7)
        assert m["loss"] == pytest.approx(float(jm["loss"]), rel=2e-4,
                                          abs=2e-5)
    for k, v in state.items():
        np.testing.assert_allclose(v, state4[k], **TOL, err_msg=k)
        np.testing.assert_allclose(v, jstate[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)


# ---- the head layout --------------------------------------------------------


@pytest.mark.parametrize("h, kvh, tp, want", [
    (28, 4, 2, [(0, 14, 0, 2), (14, 14, 2, 2)]),          # 7B at tp 2
    (28, 4, 4, [(7 * r, 7, r, 1) for r in range(4)]),      # 7B at tp 4
    (16, 2, 4, [(0, 4, 0, 1), (4, 4, 0, 1), (8, 4, 1, 1),  # 3B at tp 4
                (12, 4, 1, 1)]),
    (36, 36, 4, [(9 * r, 9, 9 * r, 9) for r in range(4)]),  # MiniCPM-2B
    (16, 2, 8, [(2 * r, 2, r // 4, 1) for r in range(8)])])
def test_tp_head_layout(h, kvh, tp, want):
    """Each rank's q heads and the kv heads its pools hold: kvh / tp where
    tp divides kvh, else the one kv head its q heads share; every q head
    reads a kv head its rank holds."""
    got = [tp_head_layout(h, kvh, tp, r) for r in range(tp)]
    assert got == want
    for q0, hq, k0, hk in got:
        assert {q // (h // kvh) for q in range(q0, q0 + hq)} <= \
            set(range(k0, k0 + hk))


@pytest.mark.parametrize("h, kvh, tp", [(28, 4, 3), (12, 6, 4), (6, 6, 4)])
def test_tp_head_layout_refuses(h, kvh, tp):
    """A layout no rank can hold (tp not dividing the q heads, or a rank's
    q heads spanning part of a kv group) raises, naming h, kvh and tp."""
    with pytest.raises(ValueError, match=f"h={h}, kvh={kvh}, tp={tp}"):
        tp_head_layout(h, kvh, tp, 0)

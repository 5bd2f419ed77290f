"""visrag_tpu_torch RS-GRPO stack against the JAX package.

Inputs come from numpy at fixed seeds and go through the JAX function and
its counterpart in the port; on the CPU the port's attention runs its plain
PyTorch versions. One tiny HF Qwen2.5-VL (tests/test_qwen25_vl.py's
`_hf_tiny`, fp32) is loaded into the JAX model and, through
`qwen_from_jax_params`, into the port. Tolerances (fp32 on the CPU): 1e-6
for the elementwise PPO functions, 1e-4 for model-level outputs (log-probs,
hidden states), 1e-3 for the loss and the gradient norm, and 1e-2 relative
Frobenius error for the parameter update (AdamW normalises each element's
step, so elements whose gradients are near zero differ most: the
optimizer test's tolerance).
"""

import dataclasses as dc
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visrag_tpu.rl import ppo as jppo
from visrag_tpu_torch.config import RLConfig
from visrag_tpu_torch.models.hf_loader import qwen_from_jax_params
from visrag_tpu_torch.models.qwen25_vl import Qwen25VL, Qwen25VLConfig
from visrag_tpu_torch.rl import ppo
from visrag_tpu_torch.rl.packing import pack_sequences, unpack
from visrag_tpu_torch.rl.trainer import RLTrainer, RolloutBatch

TAGS = {"<think>": [50], "<evidence>": [51], "<answer>": [52]}
ENGINE = dict(num_slots=4, max_len=64, prompt_buckets=(16,))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _decode(ids):
    # group-varying accuracy so that advantages are nonzero
    return "<answer>x</answer>" if sum(ids) % 2 == 0 else "wrong"


# ---- ppo.py, function by function ------------------------------------------


def _ppo_arrays(seed=0, bs=4, n=3, length=12):
    rng = np.random.default_rng(seed)
    old = rng.normal(-2, 1, (bs, length)).astype(np.float32)
    new = (old + rng.normal(0, 0.4, (bs, length))).astype(np.float32)
    ref = (old + rng.normal(0, 0.3, (bs, length))).astype(np.float32)
    resp = (rng.random((bs, length)) < 0.8).astype(np.float32)
    masks = (rng.random((bs, n, length)) < 0.6).astype(np.float32) \
        * resp[:, None]
    adv = rng.normal(size=(bs, n)).astype(np.float32)
    return old, new, ref, resp, masks, adv


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def test_log_probs_from_logits_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 7, 33)).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7))
    _close(ppo.log_probs_from_logits(_t(logits), _t(labels)),
           jppo.log_probs_from_logits(jnp.asarray(logits),
                                      jnp.asarray(labels)))


@pytest.mark.parametrize("mode", ["router", "token", "seq"])
def test_average_loss_matches_jax(mode):
    old, new, ref, resp, masks, adv = _ppo_arrays(2)
    if mode == "router":
        vals, mask = masks * 0.3 + 0.1, masks
    else:
        vals, mask = new, resp
    _close(ppo.average_loss(_t(vals), _t(mask), mode),
           jppo.average_loss(jnp.asarray(vals), jnp.asarray(mask), mode))


@pytest.mark.parametrize("per_token", [False, True])
def test_policy_loss_matches_jax(per_token):
    old, new, ref, resp, masks, adv = _ppo_arrays(3)
    if per_token:
        adv = adv[:, :, None] * masks
    kw = dict(clip_ratio_low=0.2, clip_ratio_high=0.3, clip_ratio_dual=3.0)
    got, gm = ppo.compute_policy_loss(_t(old), _t(new), _t(adv), _t(resp),
                                      _t(masks), **kw)
    want, wm = jppo.compute_policy_loss(
        *(jnp.asarray(x) for x in (old, new, adv, resp, masks)), **kw)
    _close(got, want)
    assert set(gm) == set(wm)
    for k in wm:
        _close(gm[k], wm[k])


@pytest.mark.parametrize("kind", ["kl", "abs", "mse", "low_var_kl"])
def test_compute_kl_matches_jax(kind):
    old, new, ref, *_ = _ppo_arrays(4)
    _close(ppo.compute_kl(_t(new), _t(ref), kind),
           jppo.compute_kl(jnp.asarray(new), jnp.asarray(ref), kind))


def test_compute_kl_full_is_refused():
    with pytest.raises(NotImplementedError):
        ppo.compute_kl(torch.zeros(2), torch.zeros(2), "full")
    with pytest.raises(ValueError):
        ppo.compute_kl(torch.zeros(2), torch.zeros(2), "nope")


def test_combine_channel_losses_matches_jax():
    *_, masks, _ = _ppo_arrays(5)
    pg = np.array([0.3, 0.0, -0.2], np.float32)
    total = np.array([40.0, 0.0, 25.0], np.float32)
    for tot in (None, total):
        _close(ppo.combine_channel_losses(
            _t(pg), _t(masks), total_tokens=None if tot is None else _t(tot)),
            jppo.combine_channel_losses(
                jnp.asarray(pg), jnp.asarray(masks),
                total_tokens=None if tot is None else jnp.asarray(tot)))


@pytest.mark.parametrize("mode", ["token", "seq"])
def test_value_loss_matches_jax(mode):
    old, new, ref, resp, *_ = _ppo_arrays(6)
    kw = dict(cliprange_value=0.5, loss_avg_mode=mode)
    got, gm = ppo.compute_value_loss(_t(new), _t(ref), _t(old), _t(resp),
                                     **kw)
    want, wm = jppo.compute_value_loss(
        *(jnp.asarray(x) for x in (new, ref, old, resp)), **kw)
    _close(got, want)
    for k in wm:
        _close(gm[k], wm[k])


@pytest.mark.parametrize("kl_coef", [0.0, 0.05])
def test_ppo_loss_matches_jax(kl_coef):
    old, new, ref, resp, masks, adv = _ppo_arrays(7)
    total = masks.sum((0, 2)) + 3
    kw = dict(kl_coef=kl_coef, kl_type="low_var_kl")
    got, gm = ppo.ppo_loss(_t(old), _t(new), _t(adv), _t(resp), _t(masks),
                           ref_log_probs=_t(ref), total_tokens=_t(total),
                           **kw)
    want, wm = jppo.ppo_loss(
        *(jnp.asarray(x) for x in (old, new, adv, resp, masks)),
        ref_log_probs=jnp.asarray(ref), total_tokens=jnp.asarray(total),
        **kw)
    _close(got, want)
    assert set(gm) == set(wm) and ("kl_loss" in gm) == (kl_coef > 0)
    for k in wm:
        _close(gm[k], wm[k])


def test_kl_controllers_and_penalty_match_jax():
    old, new, ref, resp, *_ = _ppo_arrays(8)
    scores = np.zeros_like(old)
    scores[:, -1] = 1.0
    for kl_type in ("fixed", "adaptive"):
        c = ppo.get_kl_controller(kl_type, 0.2, 0.05, 100.0)
        jc = jppo.get_kl_controller(kl_type, 0.2, 0.05, 100.0)
        for _ in range(2):
            got, gm = ppo.apply_kl_penalty(scores, old, ref, resp, c, "kl")
            want, wm = jppo.apply_kl_penalty(scores, old, ref, resp, jc,
                                             "kl")
            _close(got, want)
            assert gm["critic/kl"] == pytest.approx(wm["critic/kl"], rel=1e-6)
            assert c.kl_coef == pytest.approx(jc.kl_coef, rel=1e-6)
    with pytest.raises(ValueError):
        ppo.get_kl_controller("nope", 0.1)


@pytest.mark.parametrize("s", [100, 700])
def test_chunked_token_log_probs_matches_naive(s):
    """Values against the JAX function and the naive full-logits form;
    gradients (hidden and the head's weight) against the naive form."""
    rng = np.random.default_rng(9)
    b, e, vocab = 2, 16, 50
    hid = rng.normal(size=(b, s, e)).astype(np.float32)
    w = rng.normal(size=(vocab, e)).astype(np.float32) * 0.3
    labels = rng.integers(0, vocab, (b, s))
    want = jppo.chunked_token_log_probs(
        lambda h: h @ jnp.asarray(w).T, jnp.asarray(hid), jnp.asarray(labels),
        chunk=256)
    th, tw = _t(hid).requires_grad_(True), _t(w).requires_grad_(True)
    got = ppo.chunked_token_log_probs(lambda h: h @ tw.T, th, _t(labels),
                                      chunk=256)
    _close(got.detach(), want, 1e-5)
    coef = _t(rng.normal(size=(b, s)).astype(np.float32))
    g = torch.autograd.grad((got * coef).sum(), (th, tw))
    th2, tw2 = _t(hid).requires_grad_(True), _t(w).requires_grad_(True)
    naive = ppo.log_probs_from_logits(th2 @ tw2.T, _t(labels))
    _close(got.detach(), naive.detach(), 1e-5)
    g2 = torch.autograd.grad((naive * coef).sum(), (th2, tw2))
    for a, b_ in zip(g, g2):
        _close(a, b_, 1e-5)
    with torch.no_grad():                 # no gradient: no checkpointing
        _close(ppo.chunked_token_log_probs(lambda h: h @ tw.T, th,
                                           _t(labels), chunk=256), want, 1e-5)


# ---- shared tiny models ----------------------------------------------------


@pytest.fixture(scope="module")
def shared():
    """JAX params of the tiny HF model, as numpy."""
    from test_qwen25_vl import _hf_tiny
    from visrag_tpu.models.hf_loader import convert_qwen25_vl
    ref, _ = _hf_tiny()
    return jax.tree.map(np.asarray,
                        {"params": convert_qwen25_vl(dict(ref.state_dict()))})


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_engine_settings_match_the_jax_driver(shared, kv):
    """The rollout engine of the port's rl_main (engine_settings) is the
    JAX driver's (the engine_kwargs of visrag_tpu/driver/rl_main.py):
    max_len = prompt + response, 16,536 at the paper config, not rounded,
    so both engines take the same block size (gcd(128, buckets, max_len) =
    8), table width, buckets, chunked prefill, prefix cache and pools."""
    from visrag_tpu.config import RLConfig as JRLConfig
    from visrag_tpu.models.qwen25_vl import Qwen25VL as JQwen
    from visrag_tpu.models.qwen25_vl import Qwen25VLConfig as JConfig
    from visrag_tpu.serving.engine import Engine as JEngine
    from visrag_tpu_torch.driver.rl_main import engine_settings
    from visrag_tpu_torch.serving.engine import Engine
    cfg = RLConfig()
    cfg = dc.replace(cfg, rollout=dc.replace(cfg.rollout, kv_cache_dtype=kv))
    jr = dc.replace(JRLConfig().rollout, kv_cache_dtype=kv)
    cpt = jr.chunked_prefill_tokens
    if cpt is None and jr.max_prompt_length >= 4096:
        cpt = 2048
    jkw = dict(num_slots=8, max_len=jr.max_prompt_length +
               jr.max_response_length, chunked_prefill_tokens=cpt,
               prefix_cache=bool(jr.prefix_cache and cpt is not None),
               cache_dtype=jr.kv_cache_dtype)
    kw = engine_settings(cfg)
    assert kw["max_len"] == jkw["max_len"] == 16536
    je = JEngine(JQwen(JConfig.tiny()), shared, **jkw)
    pe = Engine(_port_model(shared), **kw)
    for attr in ("block_size", "max_blocks", "max_len", "num_slots",
                 "chunk_tokens", "kv_quant"):
        assert getattr(pe, attr) == getattr(je, attr), attr
    assert (pe.block_size, pe.max_blocks) == (8, 2067)
    assert list(pe.prompt_buckets) == list(je.prompt_buckets)
    assert (pe._prefix_cache is None) == (je._prefix_cache is None)


def _port_model(shared, **text_over):
    cfg = Qwen25VLConfig.tiny()
    if text_over:
        cfg = dc.replace(cfg, text=dc.replace(cfg.text, **text_over))
    model = Qwen25VL(cfg)
    qwen_from_jax_params(model, shared)
    return model


def _cfg(**actor):
    cfg = RLConfig()
    return dc.replace(cfg, actor=dc.replace(cfg.actor, lr=1e-3, **actor))


def _port_trainer(shared, cfg=None, text_over=None, **kw):
    kw.setdefault("tokenizer_decode", lambda ids: "")
    kw.setdefault("tag_token_ids", TAGS)
    return RLTrainer(_port_model(shared, **(text_over or {})),
                     cfg or _cfg(), **kw)


def _jax_trainer(shared, cfg, **kw):
    from visrag_tpu.config import RLConfig as JRLConfig
    from visrag_tpu.config import from_dict, to_dict
    from visrag_tpu.models.qwen25_vl import Qwen25VL as JQwen
    from visrag_tpu.models.qwen25_vl import Qwen25VLConfig as JConfig
    from visrag_tpu.rl.trainer import RLTrainer as JTrainer
    kw.setdefault("tokenizer_decode", lambda ids: "")
    kw.setdefault("tag_token_ids", TAGS)
    return JTrainer(JQwen(JConfig.tiny()), jax.tree.map(jnp.asarray, shared),
                    from_dict(JRLConfig, to_dict(cfg)), **kw)


def _synth(seed, **kw):
    from test_rl import _synth_train_batch
    return _synth_train_batch(np.random.default_rng(seed), **kw)


def _update_error(model, before, after_jax):
    """Relative Frobenius error of the port's parameter update against the
    JAX one, both from `before`."""
    moved = Qwen25VL(Qwen25VLConfig.tiny())
    qwen_from_jax_params(moved, after_jax)
    num = den = 0.0
    for k, v in model.state_dict().items():
        dt, dj = v - before[k], moved.state_dict()[k] - before[k]
        num += float(((dt - dj) ** 2).sum())
        den += float((dj ** 2).sum())
    assert den > 0
    return (num / den) ** 0.5


# ---- model: packed forward -------------------------------------------------


@pytest.mark.parametrize("remat", [False, True, "mlp"])
def test_packed_forward_equals_padded(shared, remat):
    """Packed segment-id forward == per-sequence padded forward, in the
    port, and == the JAX model's packed forward on shared weights (1e-4);
    with every remat mode, whose gradients equal the plain ones."""
    from visrag_tpu.models.qwen25_vl import QwenTextConfig as JText
    from visrag_tpu.models.qwen25_vl import QwenTextModel as JTextModel
    model = _port_model(shared, remat=remat).model
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 100, size=(n,)).astype(np.int32)
            for n in (3, 9, 7, 5)]
    packed, _ = pack_sequences(seqs, width=16)
    assert any((np.diff(row[row > 0]) < 0).any()
               for row in packed.segment_ids)  # first-fit: not ascending
    hidden = model(_t(packed.input_ids), positions=_t(packed.positions),
                   segment_ids=_t(packed.segment_ids))
    want = JTextModel(JText.tiny()).apply(
        {"params": jax.tree.map(jnp.asarray, shared["params"]["model"])},
        jnp.asarray(packed.input_ids),
        positions=jnp.asarray(packed.positions),
        segment_ids=jnp.asarray(packed.segment_ids))
    real = packed.segment_ids > 0
    np.testing.assert_allclose(hidden.detach().numpy()[real],
                               np.asarray(want)[real], atol=1e-4, rtol=1e-4)
    for s, got in zip(seqs, unpack(hidden.detach().numpy(), packed.layout)):
        alone = model(_t(s[None])).detach().numpy()[0]
        np.testing.assert_allclose(got, alone, rtol=3e-4, atol=3e-4)
    if remat:
        plain = _port_model(shared).model
        for m in (model, plain):
            out = m(_t(packed.input_ids), positions=_t(packed.positions),
                    segment_ids=_t(packed.segment_ids))
            (out * _t(real[..., None].astype(np.float32))).sum().backward()
        for (n, p), (_, q) in zip(model.named_parameters(),
                                  plain.named_parameters()):
            torch.testing.assert_close(p.grad, q.grad, atol=1e-5, rtol=1e-5,
                                       msg=n)


def test_forward_skips_the_lm_head_and_takes_vision_embeds(shared):
    model = _port_model(shared)
    rng = np.random.default_rng(1)
    ids = _t(rng.integers(0, 100, (2, 10)))
    logits, hidden = model(ids)
    none, hidden2 = model(ids, return_logits=False)
    assert none is None and logits.shape == (2, 10, 128)
    torch.testing.assert_close(hidden, hidden2)
    table = _t(rng.normal(size=(6, 48)).astype(np.float32))
    slot = torch.full((2, 10), -1)
    slot[0, 2:5] = torch.tensor([4, 0, 5])
    _, with_vis = model(ids, slot_map=slot, vision_embeds=table,
                        return_logits=False)
    assert not torch.allclose(with_vis[0], hidden[0])
    torch.testing.assert_close(with_vis[1], hidden[1])


# ---- trainer against the JAX trainer ---------------------------------------


@pytest.mark.parametrize("padding_free", [True, False])
def test_log_probs_and_update_match_jax(shared, padding_free):
    """compute_log_probs and one update_policy on the same synthetic
    post-rollout batch, from shared weights: old log-probs within 1e-4,
    loss and grad_norm within 1e-3 relative, the parameter update within
    1e-2 relative Frobenius error."""
    batch = _synth(7)
    cfg = _cfg(padding_free=padding_free, kl_coef=0.02)
    jt = _jax_trainer(shared, cfg, ref_params=jax.tree.map(jnp.asarray,
                                                           shared))
    pt = _port_trainer(shared, cfg, ref_model=_port_model(shared))
    before = {k: v.clone() for k, v in pt.model.state_dict().items()}
    jb, pb = dict(batch), dict(batch)
    jb["old_log_probs"] = jt.compute_log_probs(jt.params, jb)
    pb["old_log_probs"] = pt.compute_log_probs(pt.model, pb)
    np.testing.assert_allclose(pb["old_log_probs"], jb["old_log_probs"],
                               atol=1e-4, rtol=1e-4)
    # a reference policy that differs from the actor: shifted log-probs
    ref = jb["old_log_probs"] - 0.1 * batch["response_mask"]
    jb["ref_log_probs"] = pb["ref_log_probs"] = np.roll(ref, 0)
    jm, pm = jt.update_policy(jb), pt.update_policy(pb)
    assert set(pm) == set(jm)
    for k in ("loss", "grad_norm", "ppo_kl", "kl_loss", "entropy_loss"):
        assert pm[k] == pytest.approx(jm[k], rel=1e-3, abs=1e-6), k
    assert pm["grad_skipped"] == jm["grad_skipped"] == 0.0
    err = _update_error(pt.model, before,
                        jax.tree.map(np.asarray, jt.params))
    assert err <= 1e-2, err


def test_packed_update_equals_padded(shared):
    """padding_free (segment-id packed) update == padded update."""
    batch = _synth(11)
    states = []
    for padding_free in (True, False):
        t = _port_trainer(shared, _cfg(padding_free=padding_free))
        b = dict(batch)
        b["old_log_probs"] = t.compute_log_probs(t.model, b)
        t.update_policy(b)
        states.append(t.model.state_dict())
    for k in states[0]:
        torch.testing.assert_close(states[0][k], states[1][k], rtol=2e-4,
                                   atol=2e-5, msg=k)


@pytest.mark.parametrize("padding_free", [True, False])
def test_one_rank_mesh_update_equals_one_process(shared, padding_free):
    """compute_log_probs and update_policy with the actor and reference
    policy sharded over a one-rank gloo mesh (FSDP2) and without a mesh:
    log-probs, metrics and weights equal to the bit."""
    from visrag_tpu_torch import mesh as vmesh
    from visrag_tpu_torch.config import MeshConfig
    from visrag_tpu_torch.training.checkpoint import full_tensors
    batch = _synth(7)
    cfg = _cfg(padding_free=padding_free, kl_coef=0.02)
    runs = []
    for one_rank in (False, True):
        with vmesh.distributed(f"localhost:{vmesh.free_port()}", 0, 1,
                               "cpu"):
            mesh = vmesh.build_mesh(MeshConfig()) if one_rank else None
            t = _port_trainer(shared, cfg, ref_model=_port_model(shared),
                              mesh=mesh)
            b = dict(batch)
            b["old_log_probs"] = t.compute_log_probs(t.model, b)
            b["ref_log_probs"] = t.compute_log_probs(t.ref_model, b) \
                - 0.1 * b["response_mask"]
            runs.append((b["old_log_probs"], t.update_policy(b),
                         full_tensors(t.model.state_dict())))
    (logp, m, state), (logp1, m1, state1) = runs
    np.testing.assert_array_equal(logp1, logp)
    assert m1 == m
    assert all(torch.equal(state1[k], v) for k, v in state.items())


def test_micro_batches_accumulate(shared):
    """A token budget that splits the minibatch into several micro-batches
    gives the single-micro-batch update (gradients add into .grad)."""
    batch = _synth(13)
    states = []
    for budget in (16384, 48):
        t = _port_trainer(shared, _cfg(micro_batch_tokens=budget))
        b = dict(batch)
        b["old_log_probs"] = t.compute_log_probs(t.model, b)
        t.update_policy(b)
        states.append(t.model.state_dict())
    for k in states[0]:
        torch.testing.assert_close(states[0][k], states[1][k], rtol=2e-4,
                                   atol=2e-5, msg=k)


def _vision_prompt(rng, px=56):
    from PIL import Image

    from visrag_tpu_torch.models.mrope import get_rope_index
    from visrag_tpu_torch.preprocess.qwen_vision import prepare_vision_batch
    cfg = Qwen25VLConfig.tiny()
    img = Image.fromarray(rng.integers(0, 255, (px, px, 3), dtype=np.uint8))
    vb = prepare_vision_batch([img], head_dim=cfg.vision.head_dim,
                              patch_size=cfg.vision.patch_size,
                              min_pixels=16 * 16, max_pixels=px * px)
    ids = np.concatenate([rng.integers(0, 100, size=(3,)),
                          np.full((vb.n_tokens,), cfg.image_token_id),
                          rng.integers(0, 100, size=(4,))]).astype(np.int32)
    slot = np.full(ids.shape, -1, np.int32)
    slot[ids == cfg.image_token_id] = np.arange(vb.n_tokens)
    return dict(input_ids=ids,
                positions=get_rope_index(ids, vb.grid_thw,
                                         cfg.image_token_id),
                vision_batch={k: getattr(vb, k) for k in (
                    "patches", "rot_cos", "rot_sin", "seg_window",
                    "seg_full", "reverse_index")},
                slot_map=slot, ground_truth="<answer>x</answer>")


def _rollout_cfg(**trainer):
    cfg = _cfg()
    return dc.replace(
        cfg, rollout=dc.replace(cfg.rollout, n=2, max_response_length=8),
        trainer=dc.replace(cfg.trainer, total_steps=1, rollout_batch_size=2,
                           **trainer))


@pytest.mark.parametrize("with_vision", [False, True])
def test_greedy_rollout_equals_jax(shared, with_vision):
    """temperature 0 (no random draw): the RolloutBatch equals the JAX
    trainer's field by field, text and multimodal."""
    rng = np.random.default_rng(4)
    if with_vision:
        prompts = [_vision_prompt(rng), _vision_prompt(rng, px=84)]
    else:
        prompts = [dict(input_ids=rng.integers(0, 100, size=(n,))
                        .astype(np.int32), ground_truth=f"gt{n}")
                   for n in (6, 11)]
    cfg = _rollout_cfg()
    kw = dict(tokenizer_decode=_decode, engine_kwargs=ENGINE,
              banned_token_ids=[Qwen25VLConfig.tiny().image_token_id])
    jrb = _jax_trainer(shared, cfg, **kw).rollout(
        prompts, jax.random.PRNGKey(0), temperature=0.0)
    pt = _port_trainer(shared, cfg, **kw)
    prb = pt.rollout(prompts, 0, temperature=0.0)
    assert isinstance(prb, RolloutBatch)
    for f in dc.fields(RolloutBatch):
        a, b = getattr(prb, f.name), getattr(jrb, f.name)
        if f.name == "vision":
            assert (a is None) == (b is None) == (not with_vision)
            for k in (a or {}):
                np.testing.assert_array_equal(a[k], np.asarray(b[k]), k)
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, f.name)
        else:
            assert a == b, f.name
    assert pt._engine.k_cache is None            # asleep for the update
    assert all(Qwen25VLConfig.tiny().image_token_id not in r
               for r in prb.responses)


def test_fit_with_vision_runs_packed(shared):
    """A whole step on multimodal prompts: the tower runs once into
    vision_embeds, the update runs packed, the tower's weights do not move
    and the text weights do. With the tower offloaded, the same metrics."""
    rng = np.random.default_rng(6)
    prompts = [_vision_prompt(rng), _vision_prompt(rng)]
    cfg = _rollout_cfg()
    hists = []
    for offload in (False, True):
        c = dc.replace(cfg, actor=dc.replace(
            cfg.actor, offload_frozen_params=offload,
            offload_ref_params=offload, kl_coef=0.01))
        t = _port_trainer(shared, c, tokenizer_decode=_decode,
                          engine_kwargs=ENGINE,
                          ref_model=_port_model(shared))
        before = {k: v.clone() for k, v in t.model.state_dict().items()}
        hist = t.fit([prompts], rng=torch.Generator().manual_seed(3))
        assert len(hist) == 1 and t.ref_model.visual is None
        m = hist[0][1]
        assert np.isfinite(m["loss"]) and m["grad_norm"] > 0
        after = t.model.state_dict()
        assert all(torch.equal(after[k], before[k]) for k in after
                   if k.startswith("visual."))
        assert any(not torch.equal(after[k], before[k]) for k in after
                   if k.startswith("model."))
        assert "timing_s/vision_embed" in m and "timing_s/ref" in m
        hists.append(m)
    for k in ("loss", "grad_norm", "reward_mean"):
        assert hists[0][k] == pytest.approx(hists[1][k], rel=1e-5)


def test_make_batch_fresh_prompts():
    """Online filtering pulls NEW prompt groups per retry with globally
    unique uids."""
    from visrag_tpu_torch.rl.reward_manager import RewardManager

    class StubTrainer(RLTrainer):
        def __init__(self, cfg):
            # make_batch only needs cfg, tag ids, the uid counter and
            # rollout()
            self.cfg = cfg
            self.tag_token_ids = TAGS
            self.reward_manager = RewardManager(
                cfg.reward,
                max_response_length=cfg.rollout.max_response_length)
            self.channels = self.reward_manager.channels
            self._uid_next = 0
            self.consumed, self.seeds = [], []

        def rollout(self, prompts, seed):
            n = self.cfg.rollout.n
            self.consumed.append([p["name"] for p in prompts])
            self.seeds.append(seed)
            uids, texts, gts, resp = [], [], [], []
            for p in prompts:
                uid = self._uid_next
                self._uid_next += 1
                for j in range(n):
                    uids.append(uid)
                    texts.append(p["texts"][j])
                    gts.append(p["ground_truth"])
                    resp.append([5, 6, 7])
            bs, S = len(uids), 8
            rm = np.zeros((bs, S), np.int32)
            rm[:, 5:] = 1
            pos = np.broadcast_to(np.arange(S), (3, bs, S)).copy()
            return RolloutBatch(
                input_ids=np.ones((bs, S), np.int32),
                attention_mask=np.ones((bs, S), np.int32),
                positions=pos.astype(np.int32), response_mask=rm,
                responses=resp, response_texts=texts, uid=np.asarray(uids),
                ground_truths=gts)

    cfg = RLConfig()
    cfg = dc.replace(
        cfg, rollout=dc.replace(cfg.rollout, n=2),
        algorithm=dc.replace(cfg.algorithm, online_filtering=True,
                             filter_key="accuracy", filter_low=0.01,
                             filter_high=2.9, max_try_make_batch=5),
        trainer=dc.replace(cfg.trainer, rollout_batch_size=2))
    tr = StubTrainer(cfg)
    gt = "<answer>yes maybe sure ok</answer>"
    perfect = [gt, gt]                           # acc mean 1.0 → filtered
    mixed = [gt, "<answer>zzz</answer>"]         # acc mean 0.5 → kept
    batches = iter([
        [dict(name="a", texts=perfect, ground_truth=gt),
         dict(name="b", texts=perfect, ground_truth=gt)],
        [dict(name="c", texts=mixed, ground_truth=gt),
         dict(name="d", texts=mixed, ground_truth=gt)],
    ])
    out = tr.make_batch(batches, torch.Generator().manual_seed(0))
    assert tr.consumed == [["a", "b"], ["c", "d"]]
    assert len(set(tr.seeds)) == 2               # a fresh draw per rollout
    uids, counts = np.unique(out["uid"], return_counts=True)
    assert (counts == cfg.rollout.n).all()
    assert set(uids) == {2, 3}
    assert out["input_ids"].shape[0] == 4


def test_nonfinite_grad_skips_params_and_optimizer_state(shared):
    """A NaN gradient: grad_skipped 1, parameters and the optimizer's whole
    state (moments, count) untouched; the next finite step applies."""
    t = _port_trainer(shared, _cfg(optimizer_state_dtype="bfloat16"))
    batch = _synth(17)
    batch["old_log_probs"] = t.compute_log_probs(t.model, batch)
    bad = dict(batch)
    bad["advantages"] = batch["advantages"].copy()
    bad["advantages"][0, 0] = np.nan
    before = {k: v.clone() for k, v in t.model.state_dict().items()}
    m = t.update_policy(bad)
    assert m["grad_skipped"] == 1.0 and not np.isfinite(m["grad_norm"])
    assert all(torch.equal(v, before[k])
               for k, v in t.model.state_dict().items())
    assert t.optimizer.count == 0
    for st in t.optimizer.state.values():
        assert all(not x.any() for x in st.values())
    m = t.update_policy(batch)
    assert m["grad_skipped"] == 0.0 and t.optimizer.count == 1
    assert any(not torch.equal(v, before[k])
               for k, v in t.model.state_dict().items())


def test_set_params_clears_prefix_cache(shared):
    """Between steps rollout() hands the engine the updated policy through
    set_params, which releases the prefix cache's blocks (their KV was
    computed with the old weights); with sleep() disabled, so that only
    set_params can have cleared it."""
    cfg = _rollout_cfg()
    t = _port_trainer(shared, cfg, tokenizer_decode=_decode,
                      engine_kwargs=dict(num_slots=4, max_len=64,
                                         prompt_buckets=(16, 32, 64),
                                         chunked_prefill_tokens=16,
                                         prefix_cache=True))
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, 100, size=(32,)).astype(np.int32)
    prompts = [dict(input_ids=np.concatenate(
        [prefix, rng.integers(0, 100, size=(6,)).astype(np.int32)]),
        ground_truth="") for _ in range(2)]
    t.rollout(prompts, 0, temperature=0.0)
    eng = t._engine
    eng.sleep = lambda: None
    t.rollout(prompts, 1, temperature=0.0)
    assert len(eng._prefix_cache) > 0
    free = len(eng.allocator.free)
    eng.set_params(t.model)
    assert len(eng._prefix_cache) == 0 and len(eng.allocator.free) > free
    assert eng.model is t.model


def test_validate_save_resume(shared, tmp_path):
    """Validation metrics and the generation table; a fresh trainer with
    other weights resumes to the saved step, uid counter, data cursor, rng
    state, weights and optimizer state."""
    from visrag_tpu_torch.data.datasets import StatefulIterator
    from visrag_tpu_torch.utils.tracker import Tracker
    cfg = _rollout_cfg(save_freq=1, val_freq=1, val_n=1,
                       val_generations_to_log=2,
                       output_dir=str(tmp_path / "ckpts"))
    rng = np.random.default_rng(4)
    prompts = [dict(input_ids=rng.integers(0, 100, size=(6,)).astype(np.int32),
                    ground_truth="<answer>x</answer>") for _ in range(2)]
    t1 = _port_trainer(shared, cfg, tokenizer_decode=_decode,
                       engine_kwargs=ENGINE)
    tracker = Tracker(str(tmp_path / "logs"))
    it1 = StatefulIterator(lambda: iter([prompts]), cycle=True)
    t1.data_iter = it1
    hist = t1.fit(it1, val_prompts=prompts, tracker=tracker)
    tracker.close()
    m = hist[0][1]
    assert np.isfinite(m["val/reward_score"])
    assert (tmp_path / "logs" / "generations_1.jsonl").exists()
    for family in ("critic/score/mean", "response_length/mean",
                   "timing_s/gen", "timing_s/update_actor",
                   "perf/throughput"):
        assert family in m, sorted(m)

    t2 = _port_trainer(shared, cfg, tokenizer_decode=_decode,
                       engine_kwargs=ENGINE)
    with torch.no_grad():
        for p in t2.model.parameters():
            p.zero_()
    it2 = StatefulIterator(lambda: iter([prompts]), cycle=True)
    t2.data_iter = it2
    assert t2.maybe_resume()
    assert t2.step == 1 and t2._uid_next == t1._uid_next
    assert it2.state() == it1.state()
    assert torch.equal(t2._rng.get_state(), t1._rng.get_state())
    for (k, a), b in zip(t1.model.state_dict().items(),
                         t2.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert t2.optimizer.count == t1.optimizer.count == 1
    for a, b in zip(t1.optimizer.state.values(),
                    t2.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("estimator", ["grpo", "rloo", "reinforce_plus_plus",
                                       "remax"])
def test_token_level_estimators_run(shared, estimator):
    """Each token-level estimator runs a step with the reward-side KL
    controller; per-token advantages take the padded update."""
    cfg = _rollout_cfg()
    cfg = dc.replace(cfg, algorithm=dc.replace(
        cfg.algorithm, adv_estimator=estimator, use_kl_loss=False,
        kl_coef=0.01))
    t = _port_trainer(shared, cfg, tokenizer_decode=_decode,
                      engine_kwargs=ENGINE, ref_model=_port_model(shared))
    rng = np.random.default_rng(4)
    prompts = [dict(input_ids=rng.integers(0, 100, size=(6,)).astype(np.int32),
                    ground_truth="<answer>x</answer>") for _ in range(2)]
    hist = t.fit([prompts])
    m = hist[0][1]
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    assert "critic/kl" in m and "critic/kl_coef" in m


@pytest.mark.parametrize("what", ["ulysses", "tensor_parallel", "gae",
                                  "critic", "router_reward_kl"])
def test_refused_configurations_raise(shared, what):
    cfg = _cfg()
    kw = {}
    if what == "ulysses":
        # as the JAX trainer: ulysses_size needs a mesh with seq of it
        cfg = _cfg(ulysses_size=2)
    elif what == "tensor_parallel":
        # as ulysses_size: tensor_parallel_size needs a mesh with model of
        # it (the hybrid engine itself: tests/test_torch_tp.py)
        cfg = dc.replace(cfg, rollout=dc.replace(cfg.rollout,
                                                 tensor_parallel_size=2))
    elif what == "gae":
        # GAE is ported; without a critic it is refused
        cfg = dc.replace(cfg, algorithm=dc.replace(cfg.algorithm,
                                                   adv_estimator="gae"))
    elif what == "critic":
        # a critic with an estimator that does not read it
        kw["critic"] = object()
    else:
        cfg = dc.replace(cfg, algorithm=dc.replace(cfg.algorithm,
                                                   use_kl_loss=False))
        kw["ref_model"] = _port_model(shared)
    with pytest.raises(ValueError):
        _port_trainer(shared, cfg, **kw)


# ---- driver ----------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    from test_cli_smokes import tiny_ckpt as make
    return make.__wrapped__(tmp_path_factory)


def _rl_args(tiny_ckpt, tmp_path, out, steps=1):
    data = tmp_path / "rl.jsonl"
    with open(data, "w") as f:
        for i in range(4):
            f.write(json.dumps({
                "problem": f"what is on this page tok{i}",
                "answer": "< answer > tok1 < / answer >"}) + "\n")
    return ["--data", str(data), "--checkpoint", tiny_ckpt,
            "--output-dir", str(out), "--device", "cpu",
            "--set", f"trainer.total_steps={steps}",
            "--set", "trainer.rollout_batch_size=4",
            "--set", "trainer.save_freq=1",
            "--set", "rollout.n=2", "--set", "rollout.max_response_length=8",
            "--set", "rollout.max_prompt_length=504",
            "--set", "actor.kl_coef=0.01", "--remat", "full",
            "--set", "actor.optimizer_state_dtype=bfloat16"]


def test_rl_main_cli_and_resume(tiny_ckpt, tmp_path):
    """rl_main.main on the tiny HF checkpoint (weights, config.json and
    tokenizer) on the CPU: one step, a checkpoint, then a second invocation
    that resumes from it and takes the second step."""
    from visrag_tpu_torch.driver.rl_main import main
    from visrag_tpu_torch.training.checkpoint import (find_latest_ckpt,
                                                      load_checkpoint)
    out = tmp_path / "out"
    assert main(_rl_args(tiny_ckpt, tmp_path, out)) == 0
    assert (out / "run_config.json").exists()
    assert (out / "metrics.jsonl").exists()
    ck1 = find_latest_ckpt(str(out))
    assert ck1 is not None and ck1.endswith("global_step_1")
    _, extra = load_checkpoint(ck1)
    assert extra["step"] == 1 and extra["data"]["row"] == 4 \
        and extra["rng"] is not None
    assert main(_rl_args(tiny_ckpt, tmp_path, out, steps=2)) == 0
    ck2 = find_latest_ckpt(str(out))
    assert ck2.endswith("global_step_2")
    assert load_checkpoint(ck2)[1]["data"] == {"epoch": 1, "row": 4}


@pytest.mark.parametrize("flag", [["--num-processes", "2"],
                                  ["--set", "rollout.tensor_parallel_size=2"],
                                  ["--set", "mesh.data=4"],
                                  ["--set", "mesh.model=2"]])
def test_rl_main_refuses_what_is_not_ported(tiny_ckpt, tmp_path, flag):
    """A layout that one process cannot fill (a model axis of 2, or
    rollout.tensor_parallel_size 2, which sizes it; data 4), and
    processes without a coordinator, are refused (ValueError); the
    tensor-parallel rollout on 2 ranks is tests/test_torch_tp.py's."""
    from visrag_tpu_torch.driver.rl_main import main
    with pytest.raises(ValueError):
        main(_rl_args(tiny_ckpt, tmp_path, tmp_path / "out") + flag)


def test_rl_main_int8_kv_pools(tiny_ckpt, tmp_path, monkeypatch):
    """rollout.kv_cache_dtype=int8 reaches the rollout engine as int8
    pools (as the JAX driver passes it), and one step runs on the CPU."""
    from visrag_tpu_torch.driver import rl_main
    from visrag_tpu_torch.serving.engine import Engine
    engines = []
    init = Engine.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        engines.append(self)
    monkeypatch.setattr(Engine, "__init__", spy)
    out = tmp_path / "out"
    assert rl_main.main(_rl_args(tiny_ckpt, tmp_path, out) + [
        "--set", "rollout.kv_cache_dtype=int8"]) == 0
    assert engines and all(e.kv_quant for e in engines)
    hist = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert hist and np.isfinite(hist[-1]["loss"])


@pytest.mark.gpu
def test_padded_update_runs_on_a_card():
    """On a CUDA device the padded update runs the valid-length kernels
    forward and backward (K1 with the LSE, K2 at d = 128 with grouped kv
    heads) and gives finite metrics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = Qwen25VLConfig.tiny()
    cfg = dc.replace(cfg, text=dc.replace(
        cfg.text, hidden_size=512, num_attention_heads=4,
        num_key_value_heads=2, mrope_section=(16, 24, 24),
        dtype=torch.bfloat16))
    model = Qwen25VL(cfg).cuda()
    t = RLTrainer(model, _cfg(padding_free=False),
                  tokenizer_decode=lambda ids: "", tag_token_ids=TAGS)
    batch = _synth(3)
    batch["old_log_probs"] = t.compute_log_probs(t.model, batch)
    metrics = t.update_policy(batch)
    assert np.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0

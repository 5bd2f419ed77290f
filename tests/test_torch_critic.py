"""visrag_tpu_torch GAE critic (models.qwen25_vl.QwenForValue, rl/critic.py,
RLTrainer._prepare_gae, rl_main's critic) against the JAX package.

The JAX value model is initialised from a PRNG key and carried into the
port by `qwen_value_from_jax_params`; the actor is the tiny HF Qwen2.5-VL
of tests/test_torch_rl.py. Inputs come from numpy at fixed seeds; on the
CPU the port's attention runs its plain version. Tolerances (fp32 on the
CPU): 1e-4 on values, advantages and returns (model-level outputs), 1e-3
relative on the loss metrics and the gradient norm, 1e-2 relative
Frobenius error on the parameter update (the optimizer test's tolerance:
AdamW normalises each element's step).
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rl import shared, tiny_ckpt  # noqa: F401  (fixtures)
from test_torch_rl import (ENGINE, TAGS, _decode, _jax_trainer, _port_model,
                           _rl_args, _rollout_cfg, _synth)

from visrag_tpu_torch.models.hf_loader import qwen_value_from_jax_params
from visrag_tpu_torch.models.qwen25_vl import QwenForValue, QwenTextConfig
from visrag_tpu_torch.rl.critic import CriticTrainer
from visrag_tpu_torch.rl.trainer import RLTrainer


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def vshared():
    """JAX QwenForValue params (tiny text config, key 1), as numpy."""
    from visrag_tpu.models.qwen25_vl import QwenForValue as JValue
    from visrag_tpu.models.qwen25_vl import QwenTextConfig as JText
    params = JValue(JText.tiny()).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32),
        positions=jnp.zeros((3, 1, 8), jnp.int32))
    return jax.tree.map(np.asarray, params)


def _jax_value():
    from visrag_tpu.models.qwen25_vl import QwenForValue as JValue
    from visrag_tpu.models.qwen25_vl import QwenTextConfig as JText
    return JValue(JText.tiny())


def _port_value(vshared):
    model = QwenForValue(QwenTextConfig.tiny())
    qwen_value_from_jax_params(model, vshared)
    return model


def _gae_cfg(**critic):
    cfg = _rollout_cfg()
    return dc.replace(
        cfg, algorithm=dc.replace(cfg.algorithm, adv_estimator="gae"),
        critic=dc.replace(cfg.critic, lr=1e-3, **critic))


def _jax_critic(vshared, cfg):
    from visrag_tpu.config import CriticConfig as JCritic
    from visrag_tpu.config import from_dict, to_dict
    from visrag_tpu.rl.critic import CriticTrainer as JCriticTrainer
    return JCriticTrainer(_jax_value(), jax.tree.map(jnp.asarray, vshared),
                          from_dict(JCritic, to_dict(cfg.critic)),
                          global_batch_size=cfg.trainer.global_batch_size)


def _port_critic(vshared, cfg):
    return CriticTrainer(_port_value(vshared), cfg.critic,
                         global_batch_size=cfg.trainer.global_batch_size)


@pytest.mark.parametrize("with_vision", [False, True])
def test_value_model_matches_jax(vshared, with_vision):
    """(B, S) fp32 values over right-padded rows, with and without a
    vision_embeds table scattered by a slot map."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 100, (2, 12)).astype(np.int32)
    att = np.ones((2, 12), np.int32)
    att[1, 9:] = 0
    pos = np.broadcast_to(np.arange(12), (3, 2, 12)).astype(np.int32)
    kw = {}
    if with_vision:
        slot = np.full((2, 12), -1, np.int32)
        slot[0, 2:5] = [3, 0, 4]
        kw = dict(slot_map=slot, vision_embeds=rng.normal(
            size=(5, 48)).astype(np.float32))
    want = _jax_value().apply(
        jax.tree.map(jnp.asarray, vshared), jnp.asarray(ids),
        attention_mask=jnp.asarray(att), positions=jnp.asarray(pos),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = _port_value(vshared)(_t(ids), attention_mask=_t(att),
                                   positions=_t(pos),
                                   **{k: _t(v) for k, v in kw.items()})
    assert got.dtype == torch.float32 and got.shape == (2, 12)
    valid = att.astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("budget", [16384, 48])
def test_compute_values_and_update_match_jax(vshared, budget):
    """compute_values and one clipped update on the same batch, from
    shared weights, with one micro-batch or several (gradients add
    up)."""
    cfg = _gae_cfg(micro_batch_tokens=budget)
    batch = _synth(5)
    rng = np.random.default_rng(6)
    jc, pc = _jax_critic(vshared, cfg), _port_critic(vshared, cfg)
    before = {k: v.clone() for k, v in pc.model.state_dict().items()}
    jv, pv = jc.compute_values(batch), pc.compute_values(batch)
    valid = batch["attention_mask"].astype(bool)
    np.testing.assert_allclose(pv[valid], jv[valid], atol=1e-4, rtol=1e-4)
    batch["values"] = jv
    batch["returns"] = (jv + rng.normal(0, 0.8, jv.shape)
                        ).astype(np.float32)
    jm, pm = jc.update(dict(batch)), pc.update(dict(batch))
    assert set(pm) == set(jm)
    for k in jm:
        assert pm[k] == pytest.approx(jm[k], rel=1e-3, abs=1e-6), k
    moved = _port_value(jax.tree.map(np.asarray, jc.params)).state_dict()
    after = pc.model.state_dict()
    num = sum(float(((after[k] - moved[k]) ** 2).sum()) for k in after)
    den = sum(float(((moved[k] - before[k]) ** 2).sum()) for k in after)
    assert den > 0 and (num / den) ** 0.5 <= 1e-2


@pytest.mark.parametrize("reward_kl", [False, True])
def test_prepare_gae_matches_jax(shared, vshared, reward_kl):
    """_prepare_gae on one batch: the critic's values, the advantages and
    returns (logp space), the collapsed reward masks and, with the
    reward-side KL penalty, its metrics, against the JAX trainer's."""
    cfg = _gae_cfg()
    if reward_kl:
        cfg = dc.replace(cfg, algorithm=dc.replace(
            cfg.algorithm, use_kl_loss=False, kl_type="adaptive",
            kl_coef=0.1, kl_target=0.1, kl_horizon=100.0))
    batch = _synth(8)
    rng = np.random.default_rng(9)
    old = rng.normal(-2, 1, batch["input_ids"].shape).astype(np.float32)
    batch["old_log_probs"] = old
    batch["ref_log_probs"] = (old + rng.normal(0, 0.3, old.shape)
                              ).astype(np.float32)
    kw = dict(ref_params=jax.tree.map(jnp.asarray, shared)) if reward_kl \
        else {}
    jt = _jax_trainer(shared, cfg, critic=_jax_critic(vshared, cfg), **kw)
    pt = RLTrainer(_port_model(shared), cfg, tokenizer_decode=lambda i: "",
                   tag_token_ids=TAGS, critic=_port_critic(vshared, cfg),
                   ref_model=_port_model(shared) if reward_kl else None)
    jb, pb = dict(batch), dict(batch)
    jmet, pmet = jt._prepare_gae(jb), pt._prepare_gae(pb)
    # values past a row's length are outside the attention's contract
    valid = batch["attention_mask"].astype(bool)
    np.testing.assert_allclose(pb["values"][valid], jb["values"][valid],
                               atol=1e-4, rtol=1e-4)
    for k in ("advantages", "returns"):
        np.testing.assert_allclose(pb[k], np.asarray(jb[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(pb["reward_masks"], jb["reward_masks"])
    assert set(pmet) == set(jmet) and ("critic/kl" in pmet) == reward_kl
    for k in jmet:
        assert pmet[k] == pytest.approx(jmet[k], rel=1e-4), k


def test_fit_warmup_then_both_and_resume(shared, tmp_path):
    """critic_warmup=1: step 1 trains only the critic (the actor's weights
    do not move), step 2 both; a fresh trainer and critic with zeroed
    weights resume the critic's weights and optimizer state."""
    from visrag_tpu_torch.driver.rl_main import build_critic
    cfg = _gae_cfg()
    cfg = dc.replace(cfg, trainer=dc.replace(
        cfg.trainer, critic_warmup=1, total_steps=2, save_freq=2,
        output_dir=str(tmp_path / "ckpts")))
    rng = np.random.default_rng(4)
    prompts = [dict(input_ids=rng.integers(0, 100, size=(6,)).astype(np.int32),
                    ground_truth="<answer>x</answer>") for _ in range(2)]

    def trainer():
        model = _port_model(shared)
        return RLTrainer(model, cfg, tokenizer_decode=_decode,
                         tag_token_ids=TAGS, engine_kwargs=ENGINE,
                         critic=build_critic(model, cfg, seed=3))
    t1 = trainer()
    actor0 = {k: v.clone() for k, v in t1.model.state_dict().items()}
    critic0 = {k: v.clone() for k, v in t1.critic.model.state_dict().items()}
    # the critic's backbone is a copy of the actor's text stack
    assert all(torch.equal(v, actor0[k]) for k, v in critic0.items()
               if k.startswith("model."))
    states = []
    hist = t1.fit([prompts, prompts], logger=lambda s, m: states.append(
        {k: v.clone() for k, v in t1.model.state_dict().items()}))
    assert [s for s, _ in hist] == [1, 2]
    m1, m2 = hist[0][1], hist[1][1]
    assert "loss" not in m1 and "loss" in m2
    for m in (m1, m2):
        for k in ("critic/vf_loss", "critic/grad_norm",
                  "critic/vf_explained_var", "timing_s/values",
                  "timing_s/update_critic"):
            assert np.isfinite(m[k]), k
    assert all(torch.equal(states[0][k], actor0[k]) for k in actor0)
    assert any(not torch.equal(states[1][k], actor0[k]) for k in actor0
               if k.startswith("model."))
    assert any(not torch.equal(v, critic0[k])
               for k, v in t1.critic.model.state_dict().items())

    t2 = trainer()
    with torch.no_grad():
        for p in t2.critic.model.parameters():
            p.zero_()
    assert t2.maybe_resume() and t2.step == 2
    for (k, a), b in zip(t1.critic.model.state_dict().items(),
                         t2.critic.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert t2.critic.optimizer.count == t1.critic.optimizer.count == 2
    for a, b in zip(t1.critic.optimizer.state.values(),
                    t2.critic.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_rl_main_gae_cli(tiny_ckpt, tmp_path):
    """rl_main.main with adv_estimator=gae on the tiny HF checkpoint on
    the CPU: the driver builds the critic, a step runs, and the checkpoint
    holds the critic's weights and optimizer state."""
    from visrag_tpu_torch.driver.rl_main import main
    from visrag_tpu_torch.training.checkpoint import (find_latest_ckpt,
                                                      load_checkpoint)
    out = tmp_path / "out"
    assert main(_rl_args(tiny_ckpt, tmp_path, out) + [
        "--set", "algorithm.adv_estimator=gae",
        "--set", "critic.lr_warmup_ratio=0.5"]) == 0
    tree, extra = load_checkpoint(find_latest_ckpt(str(out)))
    assert extra["step"] == 1
    assert {"critic_model", "critic_optimizer"} <= set(tree)
    assert tree["critic_model"]["score.weight"].dtype == torch.float32

"""Retriever training: visrag_tpu_torch against visrag_tpu on the CPU.

Inputs come from numpy with fixed seeds; fp32 unless a test says
otherwise. The tolerances are stated per test: 1e-6 to 2e-5 relative where
both sides do the same fp32 arithmetic elementwise (loss, optimizer), 1e-4
to 1e-2 where a model sits in between (matmul order differs, and the JAX
ViT's fast_gelu is a polynomial stand-in for the port's exact GELU).
"""

import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from visrag_tpu.models.visrag_ret import VisRAGRet as JVisRAGRet
from visrag_tpu.models.visrag_ret import VisRAGRetConfig as JVisRAGRetConfig
from visrag_tpu.ops.pooling import pool as jpool
from visrag_tpu.preprocess.device import finish_encode_batch as jfinish
from visrag_tpu.training import optim as joptim
from visrag_tpu.training.contrastive import ContrastiveConfig as JCCfg
from visrag_tpu.training.contrastive import contrastive_loss as jloss
from visrag_tpu.training.lora import lora_init as jlora_init
from visrag_tpu.training.lora import lora_merge as jlora_merge
from visrag_tpu.training.trainer import RetrieverTrainer as JTrainer
from visrag_tpu_torch.config import TrainConfig
from visrag_tpu_torch.driver.common import init_weights_
from visrag_tpu_torch.models.hf_loader import from_jax_params
from visrag_tpu_torch.models.visrag_ret import VisRAGRet, VisRAGRetConfig
from visrag_tpu_torch.ops.pooling import DROPOUT_RATE, pool
from visrag_tpu_torch.preprocess import (MockTokenizer, PipelineConfig,
                                         build_encode_batch)
from visrag_tpu_torch.preprocess.device import (finish_encode_batch,
                                                pos_table_tensor)
from visrag_tpu_torch.preprocess.transform import bicubic_table
from visrag_tpu_torch.training import optim
from visrag_tpu_torch.training.checkpoint import (find_latest_ckpt,
                                                  gc_checkpoints,
                                                  load_checkpoint,
                                                  save_checkpoint)
from visrag_tpu_torch.training.contrastive import (ContrastiveConfig,
                                                   contrastive_loss,
                                                   gradcache_backward)
from visrag_tpu_torch.training.lora import LoRALinear, lora_init, lora_merge
from visrag_tpu_torch.training.trainer import (RetrieverTrainer,
                                               clip_by_global_norm_,
                                               lr_schedule)

# the tiny model's pipeline, as driver.common.build_visrag_ret(tiny=True)
PCFG = PipelineConfig(seq_len=64, query_num=4, patch_size=2, src_grid=4,
                      scale_resolution=8, max_patches=64)


def _pages(rng, n):
    sizes = [(20, 14), (9, 30), (16, 16), (24, 10)]
    return [("", Image.fromarray(rng.integers(0, 255, (*sizes[i % 4], 3),
                                              dtype=np.uint8)))
            for i in range(n)]


def _queries(n):
    return [(f"which page shows item {i}?", None) for i in range(n)]


def _raw(items, slots=None):
    return build_encode_batch(MockTokenizer(), items, PCFG,
                              n_slice_slots=slots, device_mode=True)


def _finish(raw):
    return finish_encode_batch(raw, pos_table_tensor(PCFG.src_grid, "cpu"))


# ---- pooling ---------------------------------------------------------------


def _hidden_and_mask(seed, b=4, s=12, d=8):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    lens = rng.integers(1, s + 1, b)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return hidden, mask


@pytest.mark.parametrize("mode", ["drop_wmean", "drop_mean"])
def test_drop_pooling_eval_matches_jax(mode):
    """Outside training the drop_* modes equal the JAX version (and plain
    wmean/mean); 1e-6 relative."""
    hidden, mask = _hidden_and_mask(0)
    want = np.asarray(jpool(jnp.asarray(hidden), jnp.asarray(mask), mode,
                            is_training=False))
    got = pool(torch.from_numpy(hidden), torch.from_numpy(mask), mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    plain = pool(torch.from_numpy(hidden), torch.from_numpy(mask),
                 mode[len("drop_"):])
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["drop_wmean", "drop_mean"])
def test_drop_pooling_training_drops_whole_rows(mode):
    """In training, whole (batch, seq) rows are dropped with probability
    0.3 and the kept ones scaled by 1/0.7; the same generator state drops
    the same rows."""
    hidden, mask = _hidden_and_mask(1, b=64, s=256, d=4)
    h, m = torch.from_numpy(hidden), torch.from_numpy(mask)
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    got = pool(h, m, mode, training=True, generator=gen)
    gen.set_state(state)
    keep = torch.rand(m.shape, generator=gen) < 1.0 - DROPOUT_RATE
    w = (m * torch.cumsum(m, 1)).float() if mode == "drop_wmean" \
        else m.float()
    want = (h * w[:, :, None] * keep[:, :, None] / (1 - DROPOUT_RATE)
            ).sum(1) / w.sum(1, keepdim=True)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert abs(1.0 - keep.float().mean().item() - DROPOUT_RATE) < 0.02
    gen.set_state(state)
    again = pool(h, m, mode, training=True, generator=gen)
    assert torch.equal(got, again)
    assert not torch.equal(got, pool(h, m, mode, training=True,
                                     generator=gen))


# ---- contrastive loss and GradCache ------------------------------------------


@pytest.mark.parametrize("n_passages", [1, 2])
def test_contrastive_loss_matches_jax(n_passages):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((6, 8)).astype(np.float32)
    p = rng.standard_normal((6 * n_passages, 8)).astype(np.float32)
    jl, jm = jloss(jnp.asarray(q), jnp.asarray(p),
                   JCCfg(temperature=0.02, n_passages=n_passages))
    tl, tm = contrastive_loss(torch.from_numpy(q), torch.from_numpy(p),
                              ContrastiveConfig(temperature=0.02,
                                                n_passages=n_passages))
    assert tl.item() == pytest.approx(float(jl), rel=1e-6)
    assert tm["accuracy"].item() == pytest.approx(float(jm["accuracy"]))


def test_gradcache_equals_direct_with_dropout_replay():
    """Two-pass GradCache grads equal the direct grads on a tiny VisRAG-Ret
    (drop_wmean pooling in training mode, so pass 2 must replay pass 1's
    dropout): the direct side encodes the same micro-batches in the same
    order from the same generator state. fp32, 1e-4 relative."""
    rng = np.random.default_rng(3)
    pages, queries = _pages(rng, 4), _queries(4)
    micro = [(_finish(_raw(queries[i:i + 2])),
              _finish(_raw(pages[i:i + 2], slots=20))) for i in (0, 2)]
    torch.manual_seed(0)
    model = VisRAGRet(VisRAGRetConfig.tiny(pooling="drop_wmean"))
    init_weights_(model, torch.Generator().manual_seed(0))
    model.train()
    cfg = ContrastiveConfig(temperature=0.05)

    def encode(batch, gen):
        return model(batch, generator=gen)

    gen = torch.Generator().manual_seed(11)
    reps = [(encode(qb, gen), encode(pb, gen)) for qb, pb in micro]
    loss_d, _ = contrastive_loss(torch.cat([r[0] for r in reps]),
                                 torch.cat([r[1] for r in reps]), cfg)
    loss_d.backward()
    direct = {n: p.grad.clone() for n, p in model.named_parameters()
              if p.grad is not None}
    model.zero_grad(set_to_none=True)
    loss_gc, _ = gradcache_backward(encode, cfg, micro,
                                    torch.Generator().manual_seed(11))
    assert loss_gc.item() == pytest.approx(loss_d.item(), rel=1e-6)
    assert set(direct) == {n for n, p in model.named_parameters()
                           if p.grad is not None}
    for name, p in model.named_parameters():
        if name in direct:
            torch.testing.assert_close(p.grad, direct[name], rtol=1e-4,
                                       atol=1e-6)
    # dropout was on: the same batches in eval mode give another loss
    model.eval()
    with torch.no_grad():
        loss_eval, _ = contrastive_loss(
            torch.cat([encode(qb, None) for qb, _ in micro]),
            torch.cat([encode(pb, None) for _, pb in micro]), cfg)
    assert abs(loss_eval.item() - loss_d.item()) > 1e-4


# ---- optimizer and schedules --------------------------------------------------


def _jax_run(tx, params, grads_seq):
    state = tx.init(params)
    for g in grads_seq:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return params


def _torch_run(state_dtype, lr, w0, grads_seq, dtype, weight_decay):
    w = torch.nn.Parameter(torch.from_numpy(w0).to(dtype))
    opt = optim.adamw_from_config([w], lr, weight_decay=weight_decay,
                                  state_dtype=state_dtype)
    for g in grads_seq:
        w.grad = torch.from_numpy(g).to(dtype)
        opt.step()
    return w.detach().float().numpy()


@pytest.mark.parametrize("state_dtype",
                         ["float32", "bfloat16", "bfloat16_nokahan"])
def test_adamw_matches_jax_fp32_params(state_dtype):
    """5 steps with warmup and weight decay on the same grads; fp32 params:
    2e-5 relative, 1e-6 absolute (float32 is optax.adamw on the JAX side,
    which orders the fp32 operations of the step differently)."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((16, 8)).astype(np.float32)
    grads = [rng.standard_normal((16, 8)).astype(np.float32) * 0.1
             for _ in range(5)]
    jw = _jax_run(joptim.adamw_from_config(
        joptim.constant_schedule_with_warmup(1e-2, 2), weight_decay=0.01,
        state_dtype=state_dtype), {"w": jnp.asarray(w0)},
        [{"w": jnp.asarray(g)} for g in grads])["w"]
    tw = _torch_run(state_dtype, optim.constant_schedule_with_warmup(1e-2, 2),
                    w0, grads, torch.float32, 0.01)
    np.testing.assert_allclose(tw, np.asarray(jw), rtol=2e-5, atol=1e-6)


def test_adamw_bf16_params_match_jax():
    """bf16 params with bf16 states and Kahan: after 5 steps nearly all
    elements equal the JAX result, and every element is within one bf16 ulp
    of it or, near zero where the ulp is tiny, within 2 % of lr (the
    resolution of the bf16 compensation buffer, whose rounding follows the
    last fp32 bits of each side's step)."""
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((64, 32)).astype(np.float32)
    grads = [rng.standard_normal((64, 32)).astype(np.float32)
             for _ in range(5)]
    jw = np.asarray(_jax_run(
        joptim.adamw_from_config(1e-3, state_dtype="bfloat16"),
        {"w": jnp.asarray(w0, jnp.bfloat16)},
        [{"w": jnp.asarray(g)} for g in grads])["w"].astype(jnp.float32))
    tw = _torch_run("bfloat16", 1e-3, w0, grads, torch.bfloat16, 0.0)
    ulp = np.abs(jw) * 2.0 ** -7
    assert (np.abs(tw - jw) <= np.maximum(ulp, 0.02 * 1e-3)).all()
    assert (tw == jw).mean() > 0.99


def test_kahan_recovers_tiny_updates_on_bf16_params():
    """Deltas far below the bf16 ulp at 1.0 accumulate with Kahan and are
    lost without it, on both sides by the same amount (5 % relative)."""
    grads = [np.ones(64, np.float32)] * 400
    moved = {}
    for kahan in (True, False):
        tw = _torch_run("bfloat16" if kahan else "bfloat16_nokahan", 1e-5,
                        np.ones(64, np.float32), grads, torch.bfloat16, 0.0)
        jw = _jax_run(joptim.anyprecision_adamw(1e-5,
                                                use_kahan_summation=kahan),
                      {"w": jnp.ones(64, jnp.bfloat16)},
                      [{"w": jnp.asarray(g)} for g in grads])["w"]
        moved[kahan] = float(np.mean(1.0 - tw))
        assert moved[kahan] == pytest.approx(
            float(jnp.mean(1.0 - jw.astype(jnp.float32))), rel=0.05, abs=1e-6)
    assert moved[True] > 300 * 1e-5
    assert moved[False] < moved[True] / 4


def test_state_dtypes_and_state_dict_round_trip():
    w = torch.nn.Parameter(torch.zeros(4, 4, dtype=torch.bfloat16))
    opt = optim.adamw_from_config([w], 1e-3, state_dtype="float32")
    assert {v.dtype for v in opt.state[w].values()} == {torch.float32}
    w.grad = torch.ones(4, 4, dtype=torch.bfloat16)
    opt.step()
    sd = opt.state_dict()
    other = optim.adamw_from_config([w], 1e-3, state_dtype="float32")
    other.load_state_dict(sd)
    assert other.count == 1
    for key, value in other.state[w].items():
        assert value.dtype == torch.float32
        assert torch.equal(value, opt.state[w][key])
    bf = optim.adamw_from_config([w], 1e-3, state_dtype="bfloat16")
    assert {k: v.dtype for k, v in bf.state[w].items()} == {
        "mu": torch.bfloat16, "nu": torch.bfloat16, "comp": torch.bfloat16}
    with pytest.raises(ValueError):
        optim.adamw_from_config([w], 1e-3, state_dtype="float16")
    with pytest.raises(ValueError):
        bf.load_state_dict(sd)


def test_schedules_match_jax():
    """The trainer's warmup + linear decay against the learning rate the
    JAX make_optimizer applies (read off plain AdamW steps on a constant
    gradient, where each step moves the weight by -lr), and the warmup
    helpers against their JAX versions."""
    from visrag_tpu.config import TrainConfig as JTrainConfig
    from visrag_tpu.training.trainer import make_optimizer as jmake
    total = 20
    jcfg = JTrainConfig(lr=1e-2, warmup_ratio=0.2)
    tx = jmake(jcfg, total)
    params = {"w": jnp.zeros((), jnp.float32)}
    state, lrs = tx.init(params), []
    for _ in range(total + 2):
        u, state = tx.update({"w": jnp.float32(0.5)}, state, params)
        lrs.append(-float(u["w"]))
    sched = lr_schedule(TrainConfig(lr=1e-2, warmup_ratio=0.2), total)
    np.testing.assert_allclose([sched(c) for c in range(total + 2)], lrs,
                               rtol=1e-5, atol=1e-9)
    for steps in (0, 3):
        j = joptim.constant_schedule_with_warmup(0.5, steps)
        t = optim.constant_schedule_with_warmup(0.5, steps)
        for c in range(6):
            want = j(jnp.int32(c)) if callable(j) else j
            got = t(c) if callable(t) else t
            assert got == pytest.approx(float(want), rel=1e-6)
    for args in ((None, 0.1, 50), (7, 0.1, 50), (None, 0.0, 50)):
        assert optim.resolve_warmup_steps(*args) == \
            joptim.resolve_warmup_steps(*args)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(2)
    gs = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    for p, g in zip(ps, gs):
        p.grad = torch.from_numpy(g.copy())
    norm = clip_by_global_norm_(ps, 1.0)
    clipped, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in gs], None)
    assert norm.item() == pytest.approx(float(optax.global_norm(
        [jnp.asarray(g) for g in gs])), rel=1e-6)
    for p, c in zip(ps, clipped):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(c), rtol=1e-6)


# ---- one trainer step against the JAX trainer ---------------------------------


@pytest.fixture(scope="module")
def shared_model():
    """(JAX model, numpy params, raw query batch, raw page batch) on the
    tiny config with ViT patch 2 (the port's own export mapping loads it)."""
    rng = np.random.default_rng(7)
    raw_q, raw_p = _raw(_queries(4)), _raw(_pages(rng, 4))
    jmodel = JVisRAGRet(JVisRAGRetConfig.tiny())
    table = bicubic_table(PCFG.src_grid)
    params = jax.jit(lambda key: jmodel.init(key, jfinish(
        {k: jnp.asarray(v) for k, v in raw_p.items()}, table)))(
        jax.random.PRNGKey(0))
    return jmodel, jax.tree.map(np.asarray, params), raw_q, raw_p


def _jax_path(module_name):
    """The port's module path → the JAX parameter tree's."""
    return re.sub(r"layers\.(\d+)", r"layers_\1", module_name)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_trainer_steps_match_jax(shared_model):
    """Two RetrieverTrainer steps on the same batch in JAX (no mesh) and in
    the port from shared weights: loss and grad norm per step within 1e-4
    relative, and the parameter updates within 1e-2 relative Frobenius
    error (AdamW normalises each element's step, so elements whose
    gradients are near zero differ most). The first step runs at lr 0 (the
    warmup schedule reads count 0). The JAX side freezes the resampler's
    fixed sin-cos pos_embed, as the reference and the port do."""
    jmodel, params, raw_q, raw_p = shared_model
    table = bicubic_table(PCFG.src_grid)
    jq, jp = (jfinish({k: jnp.asarray(v) for k, v in raw.items()}, table)
              for raw in (raw_q, raw_p))

    def encode(p, batch, rng):
        res = p["backbone"]["resampler"]
        res = dict(res, pos_embed=jax.lax.stop_gradient(res["pos_embed"]))
        p = dict(p, backbone=dict(p["backbone"], resampler=res))
        return jmodel.apply({"params": p}, batch)

    kw = dict(lr=1e-3, warmup_ratio=0.0, softmax_temperature=0.05,
              grad_clip=1.0, log_every=1)
    from visrag_tpu.config import TrainConfig as JTrainConfig
    jtr = JTrainer(encode, jax.tree.map(jnp.asarray, params["params"]),
                   JTrainConfig(**kw), total_steps=10)
    jhist = jtr.train([(jq, jp), (jq, jp)])

    model = VisRAGRet(VisRAGRetConfig.tiny())
    from_jax_params(model, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tr = RetrieverTrainer(model, TrainConfig(**kw), total_steps=10)
    batch = [(_finish(raw_q), _finish(raw_p))]
    hist = [tr.train_step(batch) for _ in range(2)]
    for (_, jm), m in zip(jhist, hist):
        assert m["loss"] == pytest.approx(jm["loss"], rel=1e-4)
        assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-4)
        assert m["accuracy"] == jm["accuracy"]

    moved = VisRAGRet(VisRAGRetConfig.tiny())
    from_jax_params(moved, {"backbone": jax.tree.map(
        np.asarray, jtr.params["backbone"])})
    jafter = moved.state_dict()
    num = den = 0.0
    for k, v in model.state_dict().items():
        dt, dj = v - before[k], jafter[k] - before[k]
        num += float(((dt - dj) ** 2).sum())
        den += float((dj ** 2).sum())
    assert den > 0 and (num / den) ** 0.5 <= 1e-2, (num / den) ** 0.5


# ---- LoRA ---------------------------------------------------------------------


def test_lora_trains_only_adapters_and_merge_matches_jax(shared_model):
    """Adapters on every linear layer whose path has a component containing
    q_proj or v_proj, as the JAX lora_init matches them: the LM's q_proj and
    v_proj, and the resampler's kv_proj. A backward gives grads to them and
    to nothing else; with the same A/B the merge equals the JAX lora_merge
    (2e-5 relative, 1e-6 absolute: the rank-r products sum in another
    order)."""
    _, params, raw_q, raw_p = shared_model
    model = VisRAGRet(VisRAGRetConfig.tiny())
    from_jax_params(model, params)
    adapters = lora_init(model, rank=4, alpha=8.0,
                         generator=torch.Generator().manual_seed(0))
    lora_mods = {n: m for n, m in model.named_modules()
                 if isinstance(m, LoRALinear)}
    n_layers = model.cfg.backbone.llm.num_hidden_layers
    assert sorted(lora_mods) == sorted(
        [f"backbone.llm.layers.{i}.self_attn.{p}" for i in range(n_layers)
         for p in ("q_proj", "v_proj")] + ["backbone.resampler.kv_proj"])
    assert [p for p in model.parameters() if p.requires_grad] == adapters

    model.train()
    loss, _ = contrastive_loss(model(_finish(raw_q)), model(_finish(raw_p)),
                               ContrastiveConfig(temperature=0.05))
    loss.backward()
    for name, p in model.named_parameters():
        if name.endswith("lora_b"):
            assert p.grad is not None and p.grad.abs().sum() > 0, name
        elif not name.endswith("lora_a"):
            assert p.grad is None, name

    # the same A/B (B non-zero) on both sides
    rng = np.random.default_rng(9)
    jlora = jlora_init(jax.random.PRNGKey(0), params["params"], rank=4)
    assert sorted(_flat(jlora)) == sorted(
        f"{_jax_path(n)}.{ab}" for n in lora_mods
        for ab in ("lora_a", "lora_b"))
    for name, mod in lora_mods.items():
        a = rng.standard_normal(tuple(mod.lora_a.shape)).astype(np.float32)
        b = rng.standard_normal(tuple(mod.lora_b.shape)).astype(np.float32)
        with torch.no_grad():
            mod.lora_a.copy_(torch.from_numpy(a))
            mod.lora_b.copy_(torch.from_numpy(b))
        node = jlora
        for part in _jax_path(name).split("."):
            node = node[part]
        node["lora_a"], node["lora_b"] = jnp.asarray(a), jnp.asarray(b)
    merged = jlora_merge(params["params"], jlora, rank=4, alpha=8.0)
    state = lora_merge(model).state_dict()
    assert not any(isinstance(m, LoRALinear) for m in model.modules())
    jflat = _flat(jax.tree.map(np.asarray, merged))
    for name in lora_mods:
        np.testing.assert_allclose(state[f"{name}.weight"].numpy(),
                                   jflat[f"{_jax_path(name)}.weight"],
                                   rtol=2e-5, atol=1e-6)


# ---- checkpoint ---------------------------------------------------------------


def test_checkpoint_roundtrip_gc_and_resume_cursor(tmp_path, shared_model):
    """The JAX checkpoint test's layout and retention (newest 2 + best);
    then a trainer resumes model, optimizer, step and data cursor."""
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    root = str(tmp_path / "ckpt")
    for step, metric in [(10, 0.5), (20, 0.9), (30, 0.7), (40, 0.6)]:
        save_checkpoint(root, step, {"state": tree},
                        extra={"batches_seen": step}, best_metric=metric,
                        save_limit=2)
    latest = find_latest_ckpt(root)
    assert latest.endswith("global_step_40")
    restored, extra = load_checkpoint(latest)
    assert torch.equal(restored["state"]["w"], tree["w"])
    assert extra == {"batches_seen": 40}
    kept = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert kept == ["checkpoint_tracker.json", "global_step_20",
                    "global_step_30", "global_step_40"]
    gc_checkpoints(root, 1)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "checkpoint_tracker.json", "global_step_20", "global_step_40"]

    from visrag_tpu_torch.data.datasets import StatefulIterator
    _, params, raw_q, raw_p = shared_model
    cfg = TrainConfig(lr=1e-3, warmup_ratio=0.0, optimizer_state_dtype=
                      "bfloat16")
    model = VisRAGRet(VisRAGRetConfig.tiny())
    from_jax_params(model, params)
    tr = RetrieverTrainer(model, cfg, total_steps=10)
    tr.data_iter = StatefulIterator(lambda: iter(range(10)), cycle=True)
    for _ in range(7):
        next(tr.data_iter)
    batch = [(_finish(raw_q), _finish(raw_p))]
    for _ in range(2):
        tr.train_step(batch)
    out = str(tmp_path / "run")
    tr.save(out)

    fresh = VisRAGRet(VisRAGRetConfig.tiny())
    from_jax_params(fresh, params)
    tr2 = RetrieverTrainer(fresh, cfg, total_steps=10)
    tr2.data_iter = StatefulIterator(lambda: iter(range(10)), cycle=True)
    assert tr2.maybe_resume(out) == 2
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), k
    assert tr2.optimizer.count == 2
    for p, q in zip(tr.params, tr2.params):
        for key, value in tr.optimizer.state[p].items():
            assert torch.equal(value, tr2.optimizer.state[q][key])
    assert next(tr2.data_iter) == 7
    # both continue identically
    assert tr.train_step(batch)["loss"] == tr2.train_step(batch)["loss"]


# ---- the driver ----------------------------------------------------------------


def _img_bytes(rng):
    img = Image.fromarray(rng.integers(0, 255, (24, 18, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture()
def train_parquet(tmp_path):
    """The training pairs of tests/test_drivers.py."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(0)
    pq.write_table(pa.table({
        "query": [f"question {i}" for i in range(8)],
        "image": [{"bytes": _img_bytes(rng)} for _ in range(8)],
    }), tmp_path / "train.parquet")
    (tmp_path / "metadata.json").write_text('{"length": 8}')
    return tmp_path / "train.parquet"


@pytest.mark.parametrize("variant", ["direct", "grad_cache", "lora"])
def test_train_retriever_driver_cpu(train_parquet, tmp_path, variant):
    """train_retriever.main on the CPU as tests/test_drivers.py runs the
    JAX driver; a second run resumes at the saved step and trains no
    further."""
    from visrag_tpu_torch.driver.train_retriever import main
    out = tmp_path / "trained"
    extra = {"direct": [],
             "grad_cache": ["--set", "train.grad_cache=true",
                            "--set", "train.grad_cache_micro_batch_size=2"],
             "lora": ["--set", "train.lora_rank=4"]}[variant]
    argv = ["--train-data", str(train_parquet), "--output-dir", str(out),
            "--tiny", "--device", "cpu", "--set", "train.max_steps=2",
            "--set", "train.log_every=1", "--set", "data.batch_size=4",
            *extra]
    assert main(argv) == 0
    assert (out / "run_config.json").exists()
    latest = find_latest_ckpt(str(out))
    assert latest.endswith("global_step_2")
    tree, extra_state = load_checkpoint(latest)
    assert extra_state == {"step": 2, "data": {"epoch": 0, "row": 8}}
    assert {"model", "optimizer"} <= set(tree)
    assert ("merged_model" in tree) == (variant == "lora")
    hist = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in hist] == [1, 2]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for m in hist)
    assert main(argv) == 0
    assert len((out / "metrics.jsonl").read_text().splitlines()) == 2


def test_train_retriever_driver_refuses_more_than_one_device(train_parquet,
                                                             tmp_path):
    """One process without a process group refuses what needs more: a
    mesh larger than its one device, and a process count without a
    coordinator (the runs across ranks are tests/test_torch_dist_*.py)."""
    from visrag_tpu_torch.driver.train_retriever import main
    base = ["--train-data", str(train_parquet), "--output-dir",
            str(tmp_path / "o"), "--tiny", "--device", "cpu"]
    with pytest.raises(ValueError, match="1 devices"):
        main(base + ["--set", "mesh.data=2"])
    with pytest.raises(ValueError, match="no coordinator"):
        main(base + ["--num-processes", "2"])
    with pytest.raises(ValueError, match="multiple"):
        main(base + ["--set", "train.grad_cache=true",
                     "--set", "train.grad_cache_micro_batch_size=3"])

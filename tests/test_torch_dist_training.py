"""Training across gloo ranks on the CPU: the retriever step with
cross-device negatives under FSDP2 / HSDP (training/trainer.py,
training/contrastive.py) and the SFT step under FSDP2 with Ulysses
sequence parallelism (training/sft.py), against the port's one process
and the JAX package's steps on its CPU mesh; checkpoints between a
sharded trainer and one process; the drivers under torchrun.

Every check starts from shared weights (JAX inits carried into the port)
and one global batch. Tolerances, as the single-process tests state them
(tests/test_torch_training.py, tests/test_torch_sft.py): against JAX,
loss and grad norm within 1e-4 relative (the retriever), loss and token
accuracy 1e-5 and grad norm 1e-4 (SFT), and the parameter update within
1e-2 relative Frobenius error; against the port's one process, the same
fp32 arithmetic split over ranks (sums in another order): loss and grad
norm within 1e-5 relative, the update within 1e-3, and a checkpoint's
tensors bit for bit.

One job of 2 ranks and one of 4 (tests/torch_dist_workers: spawned
processes that import no jax), and one torchrun launch of 2 processes
(eval_retriever across 2 ranks is in tests/test_torch_dist_retrieval.py).
"""

import dataclasses as dc
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec
from PIL import Image

from visrag_tpu.config import MeshConfig as JMeshConfig
from visrag_tpu.config import TrainConfig as JTrainConfig
from visrag_tpu.mesh import build_mesh as jbuild_mesh
from visrag_tpu.models.visrag_ret import VisRAGRet as JVisRAGRet
from visrag_tpu.models.visrag_ret import VisRAGRetConfig as JVisRAGRetConfig
from visrag_tpu.preprocess.device import finish_encode_batch as jfinish
from visrag_tpu.training.trainer import RetrieverTrainer as JTrainer
from visrag_tpu_torch.config import TrainConfig
from visrag_tpu_torch.mesh import free_port
from visrag_tpu_torch.models.hf_loader import (from_jax_params,
                                               qwen_from_jax_params)
from visrag_tpu_torch.models.qwen25_vl import Qwen25VL as Qwen25VLTorch
from visrag_tpu_torch.models.qwen25_vl import \
    Qwen25VLConfig as Qwen25VLConfigTorch
from visrag_tpu_torch.preprocess import MockTokenizer, build_encode_batch
from visrag_tpu_torch.preprocess.transform import bicubic_table
from visrag_tpu_torch.training.checkpoint import load_checkpoint
from visrag_tpu_torch.training.trainer import RetrieverTrainer
from torch_dist_workers import (critic_update, micro_batches, rl_config,
                                rl_trainer, rl_update, spawn, tiny_critic,
                                tiny_pcfg, tiny_retriever, training_job)
from test_torch_rl import tiny_ckpt  # noqa: F401  (fixture)

TRAIN_KW = dict(lr=1e-3, warmup_ratio=0.0, softmax_temperature=0.05,
                grad_clip=1.0, log_every=1)
SFT_KW = dict(lr=1e-3, weight_decay=0.1, warmup_steps=0)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny models run fastest on one thread, and the suite's workers
    (and this file's spawned ranks) share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _as_step_outputs(tree, mesh):
    """Every array placed on `mesh` with its spec's trailing Nones dropped
    (replicated where it had no NamedSharding): the placements a jitted
    step's outputs carry, so that the step's second call finds the
    program its first compiled (the same values either way)."""
    def put(x):
        spec = tuple(x.sharding.spec) \
            if isinstance(x.sharding, NamedSharding) else ()
        while spec and spec[-1] is None:
            spec = spec[:-1]
        return jax.device_put(x, NamedSharding(mesh, PartitionSpec(*spec)))
    return jax.tree.map(put, tree)


def _rel(got, want):
    num = sum(float(((np.asarray(a) - np.asarray(b)) ** 2).sum())
              for a, b in zip(got, want))
    den = sum(float((np.asarray(b) ** 2).sum()) for b in want)
    assert den > 0
    return (num / den) ** 0.5


def _update_err(after, want_after, before, names):
    return _rel([after[k] - before[k] for k in names],
                [want_after[k] - before[k] for k in names])


def _close_hist(got, want, rel):
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], rel=rel)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=rel)


# ---- the retriever ----------------------------------------------------------


@pytest.fixture(scope="module")
def retriever(tmp_path_factory):
    """Shared tiny weights, a global batch of 4 (query, page) pairs, the
    port's one-process runs (direct and GradCache, two steps each, the
    direct one saved), and JAX's trainer on a (replica 2, data 2) mesh."""
    rng = np.random.default_rng(7)
    sizes = [(20, 14), (9, 30), (16, 16), (24, 10)]
    pages = [("", Image.fromarray(rng.integers(0, 255, (*sizes[i], 3),
                                               dtype=np.uint8)))
             for i in range(4)]
    queries = [(f"which page shows item {i}?", None) for i in range(4)]
    pcfg = tiny_pcfg()
    table = bicubic_table(pcfg.src_grid)
    # the JAX trainer shards every array's dim 0 over the 4 devices: slice
    # buffers of 4 and 40 slots (the port builds each rank's own batch)
    jq, jp = (jfinish({k: jnp.asarray(v) for k, v in build_encode_batch(
        MockTokenizer(), items, pcfg, n_slice_slots=slots,
        device_mode=True).items()}, table)
        for items, slots in ((queries, 4), (pages, 40)))
    jmodel = JVisRAGRet(JVisRAGRetConfig.tiny())
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jp))
    before = tiny_retriever(params).state_dict()

    one, ckpt = {}, str(tmp_path_factory.mktemp("one_ckpt"))
    for grad_cache, micro in ((False, 4), (True, 1)):
        tr = RetrieverTrainer(tiny_retriever(params), TrainConfig(
            **TRAIN_KW, grad_cache=grad_cache,
            grad_cache_micro_batch_size=micro), total_steps=10)
        batch = micro_batches(queries, pages, micro)
        hist = [tr.train_step(batch) for _ in range(2)]
        one[grad_cache] = (hist, tr.model.state_dict())
        if not grad_cache:
            tr.save(ckpt)

    def encode(p, batch, rng):
        res = p["backbone"]["resampler"]
        res = dict(res, pos_embed=jax.lax.stop_gradient(res["pos_embed"]))
        return jmodel.apply({"params": dict(p, backbone=dict(
            p["backbone"], resampler=res))}, batch)

    jmesh = jbuild_mesh(JMeshConfig(replica=2, data=2),
                        devices=jax.devices()[:4])
    jtr = JTrainer(encode, jax.tree.map(jnp.asarray, params["params"]),
                   JTrainConfig(**TRAIN_KW), mesh=jmesh, total_steps=10)
    jtr.params, jtr.opt_state = _as_step_outputs(
        (jtr.params, jtr.opt_state), jmesh)
    jhist = [m for _, m in jtr.train([(jq, jp), (jq, jp)])]
    moved = tiny_retriever(params)
    from_jax_params(moved, {"backbone": jax.tree.map(
        np.asarray, jtr.params["backbone"])})
    return dict(params=params, queries=queries, pages=pages, before=before,
                one=one, ckpt=ckpt, jax=(jhist, moved.state_dict()))


@pytest.fixture(scope="module")
def two(retriever, lora, rl, tmp_path_factory):
    """The 2-rank job: the retriever runs, LoRA (the trainer and
    train_retriever's merged save), and the RS-GRPO cases at data 2."""
    save_to = str(tmp_path_factory.mktemp("two_ckpt"))
    r = retriever
    ranks = spawn(training_job, 2,
                  (r["params"], r["queries"], r["pages"], TRAIN_KW,
                   dict(data=2), [(False, 2), (True, 1)], r["ckpt"],
                   save_to),
                  None, lora["args"](dict(data=2)),
                  ([("visrag_tpu_torch.driver.train_retriever",
                     lora["argv"](lora["dist_dir"]))],),
                  rl["args"](2))
    return [dict(rank[0], lora=rank[2], driver=rank[3], rl=rank[4])
            for rank in ranks], save_to


@pytest.fixture(scope="module")
def four(retriever, sft, lora, rl):
    r = retriever
    return spawn(training_job, 4,
                 (r["params"], r["queries"], r["pages"], TRAIN_KW,
                  dict(replica=2, data=2), [(False, 1), (True, 1)]),
                 (sft["state"], {"remat": True},
                  dict(SFT_KW, ulysses_size=2), dict(data=2, seq=2),
                  sft["batch"], 2),
                 lora["args"](dict(replica=2, data=2)), None,
                 rl["args"](4))


def _check_retriever_runs(runs, retriever):
    before = retriever["before"]
    names = [k for k in before if k.endswith("weight") or
             k.endswith("bias")]
    jhist, jafter = retriever["jax"]
    for (hist, state), grad_cache in zip(runs, (False, True)):
        one_hist, one_state = retriever["one"][grad_cache]
        _close_hist(hist, one_hist, 1e-5)
        assert [m["accuracy"] for m in hist] == \
            [m["accuracy"] for m in one_hist]
        state = {k: torch.from_numpy(v) for k, v in state.items()}
        assert _update_err(state, one_state, before, names) <= 1e-3
        _close_hist(hist, jhist, 1e-4)
        assert _update_err(state, jafter, before, names) <= 1e-2


def test_retriever_step_data2_matches_one_process_and_jax(two, retriever):
    """data=2: direct and GradCache (2 micro-batches of 1 per rank), with
    the negatives of both ranks."""
    ranks, _ = two
    assert [m for m, _ in ranks[1]["runs"]] == \
        [m for m, _ in ranks[0]["runs"]]
    _check_retriever_runs(ranks[0]["runs"], retriever)


def test_retriever_step_hsdp_matches_one_process_and_jax(four, retriever):
    """replica=2 x data=2 (HSDP: sharded over data, replicated over
    replica), direct and GradCache."""
    _check_retriever_runs(four[0][0]["runs"], retriever)


def test_checkpoints_cross_between_one_process_and_two_ranks(two,
                                                             retriever):
    """The 2-rank trainer resumed from the one-process checkpoint holds
    its tensors bit for bit; a one-process trainer resumed from the
    2-rank trainer's checkpoint holds the 2-rank weights and states."""
    ranks, save_to = two
    step, tree = ranks[0]["resumed"]
    one_tree, _ = load_checkpoint(os.path.join(retriever["ckpt"],
                                               "global_step_2"))
    assert step == 2
    for k, v in one_tree["model"].items():
        np.testing.assert_array_equal(tree["model"][k], v.float().numpy())
    assert tree["optimizer"]["count"] == one_tree["optimizer"]["count"]
    for got, want in zip(tree["optimizer"]["state"],
                         one_tree["optimizer"]["state"]):
        for key in want:
            np.testing.assert_array_equal(got[key], want[key].float().numpy())

    fresh = RetrieverTrainer(tiny_retriever(retriever["params"]),
                             TrainConfig(**TRAIN_KW), total_steps=10)
    assert fresh.maybe_resume(save_to) == 2
    _, last_state = ranks[0]["runs"][-1]
    for k, v in fresh.model.state_dict().items():
        np.testing.assert_array_equal(v.float().numpy(), last_state[k])
    assert fresh.optimizer.count == 2


# ---- LoRA -------------------------------------------------------------------

LORA_KW = dict(rank=4, alpha=8.0)
LORA_STEPS = 2


@pytest.fixture(scope="module")
def lora(retriever, tmp_path_factory):
    """The one-process LoRA runs the ranks are held to: RetrieverTrainer
    with the adapters (two direct steps on the global batch of 4) and
    train_retriever.main with train.lora_rank on the tiny config (its
    merged save)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from test_torch_slice import _img_bytes
    from visrag_tpu_torch.driver.train_retriever import main as train_main
    from visrag_tpu_torch.training.lora import lora_init, lora_merged_state
    r = retriever
    model = tiny_retriever(r["params"])
    base = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    adapters = lora_init(model, generator=torch.Generator().manual_seed(0),
                         **LORA_KW)
    init = {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items() if ".lora_" in k}
    tr = RetrieverTrainer(model, TrainConfig(**TRAIN_KW), total_steps=10,
                          params=adapters)
    batch = micro_batches(r["queries"], r["pages"], 4)
    hist = [tr.train_step(batch) for _ in range(LORA_STEPS)]
    state = model.state_dict()
    one = (hist, {k: v.numpy() for k, v in state.items() if ".lora_" in k},
           {k: v.numpy() for k, v in lora_merged_state(model).items()})

    d = tmp_path_factory.mktemp("lora_driver")
    rng = np.random.default_rng(3)
    pq.write_table(pa.table({
        "query": [f"question {i}" for i in range(8)],
        "image": [{"bytes": _img_bytes(rng)} for _ in range(8)]}),
        d / "train.parquet")
    (d / "metadata.json").write_text('{"length": 8}')

    def argv(out):
        return ["--train-data", str(d / "train.parquet"), "--tiny",
                "--device", "cpu", "--output-dir", str(out),
                "--set", "train.max_steps=2", "--set", "train.log_every=1",
                "--set", "data.batch_size=4", "--set", "train.lora_rank=4",
                "--set", "train.lr=1e-3", "--set", "train.warmup_ratio=0"]
    assert train_main(argv(d / "one")) == 0
    return dict(one=one, init=init, base=base, argv=argv, dir=d,
                dist_dir=d / "dist",
                args=lambda mesh_kw: (r["params"], r["queries"], r["pages"],
                                      TRAIN_KW, mesh_kw, LORA_KW,
                                      LORA_STEPS))


def _check_lora(got, lora):
    """Loss and grad norm within 1e-5, the adapters' update and the merged
    weights' change within 1e-3 relative Frobenius error of one
    process's."""
    hist, state = got
    one_hist, one_adapters, one_merged = lora["one"]
    _close_hist(hist, one_hist, 1e-5)
    for key, one, before in (("adapters", one_adapters, lora["init"]),
                             ("merged", one_merged, lora["base"])):
        assert sorted(state[key]) == sorted(one)
        names = [k for k in one if not np.array_equal(one[k], before[k])]
        assert names
        assert _update_err({k: torch.from_numpy(v)
                            for k, v in state[key].items()},
                           {k: torch.from_numpy(v) for k, v in one.items()},
                           {k: torch.from_numpy(v)
                            for k, v in before.items()}, names) <= 1e-3


def test_lora_step_data2_matches_one_process(two, lora):
    """data=2: the adapters after two steps (FSDP2 shards each block's
    frozen base with its adapters; only the adapters train) and the
    merged weights, against one process."""
    ranks, _ = two
    assert ranks[1]["lora"][0] == ranks[0]["lora"][0]
    _check_lora(ranks[0]["lora"], lora)


def test_lora_step_hsdp_matches_one_process(four, lora):
    """replica=2 x data=2 (HSDP), the same step."""
    _check_lora(four[0][2], lora)


def test_lora_driver_merged_save_at_two_ranks(two, lora):
    """train_retriever.main with train.lora_rank=4 across 2 ranks: every
    rank gathers, rank 0 merges and writes merged_model: the one-process
    driver's keys, and its tensors within 1e-5 (the same fp32 step split
    over two ranks)."""
    ranks, _ = two
    assert ranks[0]["driver"] == ranks[1]["driver"] == [0]
    got, _ = load_checkpoint(str(lora["dist_dir"] / "global_step_2"))
    want, _ = load_checkpoint(str(lora["dir"] / "one" / "global_step_2"))
    got, want = got["merged_model"], want["merged_model"]
    assert sorted(got) == sorted(want)
    assert not any(".lora_" in k for k in got)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   msg=k)


# ---- SFT --------------------------------------------------------------------


@pytest.fixture(scope="module")
def sft():
    """The tiny Qwen2.5-VL from a JAX init (one image: the tower's
    weights too) carried into the port as tests/test_torch_sft.py carries
    its shared weights, a global batch of 4 right-padded rows of 16
    tokens, the port's one-process make_sft_step and JAX's on a data 2 x
    seq 2 mesh with ulysses_size 2, two steps each."""
    from test_torch_sft import _as_port_tensors, _batch, _jax_sft, \
        _port_model
    from visrag_tpu.models.qwen25_vl import Qwen25VL as JQwen
    from visrag_tpu.models.qwen25_vl import Qwen25VLConfig as JQwenConfig
    from visrag_tpu.preprocess import qwen_vision as jqv
    from visrag_tpu_torch.training.sft import SFTConfig, make_sft_step
    jcfg = JQwenConfig.tiny()
    vb = jqv.prepare_vision_batch(
        [Image.fromarray(np.zeros((56, 56, 3), np.uint8))],
        head_dim=jcfg.vision.head_dim, min_pixels=56 * 56,
        max_pixels=56 * 56)
    n = vb.reverse_index.shape[0]
    ids = np.full((1, n + 2), 5, np.int32)
    slot = np.full(ids.shape, -1, np.int32)
    slot[0, 1:n + 1] = np.arange(n)
    vision = {k: jnp.asarray(getattr(vb, k)) for k in
              ("patches", "rot_cos", "rot_sin", "seg_window", "seg_full",
               "reverse_index")}
    shared = jax.tree.map(np.asarray, jax.jit(lambda key: JQwen(jcfg).init(
        key, jnp.asarray(ids), vision_batch=vision,
        slot_map=jnp.asarray(slot)))(jax.random.PRNGKey(1)))
    model = _port_model(shared)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = {k: v.numpy().copy() for k, v in before.items()}
    batch = _batch(1, lens=(16, 11, 7, 13))
    _, step = make_sft_step(model, SFTConfig(**SFT_KW))
    one = ([{k: float(v) for k, v in step(batch).items()} for _ in range(2)],
           model.state_dict())

    cfg = SFTConfig(**SFT_KW, ulysses_size=2)
    apply, jsft = _jax_sft(cfg)
    jmesh = jbuild_mesh(JMeshConfig(data=2, seq=2),
                        devices=jax.devices()[:4])
    tx, jstep = jsft.make_sft_step(apply, cfg, mesh=jmesh)
    params = _as_step_outputs(jax.tree.map(jnp.asarray, shared), jmesh)
    opt_state = _as_step_outputs(tx.init(params), jmesh)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jhist = []
    for _ in range(2):
        params, opt_state, m = jstep(params, opt_state, jb)
        jhist.append({k: float(v) for k, v in m.items()})
    return dict(state=state, batch=batch, before=before, one=one,
                jax=(jhist, _as_port_tensors(shared, params)),
                jparams=shared)


def test_sft_step_data2_seq2_matches_one_process_and_jax(four, sft):
    """data=2 x seq=2: each data rank's 2 rows split in 2 sequence blocks
    of 8 tokens (Ulysses all_to_all around the segment kernel's plain
    version); FSDP2 over the 4 ranks; whole-block remat, as sft_main runs
    (each block recomputed in the backward through FSDP2's hooks)."""
    hist, state = four[0][1]
    assert four[1][1][0] == hist
    before = sft["before"]
    names = [k for k in before if not k.startswith("visual.")]
    state = {k: torch.from_numpy(v) for k, v in state.items()}
    for ref_hist, ref_state, tol in ((*sft["one"], 1e-3),
                                     (*sft["jax"], 1e-2)):
        for g, w in zip(hist, ref_hist):
            for k in ("loss", "token_accuracy"):
                assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-5), k
            assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
        assert _update_err(state, ref_state, before, names) <= tol
    assert all(torch.equal(state[k], before[k]) for k in before
               if k.startswith("visual."))


# ---- RS-GRPO ----------------------------------------------------------------

RL_RTOL, RL_ATOL = 2e-4, 2e-5      # the JAX package's sharded-update bar
RL_LR = 1e-3


def _close_weights(got, want, before):
    """Every tensor within RL_RTOL / RL_ATOL of `want`, except the key
    projections' biases: their gradient is zero in exact arithmetic (a
    bias on the keys shifts a query's scores by one constant, which the
    softmax removes), so AdamW's first step there is rounding noise of
    about its eps normalised to up to lr, and one process's port and the
    JAX package already differ there by ~2e-5. Those move from `before`
    by at most lr (and the weight decay's share of it) in both."""
    for k, v in want.items():
        if k.endswith("k_proj.bias"):
            for x in (got[k], v):
                assert np.abs(x - before[k]).max() <= 1.1 * RL_LR, k
            continue
        np.testing.assert_allclose(got[k], v, rtol=RL_RTOL, atol=RL_ATOL,
                                   err_msg=k)
RL_UPDATES = {"padded": dict(padding_free=False, kl_coef=0.02),
              "packed": dict(padding_free=True, kl_coef=0.02)}
RL_SP = {"ulysses": ({}, None),
         "ring": ({"sp_backend": "ring"}, {"sp_backend": "ring"})}


def _jax_update(shared, cfg, batch):
    from test_torch_rl import _jax_trainer
    jt = _jax_trainer(shared, cfg, ref_params=jax.tree.map(jnp.asarray,
                                                           shared))
    b = dict(batch)
    b["old_log_probs"] = jt.compute_log_probs(jt.params, b)
    ref = jt.compute_log_probs(jt.ref_params, b)
    b["ref_log_probs"] = ref - 0.1 * batch["response_mask"]
    m = jt.update_policy(b)
    moved = Qwen25VLTorch(Qwen25VLConfigTorch.tiny())
    qwen_from_jax_params(moved, jax.tree.map(np.asarray, jt.params))
    return b["old_log_probs"], m, {k: v.numpy() for k, v in
                                   moved.state_dict().items()}


@pytest.fixture(scope="module")
def rl(sft, tmp_path_factory):
    """The RS-GRPO inputs and what the ranks are held to: the tiny
    Qwen2.5-VL's shared weights (the SFT fixture's JAX init) and a critic
    over its text stack with a seeded score head; one synthetic
    post-rollout batch (tests/test_rl.py's); the port's one-process padded
    and packed updates, critic update and greedy rollout, and the JAX
    one-device updates and critic; a one-process GAE trainer's checkpoint
    for the ranks to resume."""
    from test_torch_critic import _jax_critic, _port_value
    from test_torch_rl import _synth, _vision_prompt
    from visrag_tpu_torch.rl.critic import CriticTrainer
    shared, state = sft["jparams"], sft["state"]
    text = shared["params"]["model"]
    vshared = {"params": {"model": text, "score": {"weight": (
        np.random.default_rng(2).normal(0, 0.1, (
            1, text["embed_tokens"]["embedding"].shape[1]))
        .astype(np.float32))}}}
    vstate = {k: v.numpy().copy()
              for k, v in _port_value(vshared).state_dict().items()}
    batch = _synth(7)
    one, jx = {}, {}
    for name, actor_kw in RL_UPDATES.items():
        cfg = rl_config(actor_kw)
        t = rl_trainer(state, cfg, None, ref=True)
        one[name] = (*rl_update(t, batch), {k: v.numpy() for k, v in
                                            t.model.state_dict().items()})
        jx[name] = _jax_update(shared, cfg, batch)

    cfg = rl_config(critic={"lr": 1e-3})
    cbatch = _synth(5)
    jc = _jax_critic(vshared, cfg)
    jv = jc.compute_values(cbatch)
    cbatch["values"] = jv
    cbatch["returns"] = (jv + np.random.default_rng(6).normal(
        0, 0.8, jv.shape)).astype(np.float32)
    jc.update(dict(cbatch))
    c = CriticTrainer(tiny_critic(vstate), cfg.critic,
                      global_batch_size=cfg.trainer.global_batch_size)
    one["critic"] = (*critic_update(c, cbatch), {
        k: v.numpy() for k, v in c.model.state_dict().items()})
    jx["critic"] = (jv, {k: v.numpy() for k, v in _port_value(
        jax.tree.map(np.asarray, jc.params)).state_dict().items()})

    rng = np.random.default_rng(4)
    prompts = [dict(input_ids=rng.integers(0, 100, size=(6,))
                    .astype(np.int32), ground_truth="gt6"),
               _vision_prompt(rng),
               dict(input_ids=rng.integers(0, 100, size=(11,))
                    .astype(np.int32), ground_truth="gt11")]
    rb = rl_trainer(state, rl_config(), None).rollout(prompts, 0, n=2,
                                                       temperature=0.0)
    one["rollout"] = {f.name: getattr(rb, f.name)
                      for f in dc.fields(rb)}

    # a one-process GAE trainer after one update of each model, saved
    src = str(tmp_path_factory.mktemp("rl_one_ckpt"))
    gcfg = rl_config(algorithm={"adv_estimator": "gae"},
                     trainer={"output_dir": src})
    gc = CriticTrainer(tiny_critic(vstate), gcfg.critic)
    gt = rl_trainer(state, gcfg, None, critic=gc)
    b = dict(batch)
    b["old_log_probs"] = gt.compute_log_probs(gt.model, b)
    gt.update_policy(b)
    gc.update(dict(cbatch))
    gt.step, gt._rng = 1, torch.Generator().manual_seed(5)
    gt.save()
    dst = str(tmp_path_factory.mktemp("rl_dist_ckpt"))

    def args(world):
        if world == 2:
            cases = [("update", dict(data=2), (batch, kw, None))
                     for kw in RL_UPDATES.values()]
            cases += [("critic", dict(data=2), (cbatch,)),
                      ("rollout", dict(data=2), (prompts, 2)),
                      ("resume", dict(data=2), (batch, src, dst))]
        else:
            cases = [("update", dict(data=2, seq=2),
                      (batch, dict(RL_UPDATES["packed"], ulysses_size=2,
                                   **actor_kw), text_over))
                     for actor_kw, text_over in RL_SP.values()]
        return state, vstate, cases
    return dict(one=one, jax=jx, args=args, src=src, dst=dst, gcfg=gcfg,
                state=state, vstate=vstate,
                critic_valid=cbatch["attention_mask"].astype(bool))


def _check_update(got, one, jx, before):
    """Old log-probs (and the reference pass, the same weights) and the
    weights after one update against one process (rl_update) and the JAX
    one-device update, at the JAX package's sharded-update tolerance."""
    logp, ref, metrics, state = got
    one_logp, _, one_metrics, one_state = one
    jlogp, jmetrics, jstate = jx
    np.testing.assert_allclose(logp, one_logp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ref, logp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(logp, jlogp, rtol=1e-4, atol=1e-4)
    for k in ("loss", "grad_norm", "kl_loss", "entropy_loss"):
        assert metrics[k] == pytest.approx(one_metrics[k], rel=1e-5,
                                           abs=1e-7), k
        assert metrics[k] == pytest.approx(jmetrics[k], rel=1e-3,
                                           abs=1e-6), k
    assert metrics["grad_skipped"] == 0.0
    for want in (one_state, jstate):
        _close_weights(state, want, before)


@pytest.mark.parametrize("layout", list(RL_UPDATES))
def test_rl_update_data2_matches_one_process_and_jax(two, rl, layout):
    """data=2: compute_log_probs of the FSDP2 actor and reference policy
    and one update_policy, padded (K1 / K2's plain versions) or packed
    (K4's), each rank on its part of every micro-batch."""
    ranks, _ = two
    at = list(RL_UPDATES).index(layout)
    assert ranks[1]["rl"][at][2] == ranks[0]["rl"][at][2]
    _check_update(ranks[0]["rl"][at], rl["one"][layout], rl["jax"][layout],
                  rl["state"])


@pytest.mark.parametrize("backend", list(RL_SP))
def test_rl_packed_update_data2_seq2_matches(four, rl, backend):
    """data=2 x seq=2, actor.ulysses_size=2: the packed update and its
    log-probs sequence-parallel (Ulysses all_to_all around K4's plain
    version, or the ring), FSDP2 over the 4 ranks, against the packed
    one-process and JAX updates."""
    at = list(RL_SP).index(backend)
    got = four[0][4][at]
    assert all(r[4][at][2] == got[2] for r in four)
    _check_update(got, rl["one"]["packed"], rl["jax"]["packed"],
                  rl["state"])


def test_gae_critic_data2_matches_one_process_and_jax(two, rl):
    """data=2: the critic's values (gathered to the global batch) and one
    clipped value update, against one process and the JAX critic."""
    ranks, _ = two
    values, metrics, state = ranks[0]["rl"][2]
    before = rl["vstate"]
    one_values, one_metrics, one_state = rl["one"]["critic"]
    jvalues, jstate = rl["jax"]["critic"]
    valid = rl["critic_valid"]
    np.testing.assert_allclose(values, one_values, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(values[valid], jvalues[valid], rtol=1e-4,
                               atol=1e-4)
    for k, v in one_metrics.items():
        assert metrics[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    for want in (one_state, jstate):
        _close_weights(state, want, before)


def test_greedy_rollout_data2_equals_one_process(two, rl):
    """data=2, temperature 0: each rank rolls out its share of the 3
    prompts (one multimodal) on its whole copy of the actor, and every
    rank holds the one-process RolloutBatch, row for row."""
    ranks, _ = two
    want = rl["one"]["rollout"]
    for rank in ranks:
        got = rank["rl"][3]
        for name, w in want.items():
            if name == "vision":
                assert sorted(got[name]) == sorted(w)
                for k in w:
                    np.testing.assert_array_equal(got[name][k], w[k], k)
            elif isinstance(w, np.ndarray):
                np.testing.assert_array_equal(got[name], w, name)
            else:
                assert got[name] == w, name


def test_rl_checkpoints_cross_between_one_process_and_two_ranks(two, rl):
    """A one-process GAE trainer's checkpoint (actor, critic, both
    optimizers, the rng) resumes at 2 ranks bit for bit; the 2-rank
    trainer's own save resumes in one process to the same tensors."""
    from visrag_tpu_torch.rl.critic import CriticTrainer
    from visrag_tpu_torch.training.checkpoint import find_latest_ckpt
    ranks, _ = two
    got = ranks[0]["rl"][4]
    assert got["ok"] and got["step"] == 1
    tree, extra = load_checkpoint(find_latest_ckpt(rl["src"]))
    for key, want in (("model", tree["model"]),
                      ("critic", tree["critic_model"])):
        for k, v in want.items():
            np.testing.assert_array_equal(got[key][k], v.numpy(), k)
    for key in ("optimizer", "critic_optimizer"):
        assert got[key]["count"] == tree[key]["count"] == 1
        for g, w in zip(got[key]["state"], tree[key]["state"]):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k].float().numpy())
    np.testing.assert_array_equal(got["rng"], np.asarray(extra["rng"],
                                                         np.uint8))
    cfg = dc.replace(rl["gcfg"], trainer=dc.replace(rl["gcfg"].trainer,
                                                    output_dir=rl["dst"]))
    c = CriticTrainer(tiny_critic(rl["vstate"]), cfg.critic)
    t = rl_trainer(rl["state"], cfg, None, critic=c)
    assert t.maybe_resume() and t.step == 1
    for module, key in ((t.model, "model"), (c.model, "critic")):
        for k, v in module.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), got[key][k], k)


# ---- the drivers under torchrun ---------------------------------------------


def _torchrun(module, args):
    """Start `module` as 2 gloo ranks under torchrun. → the process."""
    # transformers' tokenizer classes import no TensorFlow or Flax there
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT, USE_TF="0",
               USE_FLAX="0")
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", "2", "--master_addr", "localhost",
           "--master_port", str(free_port()), "-m", module, *args]
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finished(proc, timeout=240):
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        _, err = proc.communicate()
    assert proc.returncode == 0, err[-4000:]


def test_drivers_under_torchrun(tmp_path, tiny_ckpt):
    """train_retriever as 2 gloo ranks under torchrun with --device cpu on
    the tiny config: the retriever trains 2 steps from the global batch of
    4 (2 rows a rank) with the losses of one process and checkpoints the
    global data cursor. rl_main as 2 gloo ranks on the tiny HF checkpoint
    (FSDP2 actor and reference policy, the rollout split over the ranks)
    for 1 step at temperature 0: the step's metrics are one process's,
    and rank 0 writes the checkpoint. The two launches run side by side."""
    from test_torch_slice import _img_bytes
    from test_torch_rl import _rl_args
    import pyarrow as pa
    import pyarrow.parquet as pq
    from visrag_tpu_torch.driver.rl_main import main as rl_main
    from visrag_tpu_torch.driver.train_retriever import main as train_main
    rng = np.random.default_rng(0)
    pq.write_table(pa.table({
        "query": [f"question {i}" for i in range(8)],
        "image": [{"bytes": _img_bytes(rng)} for _ in range(8)]}),
        tmp_path / "train.parquet")
    (tmp_path / "metadata.json").write_text('{"length": 8}')
    common = ["--train-data", str(tmp_path / "train.parquet"), "--tiny",
              "--device", "cpu", "--set", "train.max_steps=2",
              "--set", "train.log_every=1", "--set", "data.batch_size=4"]
    out = tmp_path / "trained"
    greedy = ["--set", "rollout.temperature=0"]
    launches = [_torchrun("visrag_tpu_torch.driver.train_retriever",
                          common + ["--output-dir", str(out)]),
                _torchrun("visrag_tpu_torch.driver.rl_main",
                          _rl_args(tiny_ckpt, tmp_path, tmp_path / "rl")
                          + greedy)]
    assert train_main(common + ["--output-dir", str(tmp_path / "one")]) == 0
    assert rl_main(_rl_args(tiny_ckpt, tmp_path, tmp_path / "rl_one")
                   + greedy) == 0
    for proc in launches:
        _finished(proc)
    hist, one = ([json.loads(line) for line in
                  (d / "metrics.jsonl").read_text().splitlines()]
                 for d in (out, tmp_path / "one"))
    assert [m["step"] for m in hist] == [1, 2]
    for g, w in zip(hist, one):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-5)
    tree, extra = load_checkpoint(str(out / "global_step_2"))
    assert extra == {"step": 2, "data": {"epoch": 0, "row": 8}}
    assert {"model", "optimizer"} <= set(tree)

    (got,), (want,) = ([json.loads(line) for line in
                        (tmp_path / d / "metrics.jsonl").read_text()
                        .splitlines()] for d in ("rl", "rl_one"))
    assert got["step"] == 1
    for k in ("loss", "grad_norm", "kl_loss", "reward_mean",
              "response_length/mean"):
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k
    _, extra = load_checkpoint(str(tmp_path / "rl" / "global_step_1"))
    assert extra["step"] == 1 and extra["data"]["row"] == 4

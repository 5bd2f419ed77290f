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
from visrag_tpu_torch.models.hf_loader import from_jax_params
from visrag_tpu_torch.preprocess import MockTokenizer, build_encode_batch
from visrag_tpu_torch.preprocess.transform import bicubic_table
from visrag_tpu_torch.training.checkpoint import load_checkpoint
from visrag_tpu_torch.training.trainer import RetrieverTrainer
from torch_dist_workers import (micro_batches, retriever_steps, spawn,
                                tiny_pcfg, tiny_retriever, training_job)

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
def two(retriever, tmp_path_factory):
    save_to = str(tmp_path_factory.mktemp("two_ckpt"))
    r = retriever
    ranks = spawn(retriever_steps, 2, r["params"], r["queries"], r["pages"],
                  TRAIN_KW, dict(data=2), [(False, 2), (True, 1)],
                  r["ckpt"], save_to)
    return ranks, save_to


@pytest.fixture(scope="module")
def four(retriever, sft):
    r = retriever
    return spawn(training_job, 4,
                 (r["params"], r["queries"], r["pages"], TRAIN_KW,
                  dict(replica=2, data=2), [(False, 1), (True, 1)]),
                 (sft["state"], {"remat": True},
                  dict(SFT_KW, ulysses_size=2), dict(data=2, seq=2),
                  sft["batch"], 2))


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
                jax=(jhist, _as_port_tensors(shared, params)))


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


# ---- the drivers under torchrun ---------------------------------------------


def _torchrun(module, args, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", "2", "--master_addr", "localhost",
           "--master_port", str(free_port()), "-m", module, *args]
    done = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert done.returncode == 0, done.stderr[-4000:]
    return done


def test_drivers_under_torchrun(tmp_path):
    """train_retriever as 2 gloo ranks under torchrun with --device cpu on
    the tiny config: the retriever trains 2 steps from the global batch of
    4 (2 rows a rank) with the losses of one process and checkpoints the
    global data cursor."""
    from test_torch_slice import _img_bytes
    import pyarrow as pa
    import pyarrow.parquet as pq
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
    _torchrun("visrag_tpu_torch.driver.train_retriever",
              common + ["--output-dir", str(out)])
    assert train_main(common + ["--output-dir", str(tmp_path / "one")]) == 0
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

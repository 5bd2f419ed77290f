"""visrag_tpu_torch SFT (training/sft.py, driver/sft_main.py) against the
JAX package.

One tiny HF Qwen2.5-VL (tests/test_qwen25_vl.py's `_hf_tiny`, fp32) is
loaded into the JAX model and, through `qwen_from_jax_params`, into the
port; the batch is right-padded rows of three lengths from numpy, so the
port's attention is the valid-length path (its plain version on the CPU).
Tolerances (fp32 on the CPU): 1e-5 on the loss and token accuracy, 1e-4
relative Frobenius error on the parameter gradients and 1e-4 relative on
the gradient norm, 1e-2 relative Frobenius error on the parameter update
(AdamW normalises each element's step, so elements whose gradients are
near zero differ most: the optimizer test's tolerance).
"""

import dataclasses as dc
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visrag_tpu_torch.models.hf_loader import qwen_from_jax_params
from visrag_tpu_torch.models.qwen25_vl import Qwen25VL, Qwen25VLConfig
from visrag_tpu_torch.training.sft import (SFTConfig, make_sft_step,
                                           sft_loss, token_accuracy)


@pytest.fixture(scope="module")
def shared():
    """JAX params of the tiny HF model, as numpy."""
    from test_qwen25_vl import _hf_tiny
    from visrag_tpu.models.hf_loader import convert_qwen25_vl
    ref, _ = _hf_tiny()
    return jax.tree.map(np.asarray,
                        {"params": convert_qwen25_vl(dict(ref.state_dict()))})


def _port_model(shared):
    model = Qwen25VL(Qwen25VLConfig.tiny())
    qwen_from_jax_params(model, shared)
    return model


def _batch(seed=0, lens=(16, 11, 7), S=16):
    rng = np.random.default_rng(seed)
    bs = len(lens)
    ids = rng.integers(1, 100, (bs, S)).astype(np.int32)
    att = np.zeros((bs, S), np.int32)
    rm = np.zeros((bs, S), np.int32)
    for i, n in enumerate(lens):
        ids[i, n:] = 0
        att[i, :n] = 1
        rm[i, 3 + i:n] = 1
    pos = np.broadcast_to(np.arange(S), (3, bs, S)).astype(np.int32)
    return {"input_ids": ids, "attention_mask": att, "response_mask": rm,
            "positions": pos}


def _jax_sft(cfg):
    from visrag_tpu.models.qwen25_vl import Qwen25VL as JQwen
    from visrag_tpu.models.qwen25_vl import Qwen25VLConfig as JConfig
    from visrag_tpu.training import sft as jsft
    model = JQwen(JConfig.tiny())

    def apply(p, ids, **kw):
        return model.apply(p, ids, **{k: v for k, v in kw.items()
                                      if v is not None})
    return apply, jsft


def _rel(got, want):
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want))
    den = sum(float((b ** 2).sum()) for b in want)
    assert den > 0
    return (num / den) ** 0.5


def _as_port_tensors(shared, tree):
    """A JAX params-shaped tree (weights or gradients) → the port's
    state_dict names, through the checkpoint loader."""
    m = _port_model(shared)
    qwen_from_jax_params(m, jax.tree.map(np.asarray, tree))
    return m.state_dict()


def test_sft_loss_and_gradients_match_jax(shared):
    apply, jsft = _jax_sft(SFTConfig())
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree.map(jnp.asarray, shared)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jsft.sft_loss(apply, p, jb), has_aux=True)(params)
    model = _port_model(shared)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, m = sft_loss(model, tb)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5,
                                                 abs=1e-5)
    assert float(m["token_accuracy"]) == pytest.approx(
        float(jm["token_accuracy"]), abs=1e-5)
    want = _as_port_tensors(shared, jgrads)
    named = dict(model.named_parameters())
    # a text batch does not reach the tower: no gradient in the port,
    # zeros in JAX
    unused = [n for n, p in named.items() if p.grad is None]
    assert unused and all(n.startswith("visual.") for n in unused)
    assert all(not want[n].any() for n in unused)
    used = [n for n in named if n not in unused]
    err = _rel([named[n].grad for n in used], [want[n] for n in used])
    assert err <= 1e-4, err


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_two_steps_match_jax_make_sft_step(shared, state_dtype):
    """Two steps of make_sft_step on one batch, from shared weights:
    per-step loss, accuracy and grad_norm, and the parameter update (the
    first step's learning rate is 0: a linear warmup from 0)."""
    cfg = SFTConfig(lr=1e-3, weight_decay=0.1, warmup_steps=0,
                    optimizer_state_dtype=state_dtype)
    apply, jsft = _jax_sft(cfg)
    batch = _batch(1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree.map(jnp.asarray, shared)
    tx, jstep = jsft.make_sft_step(apply, cfg)
    opt_state = tx.init(params)
    model = _port_model(shared)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, step = make_sft_step(model, cfg)
    for _ in range(2):
        params, opt_state, jm = jstep(params, opt_state, jb)
        pm = step(batch)
        for k in ("loss", "token_accuracy"):
            assert float(pm[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                                 abs=1e-5), k
        assert float(pm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
    after = _as_port_tensors(shared, params)
    moved = model.state_dict()
    names = [k for k in moved if not k.startswith("visual.")]
    err = _rel([moved[k] - before[k] for k in names],
               [after[k] - before[k] for k in names])
    assert err <= 1e-2, err


def test_freeze_survives_weight_decay(shared):
    """Decoupled weight decay must not move the frozen tower: it is out of
    the optimizer, so its weights stay bit-identical while the text
    weights move (the counterpart of the JAX test of the same name)."""
    model = _port_model(shared)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, step = make_sft_step(model, SFTConfig(
        lr=1e-2, weight_decay=0.5, total_steps=2, freeze_vision_tower=True))
    for _ in range(2):
        step(_batch(2))
    after = model.state_dict()
    vis = [k for k in after if k.startswith("visual.")]
    assert vis and all(torch.equal(after[k], before[k]) for k in vis)
    assert all(not p.requires_grad for p in model.visual.parameters())
    in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
    assert not in_opt & {id(p) for p in model.visual.parameters()}
    assert any(not torch.equal(after[k], before[k]) for k in after
               if k.startswith("model."))


def test_one_rank_mesh_equals_one_process_bit_for_bit(shared):
    """make_sft_step over a one-rank gloo mesh (FSDP2) and without one:
    the same loss, accuracy and grad norm to the bit in each of 2 steps,
    the clip active, and the same weights after. (At one rank the
    sharded step computes the one-process loss: the log-probs of the
    first S - 1 positions, whose head gradient is the tied embedding's;
    and both global norms sum the tensors' squared norms in one order.)"""
    from visrag_tpu_torch import mesh as vmesh
    from visrag_tpu_torch.config import MeshConfig
    from visrag_tpu_torch.training.checkpoint import full_tensors
    cfg = SFTConfig(lr=1e-3, weight_decay=0.1, warmup_steps=0, grad_clip=0.5)
    batch = _batch(1)
    runs = []
    for one_rank in (False, True):
        with vmesh.distributed(f"localhost:{vmesh.free_port()}", 0, 1,
                               "cpu"):
            mesh = vmesh.build_mesh(MeshConfig()) if one_rank else None
            model = _port_model(shared)
            _, step = make_sft_step(model, cfg, mesh)
            hist = [{k: float(v) for k, v in step(batch).items()}
                    for _ in range(2)]
            runs.append((hist, full_tensors(model.state_dict())))
    (hist, state), (hist1, state1) = runs
    assert hist1 == hist and hist[0]["grad_norm"] > cfg.grad_clip
    assert all(torch.equal(state1[k], v) for k, v in state.items())


def test_token_accuracy_by_chunks_equals_full():
    rng = np.random.default_rng(3)
    hid = torch.from_numpy(rng.normal(size=(2, 300, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(20, 8)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 20, (2, 300)))
    mask = torch.from_numpy((rng.random((2, 300)) < 0.7).astype(np.float32))
    full = (((hid @ w.T).argmax(-1) == labels).float() * mask).sum()
    assert float(token_accuracy(lambda h: h @ w.T, hid, labels, mask,
                                chunk=128)) == float(full)


def test_sequence_parallelism_is_refused(shared):
    """ulysses_size > 1 needs a mesh whose seq axis has that size (the JAX
    step's check); without one it is refused (the run over ranks is in
    tests/test_torch_dist_training.py)."""
    with pytest.raises(ValueError, match="seq=2"):
        make_sft_step(_port_model(shared), SFTConfig(ulysses_size=2))


# ---- driver ----------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    from test_cli_smokes import tiny_ckpt as make
    return make.__wrapped__(tmp_path_factory)


def _sft_args(tiny_ckpt, tmp_path):
    data = tmp_path / "sft.jsonl"
    with open(data, "w") as f:
        for i in range(5):
            f.write(json.dumps({"prompt": f"question number tok{i}",
                                "response": f"answer tok{i} tok{i + 1}"})
                    + "\n")
    return ["--data", str(data), "--checkpoint", tiny_ckpt,
            "--output-dir", str(tmp_path / "out"), "--batch-size", "2",
            "--max-len", "128", "--device", "cpu", "--set", "lr=1e-3",
            "--set", "warmup_steps=1",
            "--set", "optimizer_state_dtype=bfloat16"]


def test_sft_main_cli(tiny_ckpt, tmp_path, monkeypatch):
    """sft_main.main on the tiny HF checkpoint (weights, config.json and
    tokenizer) on the CPU: two steps of right-padded batches (the short
    last batch dropped), then the saved weights: the text moved, the tower
    did not."""
    from visrag_tpu_torch.driver import common, sft_main
    from visrag_tpu_torch.training.checkpoint import (find_latest_ckpt,
                                                      load_checkpoint)
    seen = []
    orig = sft_main.make_sft_batch

    def spy(pairs):
        out = orig(pairs)
        seen.append(out)
        return out
    monkeypatch.setattr(sft_main, "make_sft_batch", spy)
    assert sft_main.main(_sft_args(tiny_ckpt, tmp_path)) == 0
    assert len(seen) == 2
    for b in seen:
        assert b["input_ids"].shape[1] % 128 == 0
        assert (b["positions"] == np.arange(b["input_ids"].shape[1])).all()
        assert (b["response_mask"] <= b["attention_mask"]).all()
        assert b["response_mask"].sum() > 0
    ck = find_latest_ckpt(str(tmp_path / "out"))
    assert ck is not None and ck.endswith("global_step_2")
    tree, _ = load_checkpoint(ck)
    init = common.build_qwen25_vl(
        common.qwen_config_from_checkpoint(tiny_ckpt), device="cpu",
        state=common.load_safetensors_dir(tiny_ckpt)).state_dict()
    saved = tree["model"]
    assert all(torch.equal(saved[k], init[k]) for k in init
               if k.startswith("visual."))
    assert any(not torch.equal(saved[k], init[k]) for k in init
               if k.startswith("model."))


def test_sft_main_refuses_more_than_one_process(tiny_ckpt, tmp_path,
                                                monkeypatch):
    """One process without a process group refuses what needs more: a
    WORLD_SIZE without torchrun's rendezvous (no coordinator), and
    ulysses_size > 1 (a seq axis of 2 ranks)."""
    from visrag_tpu_torch.driver import sft_main
    monkeypatch.setitem(os.environ, "WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="no coordinator"):
        sft_main.main(_sft_args(tiny_ckpt, tmp_path))
    monkeypatch.setitem(os.environ, "WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="seq=2"):
        sft_main.main(_sft_args(tiny_ckpt, tmp_path)
                      + ["--set", "ulysses_size=2"])


def test_sft_config_fields_match_jax():
    from visrag_tpu.training.sft import SFTConfig as JSFTConfig
    assert dc.asdict(SFTConfig()) == dc.asdict(JSFTConfig())

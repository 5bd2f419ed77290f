"""The segment-id attention (K4) of visrag_tpu_torch against the JAX package.

The port's plain PyTorch version (what a CPU tensor runs) against the
Pallas segment kernel in interpret mode, values and gradients (through
`_flash_core`'s custom VJP), with inputs from numpy at fixed seeds, fp32:
causal and not, grouped kv heads, Sq != Sk, first-fit (non-ascending) ids,
pad ids. The port's contract differs from the JAX oracle on ids <= 0 only:
they match nothing and their rows and gradients are exact zeros, so the
comparisons are over the valid rows and the zeros are asserted. Also K3's
backward against `jax.grad` of the banded kernel. The tests marked `gpu`
hold the CUDA kernels against the plain versions on a card and skip
without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visrag_tpu.ops.attention import flash_attention as jflash
from visrag_tpu.ops.attention_kvgrid import flash_attention_kvgrid as jkv
from visrag_tpu.rl.packing import pack_sequences
from visrag_tpu_torch.ops import attention as seg
from visrag_tpu_torch.ops import attention_kvgrid as kg

# fp32 on the CPU on both sides; the Pallas kernel sums a row's keys in
# 128-key blocks with an online softmax, the plain version in one pass
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=2e-5)


def _first_fit_ids(lens, width):
    """Segment ids as rl/packing.pack_sequences lays them out (first-fit
    decreasing: runs within a row are contiguous, ids not ascending, 0 pads
    the tail)."""
    packed, _ = pack_sequences([np.ones(n, np.int32) for n in lens], width)
    return packed.segment_ids.astype(np.int32)


def _case(name):
    """→ (q_seg, kv_seg, heads, kv_heads, d)."""
    if name == "first_fit":
        ids = _first_fit_ids([70, 100, 37, 20, 90, 5], 128)
        assert (np.diff(ids[ids > 0]) < 0).any()      # not ascending
        return ids, ids, 4, 4, 32
    if name == "gqa":
        ids = _first_fit_ids([100, 60, 50, 30], 128)
        return ids, ids, 8, 2, 16
    if name == "sq_ne_sk":
        qid = np.concatenate([np.full(70, 1), np.full(58, 2)])[None]
        kid = np.concatenate([np.full(100, 2), np.full(120, 1),
                              np.full(36, 3)])[None]
        return qid.astype(np.int32), kid.astype(np.int32), 4, 2, 32
    if name == "pad_ids":
        ids = np.zeros((2, 128), np.int32)
        ids[0, :1] = 7
        ids[0, 1:64] = 3
        ids[0, 64:100] = 9
        ids[1, 10:75] = 2          # row 1: pads on both sides of one run
        return ids, ids, 2, 1, 32
    if name == "edges_128":
        # segments of 127, 128 and 129 tokens across 128-row tiles, and a
        # row where one segment fills whole tiles (the unmasked pairs)
        ids = np.zeros((2, 520), np.int32)
        ids[0, :127], ids[0, 127:255], ids[0, 255:384] = 4, 6, 8
        ids[1, :512] = 3
        return ids, ids, 4, 2, 64
    raise ValueError(name)


def _inputs(name):
    rng = np.random.default_rng(len(name))
    qs, ks, h, hk, d = _case(name)
    b, sq = qs.shape
    sk = ks.shape[1]
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    w = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, w, qs, ks


CASES = ["first_fit", "gqa", "sq_ne_sk", "pad_ids"]


def _sees_a_key(qs, ks, causal):
    """(B, Sq) bool: the rows inside the contract. A pad row, and (causal,
    Sq != Sk) a row whose segment's keys all lie after it, see nothing:
    the port writes exact zeros there, the Pallas kernel an average."""
    return seg._visible(torch.from_numpy(qs), torch.from_numpy(ks),
                        causal).any(-1).numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_plain_k4_matches_pallas_interpret(name, causal):
    q, k, v, _, qs, ks = _inputs(name)
    want = np.asarray(jflash(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(qs),
        jnp.asarray(ks), causal=causal, interpret=True, block_q=128,
        block_k=128))
    got = seg.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              torch.from_numpy(qs), torch.from_numpy(ks),
                              causal=causal).numpy()
    valid = _sees_a_key(qs, ks, causal)
    np.testing.assert_allclose(got[valid], want[valid], **TOL)
    assert (got[~valid] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_plain_k4_grads_match_pallas_vjp(name, causal):
    """Autograd through the plain version, and the written-out plain
    backward, against jax.grad through the Pallas kernels' custom VJP. The
    cotangent is zero on rows that see no key on the JAX side (every
    caller masks them); the port ignores whatever it holds there."""
    q, k, v, w, qs, ks = _inputs(name)
    valid = _sees_a_key(qs, ks, causal)
    w_valid = w * valid[:, :, None, None]

    def loss(q_, k_, v_):
        o = jflash(q_, k_, v_, jnp.asarray(qs), jnp.asarray(ks),
                   causal=causal, interpret=True, block_q=128, block_k=128)
        return jnp.sum(o * jnp.asarray(w_valid))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    tqs, tks = torch.from_numpy(qs), torch.from_numpy(ks)
    o = seg.flash_attention(tq, tk, tv, tqs, tks, causal=causal)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(w))
    written = seg.segment_backward_reference(
        tq.detach(), tk.detach(), tv.detach(), torch.from_numpy(w), tqs, tks,
        causal, q.shape[-1] ** -0.5)
    kvalid = ks > 0
    for g, wr, wj, ok in zip(got, written, want,
                             (valid, kvalid, kvalid)):
        g, wr, wj = g.numpy(), wr.numpy(), np.asarray(wj)
        np.testing.assert_allclose(g[ok], wj[ok], **GRAD_TOL)
        np.testing.assert_allclose(wr, g, **GRAD_TOL)
        assert (g[~ok] == 0).all()


def test_pad_row_contract():
    """ids <= 0 (0 and negative) match nothing: output rows exactly 0, LSE
    LSE_PAD, and zero dq / dk / dv whatever `do` holds there."""
    rng = np.random.default_rng(3)
    qs = np.array([[1, 1, 0, 0, -2, -2, 2, 2, 2, 0]], np.int32)
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal((1, 10, 2, 8)).astype(np.float32))
        for _ in range(4))
    q.requires_grad_(True), k.requires_grad_(True), v.requires_grad_(True)
    ids = torch.from_numpy(qs)
    o = seg.flash_attention(q, k, v, ids, ids, causal=True)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    pad = ids[0] <= 0
    assert (o[0, pad] == 0).all() and (o[0, ~pad] != 0).any()
    for g in (dq, dk, dv):
        assert (g[0, pad] == 0).all() and (g[0, ~pad] != 0).any()
    lse = seg.segment_lse_reference(q, k, ids, ids, True, 8 ** -0.5)
    assert (lse[0, :, pad] == seg.LSE_PAD).all()
    assert torch.isfinite(lse[0, :, ~pad]).all() \
        and (lse[0, :, ~pad] < 1e3).all()


def test_flash_attention_dispatch():
    """`lengths` goes to the valid-length path, ids to the segment path; on
    valid rows the two agree when the ids are the length mask."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(
        rng.standard_normal((2, 24, 4, 8)).astype(np.float32))
        for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    lengths = torch.tensor([24, 9])
    ids = (torch.arange(24)[None] < lengths[:, None]).int()
    a = seg.flash_attention(q, k, v, lengths=lengths, causal=True)
    b = seg.flash_attention(q, k, v, ids, ids, causal=True)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        seg.flash_attention(q, k, v, ids, ids, lengths=lengths)
    with pytest.raises(ValueError):
        seg.flash_attention(q[:, :, :3], k, v, ids, ids)   # 2 !| 3 heads
    with pytest.raises(ValueError):
        seg.flash_attention(q, k, v, ids[:, :5], ids)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_without_ids_at_d72_runs_k1(causal, monkeypatch):
    """No ids, Sq == Sk and d = 72 (SigLIP's bi-tower, a head dim K4 does
    not compile): flash_attention runs the valid-length path (K1, and K2
    for the gradient) at full length, and equals the JAX flash_attention on
    shared inputs, values (TOL) and gradients (GRAD_TOL)."""
    from visrag_tpu_torch.ops import attention_lengths as al
    rng = np.random.default_rng(17)
    b, s, h, hk, d = 2, 20, 4, 2, 72
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hk, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, s, h, d)).astype(np.float32)
    seen, real = [], al.flash_fwd_lengths

    def spy(*args):
        seen.append(args[3].tolist())
        return real(*args)
    monkeypatch.setattr(al, "flash_fwd_lengths", spy)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = seg.flash_attention(tq, tk, tv, causal=causal)
    assert seen == [[s] * b]
    (out * torch.from_numpy(do)).sum().backward()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = jflash(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    grads = jax.grad(lambda a, b_, c: (jflash(a, b_, c, causal=causal)
                                       * do).sum(), argnums=(0, 1, 2))(
        jq, jk, jv)
    for got, g in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(g), **GRAD_TOL)


def test_k3_backward_matches_jax_vjp():
    """The port's K3 (plain version, autograd) against jax.grad of the
    banded Pallas kernel in interpret mode, whose VJP replays the segment
    kernels' backward."""
    rng = np.random.default_rng(9)
    sizes = [30, 64, 17, 50, 64, 21]
    ids = np.concatenate([np.repeat(np.arange(1, 7), sizes),
                          np.zeros(10)]).astype(np.int32)[None]
    s = ids.shape[1]
    q, k, v, w = (rng.standard_normal((1, s, 2, 16)).astype(np.float32)
                  for _ in range(4))
    valid = ids > 0
    w_valid = w * valid[:, :, None, None]

    def loss(q_, k_, v_):
        o = jkv(q_, k_, v_, jnp.asarray(ids), max_seg_len=64, block_q=128,
                block_k=128, interpret=True)
        return jnp.sum(o * jnp.asarray(w_valid))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    o = kg.flash_attention_kvgrid(tq, tk, tv, torch.from_numpy(ids))
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(w))
    for g, wj in zip(got, want):
        g = g.numpy()
        np.testing.assert_allclose(g[valid], np.asarray(wj)[valid],
                                   **GRAD_TOL)
        assert (g[~valid] == 0).all()


def test_vision_tower_packed_equals_banded():
    """attn_impl="packed" (K4's path) gives the banded tower's output."""
    import dataclasses

    from PIL import Image

    from visrag_tpu_torch.models.qwen25_vl import (QwenVisionConfig,
                                                   QwenVisionTower)
    from visrag_tpu_torch.preprocess.qwen_vision import prepare_vision_batch
    rng = np.random.default_rng(2)
    cfg = QwenVisionConfig.tiny()
    imgs = [Image.fromarray(rng.integers(0, 255, (84, 112, 3), np.uint8))]
    vb = prepare_vision_batch(imgs, head_dim=cfg.head_dim,
                              min_pixels=28 * 28, max_pixels=84 * 112)
    torch.manual_seed(0)
    banded = QwenVisionTower(cfg).eval()
    packed = QwenVisionTower(dataclasses.replace(cfg, attn_impl="packed"))
    packed.load_state_dict(banded.state_dict())
    args = [torch.from_numpy(np.asarray(getattr(vb, name))) for name in (
        "patches", "rot_cos", "rot_sin", "seg_window", "seg_full",
        "reverse_index")]
    with torch.no_grad():
        torch.testing.assert_close(packed(*args), banded(*args), atol=1e-5,
                                   rtol=1e-5)


# ---- on a card: the CUDA kernels against the plain versions ---------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", CASES + ["edges_128"])
def test_cuda_k4_matches_plain(name, causal):
    """bf16 on the card: forward, LSE and the three gradients within 2e-2
    of the fp32 plain version (P and dS are rounded to bf16 before their
    products), with exact zeros on pad rows."""
    dev = _cuda()
    q, k, v, w, qs, ks = _inputs(name)
    if q.shape[-1] not in seg.SEG_HEAD_DIMS:
        q, k, v, w = (np.tile(x, (1, 1, 1, 128 // x.shape[-1]))
                      for x in (q, k, v, w))
    tq, tk, tv, tw = (torch.from_numpy(x).to(dev, torch.bfloat16)
                      for x in (q, k, v, w))
    tqs, tks = torch.from_numpy(qs).to(dev), torch.from_numpy(ks).to(dev)
    tq.requires_grad_(True), tk.requires_grad_(True), tv.requires_grad_(True)
    o = seg.flash_attention(tq, tk, tv, tqs, tks, causal=causal)
    got = torch.autograd.grad(o, (tq, tk, tv), tw)
    scale = tq.shape[-1] ** -0.5
    with torch.no_grad():
        want_o = seg.segment_attention_reference(
            tq.float(), tk.float(), tv.float(), tqs, tks, causal=causal)
        want = seg.segment_backward_reference(tq, tk, tv, tw, tqs, tks,
                                              causal, scale)
    torch.testing.assert_close(o.float(), want_o, atol=2e-2, rtol=2e-2)
    for g, wg in zip(got, want):
        lim = 2e-2 * max(1.0, float(wg.abs().max()))
        assert float((g.float() - wg).abs().max()) <= lim
    assert (o[tqs <= 0] == 0).all() and (got[0][tqs <= 0] == 0).all()
    assert (got[1][tks <= 0] == 0).all() and (got[2][tks <= 0] == 0).all()

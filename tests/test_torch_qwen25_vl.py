"""visrag_tpu_torch Qwen2.5-VL against the JAX package's, on shared weights.

A tiny HF Qwen2.5-VL (tests/test_qwen25_vl.py's `_hf_tiny`, fp32) is
converted to the JAX parameter tree with the JAX loader and carried into
the port by `qwen_from_jax_params`; inputs come from numpy with fixed
seeds. Every module is compared in fp32 on the CPU, where the JAX package
runs its XLA reference paths and the port its plain PyTorch versions:
1e-4 abs/rel (fp32 through a few layers of different summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from visrag_tpu.models import mrope as jmrope
from visrag_tpu.models.hf_loader import convert_qwen25_vl
from visrag_tpu.models.qwen25_vl import Qwen25VL as JQwen
from visrag_tpu.models.qwen25_vl import Qwen25VLConfig as JConfig
from visrag_tpu.preprocess import qwen_vision as jqv
from visrag_tpu.serving.sampling import SamplingParams as JSampling
from visrag_tpu.serving.sampling import sample as jsample
from visrag_tpu.serving.sampling import sample_vec as jsample_vec
from visrag_tpu_torch.models import mrope
from visrag_tpu_torch.models.hf_loader import (load_qwen25_vl_state,
                                               qwen_from_jax_params)
from visrag_tpu_torch.models.qwen25_vl import Qwen25VL, Qwen25VLConfig
from visrag_tpu_torch.preprocess import qwen_vision as qv
from visrag_tpu_torch.serving.sampling import (SamplingParams, sample,
                                               sample_vec)

TOL = dict(rtol=1e-4, atol=1e-4)
VB_KEYS = ("patches", "rot_cos", "rot_sin", "seg_window", "seg_full",
           "reverse_index")


@pytest.fixture(scope="module")
def pair():
    """(HF tiny model, JAX model, JAX params, port model), shared weights."""
    from test_qwen25_vl import _hf_tiny
    ref, _ = _hf_tiny()
    params = {"params": convert_qwen25_vl(dict(ref.state_dict()))}
    port = Qwen25VL(Qwen25VLConfig.tiny()).eval()
    qwen_from_jax_params(port, jax.tree.map(np.asarray, params))
    return ref, JQwen(JConfig.tiny()), params, port


def _images(seed, sizes=((60, 80), (56, 56))):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
            for h, w in sizes]


def _vision_prompt(cfg, seed=2, sizes=((56, 84),), device_mode=True,
                   pre=(10, 11), post=(12, 13, 14)):
    """ids / positions / slot map / vision arrays of one image prompt."""
    imgs = _images(seed, sizes)
    vb = jqv.prepare_vision_batch(imgs, head_dim=cfg.vision.head_dim,
                                  min_pixels=56 * 56,
                                  max_pixels=28 * 28 * 16,
                                  device_mode=device_mode)
    ids = np.array(list(pre) + [cfg.vision_start_token_id]
                   + [cfg.image_token_id] * vb.n_tokens + list(post),
                   np.int32)
    pos = jmrope.get_rope_index(ids, vb.grid_thw, cfg.image_token_id)
    slot = np.full(ids.shape, -1, np.int32)
    slot[ids == cfg.image_token_id] = np.arange(vb.n_tokens)
    return ids, pos, slot, {k: getattr(vb, k) for k in VB_KEYS}


def _t(vision):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in vision.items()}


def test_preprocess_and_rope_index_match_jax():
    imgs = _images(0, ((60, 80), (140, 196)))
    for dm in (False, True):
        a = jqv.prepare_vision_batch(imgs, head_dim=16, min_pixels=56 * 56,
                                     max_pixels=28 * 28 * 16, pad_to=256,
                                     device_mode=dm)
        b = qv.prepare_vision_batch(imgs, head_dim=16, min_pixels=56 * 56,
                                    max_pixels=28 * 28 * 16, pad_to=256,
                                    device_mode=dm)
        for k in VB_KEYS:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert a.grid_thw == b.grid_thw and a.n_tokens == b.n_tokens
    grids = [(1, 6, 8), (1, 4, 4)]
    ids = np.array([5, 6] + [120] * 12 + [7] + [120] * 4 + [8])
    np.testing.assert_array_equal(mrope.get_rope_index(ids, grids, 120),
                                  jmrope.get_rope_index(ids, grids, 120))


def test_vision_tower_matches_jax(pair):
    _, jm, params, port = pair
    vcfg = port.cfg.vision
    vb = jqv.prepare_vision_batch(_images(1), head_dim=vcfg.head_dim,
                                  min_pixels=56 * 56, max_pixels=28 * 28 * 16,
                                  pad_to=320, device_mode=True)
    vision = {k: getattr(vb, k) for k in VB_KEYS}
    want = jm.apply(params, {k: jnp.asarray(v) for k, v in vision.items()},
                    method=jm.encode_images)
    with torch.inference_mode():
        got = port.encode_images(_t(vision))
    real = vb.n_tokens
    np.testing.assert_allclose(got.numpy()[:real], np.asarray(want)[:real],
                               **TOL)


def test_text_model_matches_jax(pair):
    _, jm, params, port = pair
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 100, size=(2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.int32)
    mask[1, 7:] = 0
    want, _ = jm.apply(params, jnp.asarray(ids),
                       attention_mask=jnp.asarray(mask))
    with torch.inference_mode():
        got, _ = port(torch.from_numpy(ids),
                      attention_mask=torch.from_numpy(mask))
    m = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[m], **TOL)


def test_prefill_with_image_matches_jax(pair):
    _, jm, params, port = pair
    cfg = port.cfg
    ids, pos, slot, vision = _vision_prompt(cfg)
    s = len(ids)
    bucket = s + 5
    pad = lambda a, v: np.concatenate(
        [a, np.full(a.shape[:-1] + (bucket - s,), v, a.dtype)], -1)
    idp, posp, slotp = pad(ids, 0)[None], pad(pos, 0)[:, None], \
        pad(slot, -1)[None]
    mask = (np.arange(bucket) < s).astype(np.int32)[None]
    last = np.array([s - 1], np.int32)
    want = jm.apply(params, jnp.asarray(idp), attention_mask=jnp.asarray(mask),
                    positions=jnp.asarray(posp),
                    vision_batch={k: jnp.asarray(v) for k, v in
                                  vision.items()},
                    slot_map=jnp.asarray(slotp), last_pos=jnp.asarray(last),
                    method=jm.prefill)
    with torch.inference_mode():
        got = port.prefill(torch.from_numpy(idp),
                           attention_mask=torch.from_numpy(mask),
                           positions=torch.from_numpy(posp),
                           vision_batch=_t(vision),
                           slot_map=torch.from_numpy(slotp),
                           last_pos=torch.from_numpy(last))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy()[:, :, :s],
                                   np.asarray(w)[:, :, :s], **TOL)


def _jax_paged(k, v, bs, n_blocks, table_row, s, layers, kvh, d):
    """Prompt K/V (layers, 1, S, kvh, d) scattered into a pool with the
    given table row: (layers, n_blocks, kvh, bs, d) numpy."""
    pool_k = np.zeros((layers, n_blocks, kvh, bs, d), np.float32)
    pool_v = np.zeros_like(pool_k)
    for j in range(-(-s // bs)):
        rows = slice(j * bs, min((j + 1) * bs, s))
        n = rows.stop - rows.start
        pool_k[:, table_row[j], :, :n] = np.asarray(k)[:, 0, rows] \
            .transpose(0, 2, 1, 3)
        pool_v[:, table_row[j], :, :n] = np.asarray(v)[:, 0, rows] \
            .transpose(0, 2, 1, 3)
    return pool_k, pool_v


@pytest.mark.parametrize("paged", [False, True])
def test_decode_matches_jax(pair, paged):
    """Three decode steps after a prefill, dense cache or paged pool with a
    shuffled table (null-block entries past the length), against the JAX
    model's decode on the same caches."""
    _, jm, params, port = pair
    tc = port.cfg.text
    layers, kvh, d = tc.num_hidden_layers, tc.num_key_value_heads, tc.head_dim
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 100, size=(1, 13)).astype(np.int32)
    s = 10
    _, k, v = jm.apply(params, jnp.asarray(ids[:, :s]), method=jm.prefill)
    bs, n_blocks, mb = 4, 12, 5
    table = np.full((1, mb), 11, np.int32)
    table[0, :4] = [7, 2, 9, 4]
    if paged:
        kc, vc = _jax_paged(k, v, bs, n_blocks, table[0], s, layers, kvh, d)
        jk = tuple(jnp.asarray(kc[i]) for i in range(layers))
        jv = tuple(jnp.asarray(vc[i]) for i in range(layers))
        tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        jt, tt = jnp.asarray(table), torch.from_numpy(table)
    else:
        kc = np.zeros((layers, 1, 16, kvh, d), np.float32)
        vc = np.zeros_like(kc)
        kc[:, :, :s], vc[:, :, :s] = np.asarray(k), np.asarray(v)
        jk = tuple(jnp.asarray(kc[i]) for i in range(layers))
        jv = tuple(jnp.asarray(vc[i]) for i in range(layers))
        tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        jt = tt = None
    for t in range(s, s + 3):
        pos = np.full((3, 1, 1), t, np.int32)
        lens = np.array([t + 1], np.int32)
        want, jk, jv = jm.apply(params, jnp.asarray(ids[:, t:t + 1]),
                                jnp.asarray(pos), jk, jv, jnp.asarray(lens),
                                jt, method=jm.decode)
        with torch.inference_mode():
            got = port.decode(torch.from_numpy(ids[:, t:t + 1]),
                              torch.from_numpy(pos), tk, tv,
                              torch.from_numpy(lens), tt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.stack(
        [np.asarray(x) for x in jk]), **TOL)


def test_prefill_chunk_matches_jax(pair):
    """Two 8-token chunks of an image prompt through the pool (the second
    chunk's logits at the prompt end), embeddings from embed_prompt."""
    _, jm, params, port = pair
    cfg = port.cfg
    tc = cfg.text
    layers, kvh, d = tc.num_hidden_layers, tc.num_key_value_heads, tc.head_dim
    ids, pos, slot, vision = _vision_prompt(cfg, sizes=((28, 56),))
    s, C, bs, n_blocks = len(ids), 8, 4, 9
    grid = -(-s // C) * C
    assert 1 < grid // C
    idp = np.zeros((1, grid), np.int32)
    idp[0, :s] = ids
    slp = np.full((1, grid), -1, np.int32)
    slp[0, :s] = slot
    jv_b = {k: jnp.asarray(v) for k, v in vision.items()}
    jemb = jm.apply(params, jnp.asarray(idp), vision_batch=jv_b,
                    slot_map=jnp.asarray(slp), method=jm.embed_prompt)
    with torch.inference_mode():
        temb = port.embed_prompt(torch.from_numpy(idp), _t(vision),
                                 torch.from_numpy(slp))
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), **TOL)
    blocks = np.array([3, 8, 1, 5, 6, 2, 7, 0][:grid // bs], np.int32)
    jk = tuple(jnp.zeros((n_blocks, kvh, bs, d), jnp.bfloat16)
               for _ in range(layers))
    jvc = tuple(jnp.zeros((n_blocks, kvh, bs, d), jnp.bfloat16)
                for _ in range(layers))
    tk = torch.zeros((layers, n_blocks, kvh, bs, d), dtype=torch.bfloat16)
    tv = torch.zeros_like(tk)
    for lo in range(0, grid, C):
        hi = min(lo + C, s)
        cpos = np.zeros((3, 1, C), np.int32)
        cpos[:, 0, :hi - lo] = pos[:, lo:hi]
        cpos[:, 0, hi - lo:] = cpos[:, 0, hi - lo - 1:hi - lo] + np.arange(
            1, C - (hi - lo) + 1)
        final = hi >= s
        last = np.array([s - 1 - lo], np.int32) if final else None
        rows, gather = blocks[lo // bs:(lo + C) // bs], blocks[:(lo + C) // bs]
        want, jk, jvc = jm.apply(
            params, jnp.asarray(idp[:, lo:lo + C]), jnp.asarray(cpos), jk, jvc,
            jnp.asarray(rows), jnp.asarray(gather), jnp.int32(lo),
            last_pos=None if last is None else jnp.asarray(last),
            inputs_embeds=jemb[:, lo:lo + C], method=jm.prefill_chunk)
        with torch.inference_mode():
            got = port.prefill_chunk(
                torch.from_numpy(idp[:, lo:lo + C]), torch.from_numpy(cpos),
                tk, tv, torch.from_numpy(rows).long(),
                torch.from_numpy(gather).long(), torch.tensor(lo),
                last_pos=None if last is None else torch.from_numpy(last),
                inputs_embeds=temb[:, lo:lo + C])
        assert (got is None) == (want is None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tk.float().numpy(), np.stack(
        [np.asarray(x, np.float32) for x in jk]), atol=1e-2, rtol=1e-2)


def test_hf_state_loads_both_layouts(pair):
    """The HF state dict loads by name (modern and pre-4.52 key layouts)
    into the same weights qwen_from_jax_params carries; a stray name
    raises."""
    ref, _, _, port = pair
    state = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    old = {k.replace("model.language_model.", "model.")
           .replace("model.visual.", "visual."): v for k, v in state.items()}
    want = port.state_dict()
    for layout in (state, old):
        m = Qwen25VL(Qwen25VLConfig.tiny())
        load_qwen25_vl_state(m, layout)
        for k, v in m.state_dict().items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    with pytest.raises(KeyError, match="unexpected"):
        load_qwen25_vl_state(Qwen25VL(Qwen25VLConfig.tiny()),
                             dict(state, **{"model.visual.stray": state[
                                 "model.language_model.norm.weight"]}))


@pytest.mark.parametrize("case", ["greedy", "sampled", "top_p", "mixed"])
def test_sample_vec_matches_jax(case):
    """The same logits, seen mask and uniforms (JAX's own draw handed to
    the port) give the same tokens and log-probabilities."""
    rng = np.random.default_rng(7)
    b, vocab = 4, 50
    logits = (rng.standard_normal((b, vocab)) * 3).astype(np.float32)
    seen = rng.random((b, vocab)) < 0.2
    temp = {"greedy": [0.0] * 4, "sampled": [1.0, 0.7, 1.3, 2.0],
            "top_p": [1.0] * 4, "mixed": [0.0, 1.0, 0.5, 0.0]}[case]
    top_p = [0.5, 0.9, 0.3, 1.0] if case in ("top_p", "mixed") else [1.0] * 4
    rp = [1.05, 1.0, 1.3, 2.0]
    key = jax.random.PRNGKey(3)
    args = [np.asarray(x, np.float32) for x in (temp, top_p, rp)]
    jt, jl = jsample_vec(jnp.asarray(logits), key,
                         *(jnp.asarray(a) for a in args), jnp.asarray(seen))
    u = np.asarray(jax.random.uniform(key, (b, 1), jnp.float32))[:, 0]
    tt, tl = sample_vec(torch.from_numpy(logits),
                        *(torch.from_numpy(a) for a in args),
                        torch.from_numpy(seen), uniform=torch.from_numpy(u.copy()))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)


def test_scalar_sample_matches_jax_where_deterministic():
    """`sample` with one SamplingParams: greedy with a repetition penalty,
    and a top_p so small that one token survives, agree with JAX's."""
    key = jax.random.PRNGKey(0)
    logits = np.array([[0.0, 1.0, 2.0, 10.0], [2.0, 1.9, 0.0, 2.05]],
                      np.float32)
    seen = np.array([[False] * 4, [False, False, False, True]])
    for kw in (dict(temperature=0.0, repetition_penalty=100.0),
               dict(temperature=1.0, top_p=0.1)):
        want = jsample(jnp.asarray(logits), key, JSampling(**kw),
                       jnp.asarray(seen))
        got = sample(torch.from_numpy(logits), SamplingParams(**kw),
                     torch.from_numpy(seen))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

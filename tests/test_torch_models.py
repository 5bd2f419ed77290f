"""Module parity: each ported module against its visrag_tpu counterpart.

Both sides get the same numpy inputs (fixed seeds) and the same parameters:
the JAX module is initialised, its params go through visrag_tpu's HF
exporter, and the torch module loads them by name. fp32, tiny configs.
The ViT uses patch size 14 because the exporter writes the conv patch
embed as (D, 3, 14, 14). Tolerances: finish_encode_batch 1e-6; norms and
rope 1e-5; pooling 1e-6; Resampler 1e-5; SiglipViT 2e-4 (the JAX MLP uses
fast_gelu, the port exact erf GELU); MiniCPMModel 1e-4. Padded rows are
outside the contract and are not compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from visrag_tpu.models import common as jcommon
from visrag_tpu.models.hf_export import (export_minicpm_lm, export_resampler,
                                         export_siglip_vit)
from visrag_tpu.models.minicpm import (MiniCPMConfig as JMiniCPMConfig,
                                       MiniCPMModel as JMiniCPMModel)
from visrag_tpu.models.resampler import (Resampler as JResampler,
                                         ResamplerConfig as JResamplerConfig)
from visrag_tpu.models.siglip_vit import (SiglipViT as JSiglipViT,
                                          SiglipViTConfig as JSiglipViTConfig)
from visrag_tpu.ops import pooling as jpooling
from visrag_tpu.preprocess.device import finish_encode_batch as jfinish
from visrag_tpu.preprocess.pipeline import PipelineConfig, build_encode_batch
from visrag_tpu.preprocess.tokenize import MockTokenizer
from visrag_tpu.preprocess.transform import bicubic_table
from visrag_tpu_torch.models import common as tcommon
from visrag_tpu_torch.models.minicpm import MiniCPMConfig, MiniCPMModel
from visrag_tpu_torch.models.resampler import Resampler, ResamplerConfig
from visrag_tpu_torch.models.siglip_vit import SiglipViT, SiglipViTConfig
from visrag_tpu_torch.ops import pooling as tpooling
from visrag_tpu_torch.preprocess.device import (finish_encode_batch,
                                                pos_table_tensor)


def _t(x):
    return torch.from_numpy(np.array(x))


def _load(module, state, prefix=""):
    """HF-named numpy state → module, reshaping to each target's shape."""
    target = module.state_dict()
    conv = {}
    for k, v in state.items():
        k = k[len(prefix):].replace("embed_tokens.embedding",
                                    "embed_tokens.weight")
        conv[k] = _t(v).reshape(target[k].shape)
    module.load_state_dict(conv, strict=True)
    return module


def _masks(lengths, s):
    return (np.arange(s)[None, :] < np.asarray(lengths)[:, None])


def test_finish_encode_batch_matches_jax():
    pcfg = PipelineConfig(seq_len=64, query_num=4, patch_size=14, src_grid=4,
                          scale_resolution=56, max_patches=64)
    rng = np.random.default_rng(0)
    pages = [("", Image.fromarray(rng.integers(0, 255, (h, w, 3),
                                               dtype=np.uint8)))
             for h, w in [(70, 50), (40, 90)]]
    raw = build_encode_batch(MockTokenizer(), pages, pcfg, device_mode=True)
    ref = jfinish({k: jnp.asarray(v) for k, v in raw.items()},
                  bicubic_table(pcfg.src_grid))
    out = finish_encode_batch(raw, pos_table_tensor(pcfg.src_grid, "cpu"))
    for name in ("patches", "pos_matrix", "patch_mask", "grid_h", "grid_w",
                 "input_ids", "attention_mask", "slot_map"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_norms_match_jax(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    if kind == "rms":
        ref = jcommon.RMSNorm(32, 1e-5).apply(
            {"params": {"weight": w}}, jnp.asarray(x))
        mod = tcommon.RMSNorm(32, 1e-5)
        mod.load_state_dict({"weight": _t(w)})
    else:
        ref = jcommon.LayerNorm(32, 1e-6).apply(
            {"params": {"weight": w, "bias": b}}, jnp.asarray(x))
        mod = tcommon.LayerNorm(32, 1e-6)
        mod.load_state_dict({"weight": _t(w), "bias": _t(b)})
    np.testing.assert_allclose(mod(_t(x)).detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scaling", [None, "linear", "dynamic"])
def test_rope_matches_jax(scaling):
    rng = np.random.default_rng(2)
    b, s, h, d = 3, 24, 2, 16
    q, k = (rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)) * 7
    sc = {"type": scaling, "factor": 2.0} if scaling else None
    if scaling == "dynamic":
        # per-row live lengths, two of them past max_positions
        lens = np.array([24, 100, 300], np.int32)
        jf = jcommon.dynamic_ntk_inv_freq(d, 10000.0, 2.0, 64,
                                          jnp.asarray(lens))
        tf = tcommon.dynamic_ntk_inv_freq(d, 10000.0, 2.0, 64, _t(lens))
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5)
    else:
        jf = jnp.asarray(jcommon.rope_frequencies(d, scaling=sc))
        tf = _t(tcommon.rope_frequencies(d, scaling=sc))
    jq, jk = jcommon.apply_rope(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(pos), jf, scaling=sc)
    tq, tk = tcommon.apply_rope(_t(q), _t(k), _t(pos), tf, scaling=sc)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5,
                               atol=1e-5)


def test_sincos_tables_match_jax():
    np.testing.assert_array_equal(tcommon.get_2d_sincos_pos_embed(16, 3, 5),
                                  jcommon.get_2d_sincos_pos_embed(16, 3, 5))
    gh, gw = np.array([3, 2], np.int32), np.array([5, 7], np.int32)
    ref = jax.vmap(lambda h, w: jcommon.sincos_2d_device(16, h, w, 20))(
        jnp.asarray(gh), jnp.asarray(gw))
    out = tcommon.sincos_2d_device(16, _t(gh), _t(gw), 20)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["wmean", "mean", "lasttoken",
                                  "simple_lasttoken", "cls"])
def test_pooling_matches_jax(mode):
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((3, 9, 16)).astype(np.float32)
    mask = _masks([9, 4, 1], 9).astype(np.int32)
    ref = jpooling.l2_normalize(jpooling.pool(jnp.asarray(hidden),
                                              jnp.asarray(mask), mode))
    out = tpooling.l2_normalize(tpooling.pool(_t(hidden), _t(mask), mode))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_resampler_matches_jax():
    rng = np.random.default_rng(4)
    n, p = 3, 16
    x = rng.standard_normal((n, p, 8)).astype(np.float32)
    gh = np.array([3, 4, 1], np.int32)
    gw = np.array([4, 3, 1], np.int32)
    mask = _masks([12, 12, 0], p).astype(np.int32)   # slice 2: all-pad dummy
    jm = JResampler(JResamplerConfig.tiny())
    args = [jnp.asarray(a) for a in (x, gh, gw, mask)]
    params = jm.init(jax.random.PRNGKey(0), *args)["params"]
    ref = np.asarray(jm.apply({"params": params}, *args))
    mod = _load(Resampler(ResamplerConfig.tiny()),
                export_resampler(params, prefix=""))
    with torch.no_grad():
        out = mod(_t(x), _t(gh), _t(gw), _t(mask)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert np.isfinite(out).all()


def test_siglip_vit_matches_jax():
    rng = np.random.default_rng(5)
    n, p, g = 3, 24, 4
    jcfg = JSiglipViTConfig.tiny(patch_size=14)
    patches = rng.uniform(-1, 1, (n, p, jcfg.patch_dim)).astype(np.float32)
    lengths = [24, 13, 1]
    mask = _masks(lengths, p).astype(np.int32)
    pos = rng.uniform(0, 0.3, (n, p, g * g)).astype(np.float32)
    jm = JSiglipViT(jcfg)
    args = [jnp.asarray(a) for a in (patches, mask, pos)]
    params = jm.init(jax.random.PRNGKey(1), *args)["params"]
    ref = np.asarray(jm.apply({"params": params}, *args))
    mod = _load(SiglipViT(SiglipViTConfig.tiny(patch_size=14)),
                export_siglip_vit(params, prefix=""))
    with torch.no_grad():
        out = mod(_t(patches), _t(mask), _t(pos)).numpy()
    valid = _masks(lengths, p)
    np.testing.assert_allclose(out[valid], ref[valid], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_minicpm_model_matches_jax(causal):
    rng = np.random.default_rng(6)
    b, s = 3, 16
    ids = rng.integers(0, 256, (b, s)).astype(np.int32)
    lengths = [16, 9, 1]
    mask = _masks(lengths, s).astype(np.int32)
    jm = JMiniCPMModel(JMiniCPMConfig.tiny(is_causal=causal))
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(ids),
                     attention_mask=jnp.asarray(mask))["params"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(ids),
                              attention_mask=jnp.asarray(mask)))
    mod = _load(MiniCPMModel(MiniCPMConfig.tiny(is_causal=causal)),
                export_minicpm_lm(params))
    with torch.no_grad():
        out = mod(_t(ids), attention_mask=_t(mask)).numpy()
    valid = _masks(lengths, s)
    np.testing.assert_allclose(out[valid], ref[valid], rtol=1e-4, atol=1e-4)


def test_minicpm_grouped_kv_heads_match_jax():
    """4 query heads on 2 kv heads (the JAX config's num_key_value_heads):
    K1's grouped form on the port's side, 1e-4 on valid rows, causal."""
    rng = np.random.default_rng(16)
    b, s = 3, 16
    ids = rng.integers(0, 256, (b, s)).astype(np.int32)
    lengths = [16, 11, 2]
    mask = _masks(lengths, s).astype(np.int32)
    jm = JMiniCPMModel(JMiniCPMConfig.tiny(num_key_value_heads=2))
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(ids),
                     attention_mask=jnp.asarray(mask))["params"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(ids),
                              attention_mask=jnp.asarray(mask)))
    mod = _load(MiniCPMModel(MiniCPMConfig.tiny(num_key_value_heads=2)),
                export_minicpm_lm(params))
    assert mod.layers[0].self_attn.k_proj.weight.shape == (32, 64)
    with torch.no_grad():
        out = mod(_t(ids), attention_mask=_t(mask)).numpy()
    valid = _masks(lengths, s)
    np.testing.assert_allclose(out[valid], ref[valid], rtol=1e-4, atol=1e-4)


def _input_grads_match_jax(jm, jparams, jinputs, mod, tinputs, w, mask_valid,
                           call, tol):
    """jax.grad and torch autograd of sum(out * w) over valid rows, with
    respect to the first input; `call(model, *inputs)` runs either side."""
    def jloss(x):
        return (call(jm, {"params": jparams}, x, *jinputs[1:]) * w).sum()

    want = np.asarray(jax.grad(jloss)(jinputs[0]))
    x = tinputs[0].clone().requires_grad_(True)
    out = call(mod, None, x, *tinputs[1:])
    (got,) = torch.autograd.grad((out * _t(w)).sum(), (x,))
    np.testing.assert_allclose(got.numpy()[mask_valid], want[mask_valid],
                               **tol)
    return got


@pytest.mark.parametrize("remat", [False, True, "mlp"])
def test_siglip_vit_grads_match_jax(remat):
    """The ViT's backward (the plain lengths attention's autograd on the
    CPU) with and without recomputation against jax.grad through the JAX
    tower with the same remat setting; grads w.r.t. the patches of valid
    rows, 1e-3 abs/rel (fast_gelu's derivative differs from exact GELU's
    in the last digits)."""
    rng = np.random.default_rng(11)
    n, p, g = 3, 24, 4
    jcfg = JSiglipViTConfig.tiny(patch_size=14, remat=remat)
    patches = rng.uniform(-1, 1, (n, p, jcfg.patch_dim)).astype(np.float32)
    lengths = [24, 13, 0]
    mask = _masks(lengths, p).astype(np.int32)
    pos = rng.uniform(0, 0.3, (n, p, g * g)).astype(np.float32)
    w = (rng.standard_normal((n, p, jcfg.embed_dim)).astype(np.float32)
         * mask[:, :, None])
    jm = JSiglipViT(jcfg)
    jargs = [jnp.asarray(a) for a in (patches, mask, pos)]
    params = jm.init(jax.random.PRNGKey(1), *jargs)["params"]
    mod = _load(SiglipViT(SiglipViTConfig.tiny(patch_size=14, remat=remat)),
                export_siglip_vit(params, prefix=""))

    def call(m, variables, *args):
        return m.apply(variables, *args) if variables else m(*args)

    _input_grads_match_jax(jm, params, jargs, mod,
                           [_t(a) for a in (patches, mask, pos)], w,
                           _masks(lengths, p), call,
                           dict(rtol=1e-3, atol=1e-3))


@pytest.mark.parametrize("remat", [False, True, "mlp"])
def test_minicpm_grads_match_jax(remat):
    """The LM's backward with and without recomputation against jax.grad
    through the JAX LM (same remat setting, which on the JAX side also
    routes attention through the flash path); grads w.r.t. the input
    embeddings, 1e-4 abs/rel."""
    rng = np.random.default_rng(12)
    b, s = 3, 16
    jcfg = JMiniCPMConfig.tiny(remat=remat)
    emb = rng.standard_normal((b, s, jcfg.hidden_size)).astype(np.float32)
    lengths = [16, 9, 1]
    mask = _masks(lengths, s).astype(np.int32)
    w = (rng.standard_normal((b, s, jcfg.hidden_size)).astype(np.float32)
         * mask[:, :, None])
    jm = JMiniCPMModel(jcfg)
    ids = jnp.asarray(rng.integers(0, 256, (b, s)).astype(np.int32))
    params = jm.init(jax.random.PRNGKey(2), ids,
                     attention_mask=jnp.asarray(mask))["params"]
    mod = _load(MiniCPMModel(MiniCPMConfig.tiny(remat=remat)),
                export_minicpm_lm(params))

    def call(m, variables, x, attention_mask):
        if variables:
            return m.apply(variables, inputs_embeds=x,
                           attention_mask=attention_mask)
        return m(inputs_embeds=x, attention_mask=attention_mask)

    _input_grads_match_jax(jm, params, [jnp.asarray(emb), jnp.asarray(mask)],
                           mod, [_t(emb), _t(mask)], w, _masks(lengths, s),
                           call, dict(rtol=1e-4, atol=1e-4))

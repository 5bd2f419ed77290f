"""visrag_tpu_torch's int8 (w8a8) encode path against visrag_tpu's.

The JAX side runs its CPU path (exact s32 dot_general) or the Pallas GEMM
in interpret mode; the port's CPU path is K6's plain version
(ops/matmul_int8.int8_matmul_reference, exact int64 product). Inputs come
from numpy with fixed seeds. Tolerances:

  * the int8 codes and scales: equal bit for bit;
  * GEMM outputs: 1e-5 abs/rel (the same exact int32 product on both
    sides, fp32 epilogue products in the same order);
  * int8 models against their JAX twins on shared weights: 1e-3 abs/rel,
    looser than the bf16 parity tests' 1e-4 because an activation whose
    code sits on a rounding boundary can flip by one code between the two
    frameworks' fp32 norms (a step of amax/127 in that input);
  * int8 against the same model's fp32 path: the JAX package's bars,
    cosine > 0.995 per block and > 0.99 per tower and LM.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visrag_tpu.models.hf_export import export_minicpm_lm, export_siglip_vit
from visrag_tpu.models.minicpm import MiniCPMConfig as JMiniCPMConfig
from visrag_tpu.models.minicpm import MiniCPMModel as JMiniCPMModel
from visrag_tpu.models.siglip_vit import FlatQKV
from visrag_tpu.models.siglip_vit import SiglipViT as JSiglipViT
from visrag_tpu.models.siglip_vit import SiglipViTConfig as JSiglipViTConfig
from visrag_tpu.ops import quant as jq
from visrag_tpu.ops.matmul_int8 import int8_matmul_fused as jfused
from visrag_tpu_torch.models.common import QuantLinear
from visrag_tpu_torch.models.minicpm import MiniCPMConfig, MiniCPMModel
from visrag_tpu_torch.models.siglip_vit import (SiglipViT, SiglipViTConfig,
                                                ViTBlock)
from visrag_tpu_torch.ops import matmul_int8 as mi
from visrag_tpu_torch.ops import quant as tq

EXACT = dict(rtol=1e-5, atol=1e-5)
TWIN = dict(rtol=1e-3, atol=1e-3)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


def _load(module, state, prefix=""):
    target = module.state_dict()
    conv = {k[len(prefix):].replace("embed_tokens.embedding",
                                    "embed_tokens.weight"): v
            for k, v in state.items()}
    module.load_state_dict({k: _t(v).reshape(target[k].shape)
                            for k, v in conv.items()}, strict=True)
    return module


def test_codes_match_jax_bit_for_bit():
    """quant_rowwise and quant_weight_colwise give the JAX package's codes
    and scales exactly, zero rows and columns (scale 1e-8/127) included."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((37, 70)) * 3).astype(np.float32)
    x[5] = 0.0
    x[9, :] = 0.5            # ties: every code is a round-half-even case
    x[9, 0] = 127 * 0.5 / 63.5
    w = (rng.standard_normal((70, 23)) * 0.1).astype(np.float32)
    w[:, 4] = 0.0
    for got, want in ((tq.quant_rowwise(_t(x)), jq.quant_rowwise(x)),
                      (tq.quant_weight_colwise(_t(w)),
                       jq.quant_weight_colwise(w))):
        assert got[0].dtype == torch.int8
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    q, s = tq.quant_rowwise(_t(x))
    assert not q[5].any() and s[5, 0].item() == np.float32(1e-8) / 127


@pytest.mark.parametrize("bias", [False, True])
def test_int8_dense_matches_jax_and_pallas_interpret(bias):
    """int8_dense's plain path (the CPU path of K6) against JAX int8_dense
    and the Pallas GEMM int8_matmul_fused in interpret mode, at shapes that
    are multiples of nothing; 1e-5 abs/rel."""
    rng = np.random.default_rng(1)
    m, k, n = 13, 200, 70
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32) if bias else None
    before = mi.launches
    got = tq.int8_dense(_t(x), _t(w), None if b is None else _t(b),
                        out_dtype=torch.float32).numpy()
    assert mi.launches == before          # a CPU tensor launches nothing
    want = np.asarray(jq.int8_dense(jnp.asarray(x), jnp.asarray(w),
                                    None if b is None else jnp.asarray(b),
                                    out_dtype=jnp.float32))
    np.testing.assert_allclose(got, want, **EXACT)
    xq, xs = jq.quant_rowwise(jnp.asarray(x))
    wq, ws = jq.quant_weight_colwise(jnp.asarray(w))
    pallas = np.asarray(jfused(xq, xs, wq, ws,
                               None if b is None else jnp.asarray(b),
                               out_dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(got, pallas, **EXACT)
    # int8_matmul: the scales on the exact product, no bias
    np.testing.assert_allclose(
        tq.int8_matmul(_t(np.asarray(xq)), _t(np.asarray(xs)),
                       _t(np.asarray(wq)), _t(np.asarray(ws)),
                       torch.float32).numpy(),
        np.asarray(jq.int8_matmul(xq, xs, wq, ws, jnp.float32)), **EXACT)


def test_int8_product_is_exact_past_fp32():
    """The plain product is exact where fp32 is not: |acc| = 127² K with
    K = 2304 is 3.7e7 > 2^24."""
    k = 2304
    xq = torch.full((2, k), 127, dtype=torch.int8)
    xq[1, 0] = 126
    wq = torch.full((3, k), 127, dtype=torch.int8)
    acc = mi.int8_product(xq, wq)
    assert acc[0, 0].item() == 127 * 127 * k
    assert acc[1, 0].item() == 127 * 127 * k - 127


def test_quant_linear_caches_codes_until_the_weight_changes():
    torch.manual_seed(0)
    lin = QuantLinear(24, 10)
    x = torch.randn(5, 24)
    y1 = lin(x)
    wq1 = lin._codes()[0]
    assert lin._codes()[0] is wq1          # cached
    w = torch.randn(10, 24)
    lin.load_state_dict({"weight": w, "bias": lin.bias.detach()})
    assert lin._codes()[0] is not wq1      # rebuilt from the new weight
    want, ws = tq.quant_weight_colwise(w.t())
    np.testing.assert_array_equal(lin._codes()[0].numpy(), want.t().numpy())
    np.testing.assert_allclose(
        lin(x).detach().numpy(),
        tq.int8_dense(x, w.t(), lin.bias.detach(), torch.float32).numpy(),
        **EXACT)
    assert not torch.equal(y1, lin(x))


def test_quant_with_remat_raises():
    for cfg in (SiglipViTConfig, MiniCPMConfig):
        with pytest.raises(ValueError):
            cfg.tiny(quant="int8", remat=True)
        with pytest.raises(ValueError):
            cfg.tiny(quant="int8", remat="mlp")
    assert SiglipViTConfig.tiny(quant="int8").quant == "int8"


def test_head_padded_qkv_quantizes_like_the_unpadded_one():
    """The JAX ViT's flat qkv quantizes its weight with the head dim padded
    to 128 lanes (zero columns); the port's qkv has no pad. The real
    columns' codes, scales and outputs are the same, the pad outputs 0."""
    rng = np.random.default_rng(2)
    h, d, dp, e = 2, 16, 128, 32
    x = (rng.standard_normal((2, 5, e)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((3 * e, e)) * 0.2).astype(np.float32)
    b = rng.standard_normal((3 * e,)).astype(np.float32)
    params = {"params": {"weight": w, "bias": b}}
    padded = np.asarray(FlatQKV(h, d, dp, jnp.float32, quant=True).apply(
        params, jnp.asarray(x))).reshape(10, 3, h, dp)
    lin = QuantLinear(e, 3 * e)
    lin.load_state_dict({"weight": _t(w), "bias": _t(b)})
    with torch.no_grad():
        got = lin(_t(x).reshape(10, e)).numpy().reshape(10, 3, h, d)
    np.testing.assert_allclose(got, padded[..., :d], **EXACT)
    assert not padded[..., d:].any()
    wp = np.pad(w.reshape(3, h, d, e), ((0, 0), (0, 0), (0, dp - d),
                                        (0, 0))).reshape(3 * h * dp, e)
    qp, sp = jq.quant_weight_colwise(wp.T)
    real = np.pad(np.ones((3, h, d), bool),
                  ((0, 0), (0, 0), (0, dp - d))).reshape(-1)
    wq, ws = lin._codes()
    np.testing.assert_array_equal(np.asarray(qp).T[real], wq.numpy())
    np.testing.assert_array_equal(np.asarray(sp)[real], ws.numpy())


def _vit_case():
    rng = np.random.default_rng(3)
    n, p, g = 3, 24, 4
    jcfg = JSiglipViTConfig.tiny(patch_size=14, embed_dim=64, num_heads=4,
                                 mlp_dim=128, depth=3)
    patches = rng.uniform(-1, 1, (n, p, jcfg.patch_dim)).astype(np.float32)
    lengths = [24, 13, 1]
    mask = (np.arange(p)[None] < np.asarray(lengths)[:, None])
    pos = rng.uniform(0, 0.3, (n, p, g * g)).astype(np.float32)
    args = [jnp.asarray(a) for a in (patches, mask.astype(np.int32), pos)]
    params = JSiglipViT(jcfg).init(jax.random.PRNGKey(1), *args)["params"]
    return jcfg, params, args, mask


def test_int8_vit_matches_jax_twin_and_own_fp32():
    jcfg, params, args, mask = _vit_case()
    jm = JSiglipViT(dataclasses.replace(jcfg, quant="int8"))
    want = np.asarray(jax.jit(jm.apply)({"params": params}, *args))
    kw = dict(patch_size=14, embed_dim=64, num_heads=4, mlp_dim=128, depth=3)
    state = export_siglip_vit(params, prefix="")
    port_q = _load(SiglipViT(SiglipViTConfig.tiny(quant="int8", **kw)), state)
    port_f = _load(SiglipViT(SiglipViTConfig.tiny(**kw)), state)
    targs = [_t(np.asarray(a)) for a in args]
    with torch.no_grad():
        got = port_q(*targs).numpy()
        fp32 = port_f(*targs).numpy()
    np.testing.assert_allclose(got[mask], want[mask], **TWIN)
    assert _cos(got[mask], fp32[mask]) > 0.99
    # one block: int8 against fp32 on the same weights and input
    blk_q = ViTBlock(SiglipViTConfig.tiny(quant="int8", **kw))
    blk_f = ViTBlock(SiglipViTConfig.tiny(**kw))
    blk_q.load_state_dict(port_f.blocks[0].state_dict())
    blk_f.load_state_dict(port_f.blocks[0].state_dict())
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 24, 64)).astype(np.float32) * 0.3)
    lens = torch.tensor([24, 13, 1], dtype=torch.int32)
    with torch.no_grad():
        a, b = blk_q(x, lens).numpy(), blk_f(x, lens).numpy()
    assert _cos(a[mask], b[mask]) > 0.995


def test_int8_minicpm_matches_jax_twin_and_own_fp32():
    rng = np.random.default_rng(5)
    kw = dict(hidden_size=96, intermediate_size=192, num_attention_heads=4,
              num_key_value_heads=4, num_hidden_layers=3)
    ids = rng.integers(1, 255, size=(2, 24)).astype(np.int32)
    mask = np.ones((2, 24), np.int32)
    mask[1, 18:] = 0
    jm = JMiniCPMModel(JMiniCPMConfig.tiny(**kw))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                     attention_mask=jnp.asarray(mask))["params"]
    jq8 = JMiniCPMModel(JMiniCPMConfig.tiny(quant="int8", **kw))
    want = np.asarray(jax.jit(jq8.apply)({"params": params}, jnp.asarray(ids),
                                         attention_mask=jnp.asarray(mask)))
    state = export_minicpm_lm(params)
    port_q = _load(MiniCPMModel(MiniCPMConfig.tiny(quant="int8", **kw)),
                   state)
    port_f = _load(MiniCPMModel(MiniCPMConfig.tiny(**kw)), state)
    assert isinstance(port_q.layers[0].self_attn.o_proj, QuantLinear)
    assert not isinstance(port_q.layers[0].mlp.down_proj, QuantLinear)
    with torch.no_grad():
        got = port_q(_t(ids), attention_mask=_t(mask)).numpy()
        fp32 = port_f(_t(ids), attention_mask=_t(mask)).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], **TWIN)
    assert _cos(got[valid], fp32[valid]) > 0.99


@pytest.mark.gpu
def test_int8_gemm_kernel_matches_plain_on_card():
    """K6 against its plain version at a tail-heavy shape: the int32 product
    is exact on both sides, so the bf16 outputs differ by at most one bf16
    rounding of the same fp32 value (0 in practice)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    m, k, n = 333, 1152, 4304
    x = torch.randn(m, k, generator=g, device="cuda")
    w = torch.randn(n, k, generator=g, device="cuda") * 0.05
    xq, xs = tq.quant_rowwise(x)
    wq, ws = tq.quant_weight_colwise(w.t())
    wq = wq.t().contiguous()
    bias = torch.randn(n, generator=g, device="cuda")
    out = mi.int8_matmul_fused(xq, xs[:, 0], wq, ws, bias)
    ref = mi.int8_matmul_reference(xq, xs[:, 0], wq, ws, bias)
    ulp = (ref.float().abs() * 2 ** -7).clamp_min(1e-30)
    assert ((out.float() - ref.float()).abs() <= ulp).all()


def test_int8_visrag_ret_matches_jax_twin_with_the_same_ranks():
    """The whole retriever with quant="int8" in the ViT and the LM: the
    JAX twin and the port, both loaded from one set of JAX params (the port
    through from_jax_params, unchanged for the int8 model), embed the same
    raw batches within 1e-3 and rank the pages identically; against the
    port's own fp32 model the embeddings keep cosine > 0.99."""
    from test_torch_slice import PCFG, _raw_batches
    from visrag_tpu.models.minicpmv import MiniCPMVConfig as JMiniCPMVConfig
    from visrag_tpu.models.visrag_ret import VisRAGRet as JVisRAGRet
    from visrag_tpu.models.visrag_ret import VisRAGRetConfig as JRetConfig
    from visrag_tpu.preprocess.device import finish_encode_batch as jfinish
    from visrag_tpu.preprocess.transform import bicubic_table
    from visrag_tpu.retrieval.search import topk_single as jtopk
    from visrag_tpu_torch.models.hf_loader import from_jax_params
    from visrag_tpu_torch.models.minicpmv import MiniCPMVConfig
    from visrag_tpu_torch.models.visrag_ret import VisRAGRet, VisRAGRetConfig
    from visrag_tpu_torch.preprocess.device import (finish_encode_batch,
                                                    pos_table_tensor)
    from visrag_tpu_torch.retrieval.search import topk_single

    def jcfg(quant):
        return JRetConfig(backbone=JMiniCPMVConfig.tiny(
            vit=JSiglipViTConfig.tiny(patch_size=14, quant=quant),
            llm=JMiniCPMConfig.tiny(quant=quant)))

    def tcfg(quant):
        return VisRAGRetConfig(backbone=MiniCPMVConfig.tiny(
            vit=SiglipViTConfig.tiny(patch_size=14, quant=quant),
            llm=MiniCPMConfig.tiny(quant=quant)))

    pages_raw, queries_raw = _raw_batches()
    table = bicubic_table(PCFG.src_grid)
    jm = JVisRAGRet(jcfg("int8"))
    jin = {k: jnp.asarray(v) for k, v in pages_raw.items()}
    params = jax.device_get(jax.jit(lambda key: JVisRAGRet(jcfg("none")).init(
        key, jfinish(jin, table)))(jax.random.PRNGKey(0)))
    japply = jax.jit(lambda p, raw: jm.apply(p, jfinish(raw, table)))
    want = [np.asarray(japply(params, {k: jnp.asarray(v)
                                       for k, v in raw.items()}))
            for raw in (pages_raw, queries_raw)]
    ptable = pos_table_tensor(PCFG.src_grid, "cpu")
    got, fp32 = [], []
    for quant, out in (("int8", got), ("none", fp32)):
        model = VisRAGRet(tcfg(quant))
        from_jax_params(model, params)
        with torch.inference_mode():
            out.extend(model(finish_encode_batch(raw, ptable)).numpy()
                       for raw in (pages_raw, queries_raw))
    for g_, w_, f_ in zip(got, want, fp32):
        np.testing.assert_allclose(g_, w_, **TWIN)
        assert min(_cos(a, b) for a, b in zip(g_, f_)) > 0.99
    for q_t, q_j in ((got[1], want[1]), (got[0], want[0])):
        _, idx = topk_single(torch.from_numpy(q_t),
                             torch.from_numpy(got[0]), 4)
        _, jidx = jtopk(jnp.asarray(q_j), jnp.asarray(want[0]), 4)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))

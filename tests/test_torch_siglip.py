"""The port's SigLIP bi-tower (visrag_tpu_torch/models/siglip.py) against
the JAX package's visrag_tpu/models/siglip.py and HF's SiglipModel, on the
CPU at the tiny config (fp32).

  * shared weights (a JAX init carried by hf_loader.siglip_from_jax_params,
    perturbed so that no bias or norm is trivial): pooled text on
    full-length ids and pooled image equal the JAX model's within 1e-4;
  * under an attention mask, the text tower's hidden states on the valid
    rows equal the JAX ones (its pad rows, and so the pooled last row,
    differ by design: ROADMAP §3);
  * hf_loader.load_siglip_hf_state on a tiny transformers SiglipModel's
    state dict gives HF's pooled outputs (3e-4, as tests/test_siglip.py
    holds the JAX model), and a stray or a missing name raises.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visrag_tpu.models.siglip import SiglipConfig as JConfig
from visrag_tpu.models.siglip import SiglipModel as JModel
from visrag_tpu_torch.models.hf_loader import (load_siglip_hf_state,
                                              siglip_from_jax_params)
from visrag_tpu_torch.models.siglip import SiglipConfig, SiglipModel

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0, b=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, size=(b, 16))
    patches = rng.normal(size=(b, 16, 48)).astype(np.float32)
    return ids, patches


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, the port model carrying them)."""
    jm = JModel(JConfig.tiny())
    ids, patches = _inputs()
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ids),
                              jnp.asarray(patches))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape))
        .astype(np.float32), params)
    pm = SiglipModel(SiglipConfig.tiny())
    siglip_from_jax_params(pm, params)
    return jm, params, pm.eval()


def test_bi_tower_matches_jax(pair):
    jm, params, pm = pair
    ids, patches = _inputs(seed=2)
    jt, jv = jax.jit(jm.apply)(params, jnp.asarray(ids), jnp.asarray(patches))
    with torch.no_grad():
        t, v = pm(torch.from_numpy(ids), torch.from_numpy(patches))
    assert t.shape == (3, 32) and v.shape == (3, 32)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    with torch.no_grad():
        assert torch.equal(pm.encode_text(torch.from_numpy(ids)), t)
        assert torch.equal(pm.encode_image(torch.from_numpy(patches)), v)


def test_masked_text_valid_rows_match_jax(pair):
    jm, params, pm = pair
    ids, _ = _inputs(seed=3, b=4)
    mask = np.ones(ids.shape, np.int32)
    mask[1, 9:] = 0
    mask[2, 1:] = 0
    mask[3, 15:] = 0
    jx, _ = jax.jit(lambda p, i, a: jm.apply(
        p, i, a, method=lambda m, i, a: m.text_model(i, a)))(
        params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        x, _ = pm.text_model(torch.from_numpy(ids), torch.from_numpy(mask))
    valid = mask.astype(bool)
    np.testing.assert_allclose(x.numpy()[valid], np.asarray(jx)[valid], **TOL)


@pytest.fixture(scope="module")
def hf_siglip():
    from transformers import SiglipConfig as HFConfig
    from transformers.models.siglip.modeling_siglip import \
        SiglipModel as HFModel

    cfg = HFConfig(
        text_config=dict(hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=2,
                         vocab_size=128, max_position_embeddings=16),
        vision_config=dict(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=2,
                           image_size=16, patch_size=4),
        attn_implementation="eager")
    torch.manual_seed(0)
    return HFModel(cfg).eval()


def test_hf_loader_matches_hf_and_rejects_strays(hf_siglip):
    state = dict(hf_siglip.state_dict())
    pm = SiglipModel(SiglipConfig.tiny())
    load_siglip_hf_state(pm, state)
    ids, _ = _inputs(seed=4, b=2)
    imgs = np.random.default_rng(5).normal(size=(2, 3, 16, 16)) \
        .astype(np.float32)
    # (c, ph, pw) row-major patches of the NCHW images, as the conv reads
    patches = imgs.reshape(2, 3, 4, 4, 4, 4).transpose(0, 2, 4, 1, 3, 5) \
        .reshape(2, 16, 48)
    with torch.no_grad():
        want_t = hf_siglip.text_model(
            input_ids=torch.from_numpy(ids)).pooler_output
        want_v = hf_siglip.vision_model(
            pixel_values=torch.from_numpy(imgs)).pooler_output
        t, v = pm.eval()(torch.from_numpy(ids), torch.from_numpy(patches))
    np.testing.assert_allclose(t.numpy(), want_t.numpy(), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(v.numpy(), want_v.numpy(), rtol=3e-4,
                               atol=3e-4)
    with pytest.raises(KeyError, match="unexpected"):
        load_siglip_hf_state(SiglipModel(SiglipConfig.tiny()),
                             {**state, "text_model.stray.weight":
                              torch.zeros(1)})
    del state["vision_model.head.probe"]
    with pytest.raises(KeyError, match="missing"):
        load_siglip_hf_state(SiglipModel(SiglipConfig.tiny()), state)

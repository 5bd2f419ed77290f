"""visrag_tpu_torch.ops.attention_lengths against the JAX Pallas kernel.

The JAX side runs the TPU kernel in interpret mode, as
tests/test_ops_attention.py does; the port's CPU path is its plain PyTorch
version. Inputs come from numpy with a fixed seed; fp32; valid rows only
(rows at or past a length are outside both kernels' contract). Tolerance
2e-4 abs/rel, the bar the JAX kernel tests hold the Pallas kernel to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visrag_tpu.ops.attention import flash_attention, flash_attention_flat
from visrag_tpu_torch.ops import attention_lengths as al

TOL = dict(rtol=2e-4, atol=2e-4)
LENGTHS = np.array([128, 77, 0], np.int32)   # full, ragged, empty


def _valid(lengths, s):
    return np.arange(s)[None, :] < lengths[:, None]


@pytest.mark.parametrize("causal", [False, True])
def test_stacked_matches_pallas_interpret(causal):
    rng = np.random.default_rng(0)
    b, s, h, d = 3, 128, 2, 64
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          lengths=jnp.asarray(LENGTHS), causal=causal,
                          interpret=True, block_q=64, block_k=64)
    before = (al.flat_launches, al.stacked_launches)
    out = al.flash_fwd_lengths(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(LENGTHS),
                               causal, d ** -0.5)
    # CPU tensors take the plain version: no kernel launch is counted
    assert (al.flat_launches, al.stacked_launches) == before
    valid = _valid(LENGTHS, s)
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid],
                               **TOL)
    assert np.isfinite(out.numpy()).all()


def test_flat_matches_pallas_interpret():
    rng = np.random.default_rng(1)
    n, s, h, d = 3, 128, 2, 64
    qkv = rng.standard_normal((n * s, 3 * h * d)).astype(np.float32)
    ref = flash_attention_flat(jnp.asarray(qkv), jnp.asarray(LENGTHS), n=n,
                               seq=s, heads=h, head_dim=d,
                               sm_scale=d ** -0.5, interpret=True,
                               block_q=64, block_k=64)
    before = (al.flat_launches, al.stacked_launches)
    out = al.flash_fwd_lengths_flat(torch.from_numpy(qkv),
                                    torch.from_numpy(LENGTHS), n, s, h, d,
                                    False, d ** -0.5)
    assert (al.flat_launches, al.stacked_launches) == before
    assert out.shape == (n * s, h * d)
    valid = _valid(LENGTHS, s).reshape(-1)
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid],
                               **TOL)


def test_wrapper_rejects_bad_shapes():
    x = torch.zeros(2, 8, 2, 8)
    with pytest.raises(ValueError):
        al.flash_fwd_lengths(x, x, x[:, :4], torch.tensor([8, 8]), False, 1.0)
    with pytest.raises(ValueError):
        al.flash_fwd_lengths_flat(torch.zeros(16, 40), torch.tensor([8, 8]),
                                  2, 8, 2, 8, False, 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["vit_flat", "lm_causal"])
def test_kernel_matches_plain_on_card(shape):
    """The CUDA kernel against its plain version, bf16, at the slice's two
    shapes; 2e-2 max abs on valid rows for unit-normal inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    if shape == "vit_flat":
        n, s, h, d = 8, 1088, 16, 72
        qkv = torch.randn(n * s, 3 * h * d, generator=g,
                          device="cuda").bfloat16()
        lens = torch.tensor([1088, 1032, 600, 0, 1, 64, 65, 1000],
                            dtype=torch.int32, device="cuda")
        out = al.flash_fwd_lengths_flat(qkv, lens, n, s, h, d, False,
                                        d ** -0.5)
        ref = al.lengths_attention_reference(
            *qkv.view(n, s, 3, h, d).unbind(2), lens, False, d ** -0.5
        ).reshape(n * s, h * d)
        valid = (torch.arange(s, device="cuda")[None] < lens[:, None]
                 ).reshape(-1)
    else:
        b, s, h, d = 16, 576, 36, 64
        q, k, v = (torch.randn(b, s, h, d, generator=g,
                               device="cuda").bfloat16() for _ in range(3))
        lens = torch.randint(1, s + 1, (b,), generator=g, device="cuda",
                             dtype=torch.int32)
        out = al.flash_fwd_lengths(q, k, v, lens, True, d ** -0.5)
        ref = al.lengths_attention_reference(q, k, v, lens, True, d ** -0.5)
        valid = torch.arange(s, device="cuda")[None] < lens[:, None]
    err = (out.float() - ref.float()).abs()[valid].max().item()
    assert err <= 2e-2, err
    assert torch.isfinite(out.float()).all()

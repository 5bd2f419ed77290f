"""visrag_tpu_torch.ops.attention_lengths against the JAX Pallas kernels.

The JAX side runs the TPU kernels in interpret mode, as
tests/test_ops_attention.py does; the port's CPU path is its plain PyTorch
version, and autograd through it is the plain backward. Inputs come from
numpy with a fixed seed; fp32. Forward: valid rows only (rows at or past a
length are outside both kernels' contract), 2e-4 abs/rel, the bar the JAX
kernel tests hold the Pallas kernel to. Backward (K2): dq/dk/dv everywhere,
1e-3 abs/rel, with a `do` that is non-zero on pad rows; pad rows are
outside the forward's contract, so both sides differentiate the output
with its pad rows masked (their gradient is zero on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visrag_tpu.ops.attention import flash_attention, flash_attention_flat
from visrag_tpu.ops.attention_lengths import flash_fwd_lengths as jfwd
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


GRAD_TOL = dict(rtol=1e-3, atol=1e-3)


def _pallas_grads(fn, inputs, do, mask):
    """jax.vjp of fn(*inputs) * mask with cotangent do; and of fn alone."""
    masked = jax.vjp(lambda *xs: fn(*xs) * mask, *inputs)[1](do)
    raw = jax.vjp(fn, *inputs)[1](do)
    return [np.asarray(g) for g in masked], [np.asarray(g) for g in raw]


@pytest.mark.parametrize("causal", [False, True])
def test_stacked_grads_match_pallas_interpret(causal):
    """K2's plain version (autograd through the port's CPU path) against
    jax.grad through the Pallas dq/dkv kernels in interpret mode."""
    rng = np.random.default_rng(2)
    b, s, h, d = 3, 128, 2, 64
    q, k, v, do = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                   for _ in range(4))
    valid = _valid(LENGTHS, s)
    mask = jnp.asarray(valid[:, :, None, None].astype(np.float32))

    def fn(q_, k_, v_):
        return flash_attention(q_, k_, v_, lengths=jnp.asarray(LENGTHS),
                               causal=causal, interpret=True, block_q=64,
                               block_k=64)

    (jdq, jdk, jdv), (_, rdk, rdv) = _pallas_grads(
        fn, [jnp.asarray(x) for x in (q, k, v)], jnp.asarray(do), mask)
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = al.flash_fwd_lengths(*xs, torch.from_numpy(LENGTHS), causal,
                             d ** -0.5)
    tdq, tdk, tdv = (g.numpy() for g in torch.autograd.grad(
        o, xs, torch.from_numpy(do)))
    for got, want in ((tdq, jdq), (tdk, jdk), (tdv, jdv)):
        np.testing.assert_allclose(got, want, **GRAD_TOL)
    # the Pallas dk/dv kernel ignores pad rows' do by itself
    np.testing.assert_allclose(tdk, rdk, **GRAD_TOL)
    np.testing.assert_allclose(tdv, rdv, **GRAD_TOL)
    pad = ~valid
    for g in (tdq, tdk, tdv, jdq, jdk, jdv):
        assert not g[pad].any()
    assert np.abs(tdq[valid]).max() > 0


def test_gqa_d128_grads_match_pallas_interpret():
    """K2's plain version at the RL update's head dim 128 with grouped kv
    heads (4 query heads on 2 kv heads), causal, against the VJP of the JAX
    flash_attention(lengths=) through the Pallas kernels in interpret mode
    (which repeats K/V to 4 heads and sums their gradients back): dq at 4
    heads and dk/dv at 2, 1e-3 abs/rel, zero on pad rows."""
    rng = np.random.default_rng(5)
    b, s, h, hk, d = 3, 128, 4, 2, 128
    q, do = (rng.standard_normal((b, s, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, s, hk, d)).astype(np.float32)
            for _ in range(2))
    valid = _valid(LENGTHS, s)
    mask = jnp.asarray(valid[:, :, None, None].astype(np.float32))

    def fn(q_, k_, v_):
        return flash_attention(q_, k_, v_, lengths=jnp.asarray(LENGTHS),
                               causal=True, interpret=True, block_q=64,
                               block_k=64)

    (jdq, jdk, jdv), _ = _pallas_grads(
        fn, [jnp.asarray(x) for x in (q, k, v)], jnp.asarray(do), mask)
    assert jdk.shape == (b, s, hk, d)
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = al.flash_fwd_lengths(*xs, torch.from_numpy(LENGTHS), True, d ** -0.5)
    grads = torch.autograd.grad(o, xs, torch.from_numpy(do))
    for got, want in zip(grads, (jdq, jdk, jdv)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)
        assert not got.numpy()[~valid].any()
    assert np.abs(grads[1].numpy()[valid]).max() > 0


def test_flat_grads_match_pallas_interpret():
    """The flat form's gradient is one (n*S, 3*H*D) buffer on both sides."""
    rng = np.random.default_rng(3)
    n, s, h, d = 3, 128, 2, 64
    qkv = rng.standard_normal((n * s, 3 * h * d)).astype(np.float32)
    do = rng.standard_normal((n * s, h * d)).astype(np.float32)
    valid = _valid(LENGTHS, s).reshape(-1)
    mask = jnp.asarray(valid[:, None].astype(np.float32))

    def fn(x):
        return flash_attention_flat(x, jnp.asarray(LENGTHS), n=n, seq=s,
                                    heads=h, head_dim=d, sm_scale=d ** -0.5,
                                    interpret=True, block_q=64, block_k=64)

    (jg,), _ = _pallas_grads(fn, [jnp.asarray(qkv)], jnp.asarray(do), mask)
    x = torch.from_numpy(qkv).requires_grad_(True)
    o = al.flash_fwd_lengths_flat(x, torch.from_numpy(LENGTHS), n, s, h, d,
                                  False, d ** -0.5)
    (tg,) = torch.autograd.grad(o, (x,), torch.from_numpy(do))
    assert tg.shape == (n * s, 3 * h * d)
    np.testing.assert_allclose(tg.numpy(), jg, **GRAD_TOL)
    assert not tg.numpy()[~valid].any() and not jg[~valid].any()


@pytest.mark.parametrize("causal", [False, True])
def test_lse_reference_matches_pallas_interpret(causal):
    """The plain version of K1's LSE equals the Pallas kernel's on valid
    rows (natural log), and both put the +LARGE sentinel on length-0 rows."""
    rng = np.random.default_rng(4)
    b, s, h, d = 3, 128, 2, 64
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = (np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                  for x in (q, k, v))
    _, jlse = jfwd(jnp.asarray(tq), jnp.asarray(tk), jnp.asarray(tv),
                   jnp.asarray(LENGTHS), causal, d ** -0.5, 64, 64,
                   interpret=True)
    jlse = np.asarray(jlse)[..., 0]                       # (b, h, s)
    lse = al.lengths_lse_reference(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(LENGTHS), causal,
                                   d ** -0.5).numpy()
    vm = np.broadcast_to(_valid(LENGTHS, s)[:, None, :], (b, h, s))
    np.testing.assert_allclose(lse[vm], jlse[vm], **TOL)
    assert (lse[~vm] == np.float32(al.LSE_PAD)).all()
    assert (jlse[2] == np.float32(al.LSE_PAD)).all()      # length 0


def test_cpu_grad_path_counts_no_launch():
    x = torch.zeros(2, 8, 2, 64, requires_grad=True)
    before = al.launch_counts()
    o = al.flash_fwd_lengths(x, x, x, torch.tensor([8, 3]), True, 0.125)
    o.sum().backward()
    assert al.launch_counts() == before and x.grad is not None


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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["vit_flat", "lm_causal", "qwen_gqa"])
def test_backward_kernels_match_plain_on_card(shape):
    """K1 + LSE and K2 through the autograd Functions against autograd
    through the plain version, bf16: 2e-2 relative Frobenius error on each
    gradient, exact zeros on pad rows. qwen_gqa: d = 128, 28 query heads on
    4 kv heads, causal (the padded RL update's attention)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    hk = None
    if shape == "vit_flat":
        n, s, h, d, causal = 8, 1152, 16, 72, False
        lens = torch.tensor([1152, 1032, 600, 0, 1, 63, 64, 65],
                            dtype=torch.int32, device="cuda")
    elif shape == "lm_causal":
        n, s, h, d, causal = 4, 704, 36, 64, True
        lens = torch.tensor([704, 666, 335, 1], dtype=torch.int32,
                            device="cuda")
    else:
        n, s, h, hk, d, causal = 4, 640, 28, 4, 128, True
        lens = torch.tensor([640, 65, 64, 1], dtype=torch.int32,
                            device="cuda")
    q, do = (torch.randn(n, s, h, d, generator=g, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn(n, s, hk or h, d, generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    if shape == "vit_flat":
        qkv = torch.stack(xs, dim=2).reshape(n * s, 3 * h * d)
        o = al.flash_fwd_lengths_flat(qkv, lens, n, s, h, d, False,
                                      d ** -0.5).view(n, s, h, d)
    else:
        o = al.flash_fwd_lengths(*xs, lens, causal, d ** -0.5)
    assert o.grad_fn is not None
    grads = torch.autograd.grad(o, xs, do)
    ref = torch.autograd.grad(al.lengths_attention_reference(
        *ref_xs, lens, causal, d ** -0.5), ref_xs, do)
    valid = torch.arange(s, device="cuda")[None] < lens[:, None]
    for got, want in zip(grads, ref):
        err = (torch.linalg.norm((got - want).float()[valid])
               / torch.linalg.norm(want.float()[valid])).item()
        assert err <= 2e-2, err
        assert not got[~valid].any()

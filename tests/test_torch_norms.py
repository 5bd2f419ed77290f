"""visrag_tpu_torch.ops.norms (K7) against the JAX package's norms.

The JAX side runs the Pallas kernels `_rms_kernel` / `_ln_kernel` in
interpret mode (D a multiple of 128, rows a multiple of 8, as its wrapper
asks) and, at widths that are not, its XLA forms `_rmsnorm_xla` /
`_layernorm_xla`; gradients come from `jax.vjp` of the custom VJPs. The
port's CPU path is the plain PyTorch version, and autograd through it is
the plain backward. Inputs come from numpy at fixed seeds.

Tolerances: fp32 1e-5 abs/rel on the outputs and 1e-4 on the gradients
(sums over rows in another order); bf16 within one bf16 ulp of the larger
magnitude (2^-7 relative, both sides round an fp32 result once) plus 2^-7
absolute for values that the bias cancels, and 2e-2 on bf16 gradients
(their fp32 sums are rounded to bf16 at different points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from visrag_tpu.ops import norms as jnorms
from visrag_tpu_torch.models.common import LayerNorm, RMSNorm
from visrag_tpu_torch.ops import norms

EPS = 1e-6
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}
GRAD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(d)).astype(np.float32)
    b = (0.2 * rng.standard_normal(d)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    t = [torch.from_numpy(a).to(tdt) for a in (x, w, b)]
    j = [jnp.asarray(a).astype(jdt) for a in (x, w, b)]
    return t, j


def _port(kind, x, w, b):
    return norms.rmsnorm(x, w, EPS) if kind == "rms" \
        else norms.layernorm(x, w, b, EPS)


def _np(t):
    return np.asarray(t.float().detach().numpy() if torch.is_tensor(t)
                      else jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_matches_pallas_interpret(kind, dtype):
    """The Pallas kernel in interpret mode at (2, 8, 256)."""
    (x, w, b), (jx, jw, jb) = _inputs(0, (2, 8, 256), dtype)
    want = jnorms.rmsnorm(jx, jw, EPS, interpret=True) if kind == "rms" \
        else jnorms.layernorm(jx, jw, jb, EPS, interpret=True)
    before = norms.launch_counts()
    got = _port(kind, x, w, b)
    # a CPU tensor takes the plain version: no launch is counted
    assert norms.launch_counts() == before
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("shape", [(5, 72), (3, 1, 200), (1, 4099)])
def test_matches_xla_at_ragged_widths(kind, dtype, shape):
    """Rows and widths off the Pallas tiling (where the JAX wrapper takes
    XLA; the port's kernel takes them too)."""
    (x, w, b), (jx, jw, jb) = _inputs(1, shape, dtype)
    want = jnorms._rmsnorm_xla(jx, jw, EPS) if kind == "rms" \
        else jnorms._layernorm_xla(jx, jw, jb, EPS)
    np.testing.assert_allclose(_np(_port(kind, x, w, b)), _np(want),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_gradients_match_jax_custom_vjp(kind, dtype):
    """dx, dw (and db) against jax.vjp of the custom-VJP cores (Pallas
    forward in interpret mode, XLA recompute backward)."""
    (x, w, b), (jx, jw, jb) = _inputs(2, (16, 256), dtype)
    g = np.random.default_rng(3).standard_normal((16, 256)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    if kind == "rms":
        _, vjp = jax.vjp(lambda a, c: jnorms._rmsnorm_core(a, c, EPS, True),
                         jx, jw)
        ins = [x, w]
    else:
        _, vjp = jax.vjp(
            lambda a, c, e: jnorms._layernorm_core(a, c, e, EPS, True),
            jx, jw, jb)
        ins = [x, w, b]
    want = vjp(jnp.asarray(g).astype(jdt))
    ins = [t.clone().requires_grad_(True) for t in ins]
    y = _port(kind, *ins, None) if kind == "rms" else _port(kind, *ins)
    got = torch.autograd.grad(y, ins, torch.from_numpy(g).to(tdt))
    for a, e in zip(got, want):
        assert a.dtype == tdt
        scale = float(np.abs(_np(e)).max())
        tol = GRAD_TOL[dtype]
        np.testing.assert_allclose(_np(a), _np(e), rtol=tol["rtol"],
                                   atol=tol["atol"] * scale)


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_function_backward_under_checkpoint(kind, monkeypatch):
    """The autograd.Function the card runs, with its kernel swapped for the
    plain version (the CPU has no kernel): under non-reentrant
    torch.utils.checkpoint, with one parameter frozen, its gradients equal
    plain autograd's bit for bit, and the recompute runs the forward
    again."""
    calls = []

    def plain_launch(x, w, b, eps):
        calls.append(b is None)
        return norms.rmsnorm_reference(x, w, eps) if b is None \
            else norms.layernorm_reference(x, w, b, eps)
    monkeypatch.setattr(norms, "_launch", plain_launch)
    (x, w, b), _ = _inputs(4, (6, 96), "float32")
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (6, 96)).astype(np.float32))
    bias = None if kind == "rms" else b

    def block(fn, xx, ww, bb):
        h = xx * 1.5
        y = fn(h, ww, bb)
        return y * y

    def run(fn, remat):
        xx = x.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        bb = None if bias is None else bias.clone()      # frozen
        out = checkpoint(block, fn, xx, ww, bb, use_reentrant=False) \
            if remat else block(fn, xx, ww, bb)
        return torch.autograd.grad(out, (xx, ww), g)

    def plain(h, ww, bb):
        return norms.rmsnorm_reference(h, ww, EPS) if bb is None \
            else norms.layernorm_reference(h, ww, bb, EPS)

    def function(h, ww, bb):
        return norms._RowNorm.apply(h, ww, bb, EPS)

    want = run(plain, False)
    for remat in (False, True):
        calls.clear()
        got = run(function, remat)
        assert len(calls) == (2 if remat else 1)
        for a, e in zip(got, want):
            assert torch.equal(a, e)


def test_dispatch_raises_off_cpu_and_cuda():
    x = torch.empty(4, 8, device="meta")
    w = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        norms.rmsnorm(x, w)
    with pytest.raises(ValueError, match="unsupported device"):
        norms.layernorm(x, w, w)


def test_model_norms_route_through_ops(monkeypatch):
    """RMSNorm and LayerNorm modules call ops.norms (the kernel on the
    card) and give the plain version on the CPU."""
    seen = []
    for name in ("rmsnorm", "layernorm"):
        orig = getattr(norms, name)
        monkeypatch.setattr(norms, name, lambda *a, _o=orig, _n=name, **k:
                            seen.append(_n) or _o(*a, **k))
    (x, w, b), _ = _inputs(6, (3, 40), "float32")
    rms, ln = RMSNorm(40, eps=1e-5), LayerNorm(40, eps=1e-6)
    with torch.no_grad():
        rms.weight.copy_(w)
        ln.weight.copy_(w)
        ln.bias.copy_(b)
    torch.testing.assert_close(rms(x), norms.rmsnorm_reference(x, w, 1e-5),
                               rtol=0, atol=0)
    torch.testing.assert_close(ln(x), norms.layernorm_reference(x, w, b,
                                                                1e-6),
                               rtol=0, atol=0)
    assert seen == ["rmsnorm", "layernorm"]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_kernel_matches_plain_on_a_card(kind):
    """On a CUDA device: K7 against the plain version at the model widths
    and edge shapes, bf16 within one bf16 ulp plus 2^-16 of the fp32
    computation's scale (|x| + |μ|)·rstd·|w| + |b|, fp32 within 1e-5 of
    |y| plus that scale; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for shape, dtype in (((64, 1152), "bfloat16"), ((7, 2304), "bfloat16"),
                         ((3, 1280), "bfloat16"), ((1, 3584), "bfloat16"),
                         ((5, 64), "bfloat16"), ((2, 4096), "float32"),
                         ((3, 1000), "bfloat16")):
        (x, w, b), _ = _inputs(7, shape, dtype)
        x, w, b = x.cuda(), w.cuda(), b.cuda()
        before = norms.launch_counts()
        got = _port(kind, x, w, b)
        key = "rmsnorm" if kind == "rms" else "layernorm"
        assert norms.launch_counts()[key] == before[key] + 1
        want = norms.rmsnorm_reference(x, w, EPS) if kind == "rms" \
            else norms.layernorm_reference(x, w, b, EPS)
        err = (got.float() - want.float()).abs()
        # the fp32 computation's error scale: (|x| + |μ|)·rstd·|w| + |b|
        xf = x.float()
        mu = xf.mean(-1, keepdim=True) if kind == "ln" else 0 * xf[:, :1]
        rstd = torch.rsqrt((xf - mu).square().mean(-1, keepdim=True) + EPS)
        scale = (xf.abs() + mu.abs()) * rstd * w.float().abs() \
            + (b.float().abs() if kind == "ln" else 0)
        if dtype == "bfloat16":
            mag = torch.maximum(got.float().abs(), want.float().abs())
            bound = torch.exp2(torch.floor(torch.log2(
                mag.clamp(min=1e-30))) - 7) + 2 ** -16 * scale
        else:
            bound = 1e-5 * (want.abs() + scale)
        assert bool((err <= bound).all()), (shape, float(err.max()))

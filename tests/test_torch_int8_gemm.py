"""K6, the w8a8 GEMM with its dequantizing epilogue, on the CPU.

The wrapper (visrag_tpu_torch/ops/matmul_int8.int8_matmul_fused) takes any
N and writes bf16 or fp32, as the JAX function does: its CPU path (the
plain version) is held against the Pallas kernel int8_matmul_fused in
interpret mode on the same numpy-seeded int8 codes at an odd N, with and
without bias, in both output types. The int32 product is exact on both
sides; the fp32 epilogue (float(acc) * xs * ws + bias) is held within one
ulp of the larger of the output and the product before the bias (XLA fuses
the bias add into the last multiply, an FMA, where the port rounds the
product first, as the kernel does), the bf16 outputs bit for bit. The
routes (the Hopper kernel by default, the mma.sync one with legacy=True,
which takes
bf16 at an even N only), the counters and refused launches are checked
with the library loader and the CUDA calls replaced by stand-ins, so no
card is needed; chip_smoke.py holds the kernel itself against the plain
version on the card, bit for bit.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visrag_tpu.ops.matmul_int8 import int8_matmul_fused as jfused
from visrag_tpu_torch.ops import _build
from visrag_tpu_torch.ops import matmul_int8 as mi


def _codes(m, k, n, seed):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    wq = rng.integers(-127, 128, (n, k), dtype=np.int8)
    xs = (rng.random(m, dtype=np.float32) + 0.05) / 127
    ws = (rng.random(n, dtype=np.float32) + 0.05) / 127
    bias = rng.standard_normal(n).astype(np.float32)
    return xq, wq, xs, ws, bias


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_cpu_wrapper_matches_pallas_interpret(out_dtype, bias):
    """Odd N (71) and K off every block size (200): the exact int32 product,
    then fp32 within one ulp of max(|out|, |acc xs ws|) and bf16 bit for bit
    of the Pallas kernel."""
    m, k, n = 37, 200, 71
    xq, wq, xs, ws, b = _codes(m, k, n, seed=n + bias)
    b = b if bias else None
    acc = mi.int8_product(torch.from_numpy(xq), torch.from_numpy(wq))
    np.testing.assert_array_equal(
        acc.numpy(), xq.astype(np.int64) @ wq.astype(np.int64).T)
    got = mi.int8_matmul_fused(
        torch.from_numpy(xq), torch.from_numpy(xs), torch.from_numpy(wq),
        torch.from_numpy(ws), None if b is None else torch.from_numpy(b),
        getattr(torch, out_dtype))
    want = np.asarray(jfused(
        jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(wq.T), jnp.asarray(ws),
        None if b is None else jnp.asarray(b),
        out_dtype=getattr(jnp, out_dtype), interpret=True))
    assert got.shape == (m, n)
    if out_dtype == "float32":
        prod = acc.numpy().astype(np.float32) * xs[:, None] * ws[None, :]
        ulp = np.spacing(np.maximum(np.abs(want), np.abs(prod)))
        assert (np.abs(got.numpy() - want) <= ulp).all()
    else:
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))


class _FakeLibrary:
    """Stands in for a built library: every entry point records its
    arguments and returns state["rc"]."""

    def __init__(self, name, calls, state):
        self.name, self.calls, self.state = name, calls, state

    def __getattr__(self, entry):
        def fn(*args):
            self.calls.append((self.name, entry, args))
            return self.state["rc"]
        return fn


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors take the CUDA path: the loader returns _FakeLibrary and
    the CUDA calls around a launch are stand-ins. → (calls, set_rc)."""
    calls, state = [], {"rc": 0}
    monkeypatch.setattr(_build, "load_library",
                        lambda name: _FakeLibrary(name, calls, state))
    monkeypatch.setattr(mi, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    mi.reset_launch_counts()
    yield calls, lambda rc: state.__setitem__("rc", rc)
    mi.reset_launch_counts()


def _inputs(m, k, n):
    xq, wq, xs, ws, b = _codes(m, k, n, seed=0)
    return tuple(torch.from_numpy(a) for a in (xq, xs, wq, ws, b))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_every_cuda_call_takes_the_hopper_kernel(fake_card, out_dtype):
    """Any N and either output type launch visrag_int8_gemm_hopper with K
    padded to 16 bytes (M, N, padded K, fp32 flag), and count on the Hopper
    route."""
    calls, _ = fake_card
    for m, k, n in ((37, 200, 71), (5, 2304, 1), (1, 1152, 3456)):
        xq, xs, wq, ws, b = _inputs(m, k, n)
        out = mi.int8_matmul_fused(xq, xs, wq, ws, b, out_dtype)
        assert out.shape == (m, n) and out.dtype == out_dtype
    assert [(lib, e) for lib, e, _ in calls] == [
        ("matmul_int8_hopper", "visrag_int8_gemm_hopper")] * 3
    flag = int(out_dtype == torch.float32)
    assert [args[6:10] for _, _, args in calls] == [
        (37, 71, 208, flag), (5, 1, 2304, flag), (1, 3456, 1152, flag)]
    assert mi.launches == 3
    assert mi.route_counts() == {"hopper": 3, "legacy": 0}


def test_legacy_reaches_pr5_kernel_and_refuses_what_it_cannot_take(
        fake_card):
    """legacy=True launches the mma.sync kernel with K padded to 64 bytes; it
    raises, before any launch, for an odd N or fp32 output."""
    calls, _ = fake_card
    xq, xs, wq, ws, b = _inputs(9, 200, 70)
    mi.int8_matmul_fused(xq, xs, wq, ws, b, legacy=True)
    assert [(lib, e) for lib, e, _ in calls] == [
        ("matmul_int8", "visrag_int8_gemm")]
    assert calls[0][2][6:9] == (9, 70, 256)
    with pytest.raises(ValueError, match="even N"):
        mi.int8_matmul_fused(xq, xs, wq, ws, b, torch.float32, legacy=True)
    xq, xs, wq, ws, b = _inputs(9, 200, 71)
    with pytest.raises(ValueError, match="even N"):
        mi.int8_matmul_fused(xq, xs, wq, ws, b, legacy=True)
    assert len(calls) == 1
    assert mi.route_counts() == {"hopper": 0, "legacy": 1}


def test_a_refused_launch_raises(fake_card):
    """A refused tensor map (-1) or a launch error raises; the mma.sync kernel
    and the plain version do not run instead, and nothing is counted."""
    calls, set_rc = fake_card
    xq, xs, wq, ws, b = _inputs(9, 128, 64)
    for rc, words in ((-1, "tensor map"), (1, "CUDA error 1"),
                      (700, "CUDA error 700")):
        set_rc(rc)
        calls.clear()
        with pytest.raises(RuntimeError, match=words):
            mi.int8_matmul_fused(xq, xs, wq, ws, b)
        assert [e for _, e, _ in calls] == ["visrag_int8_gemm_hopper"]
    with pytest.raises(TypeError, match="writes"):
        mi.int8_matmul_fused(xq, xs, wq, ws, b, torch.float16)
    assert mi.launches == 0
    assert mi.route_counts() == {"hopper": 0, "legacy": 0}


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_library(name):
        raise AssertionError(f"library {name} loaded for CPU tensors")
    monkeypatch.setattr(_build, "load_library", no_library)
    mi.reset_launch_counts()
    xq, xs, wq, ws, b = _inputs(13, 100, 33)
    for dt in (torch.bfloat16, torch.float32):
        got = mi.int8_matmul_fused(xq, xs, wq, ws, b, dt)
        assert torch.equal(got, mi.int8_matmul_reference(xq, xs, wq, ws, b,
                                                         dt))
    assert mi.launches == 0
    assert mi.route_counts() == {"hopper": 0, "legacy": 0}

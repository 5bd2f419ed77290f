"""The Hopper K1's tile classes and column plan, and the routes of K1 and of
K7's RMSNorm, on the CPU.

`lengths_pair_classes_reference` (visrag_tpu_torch/ops/attention_lengths.py)
is the plain version of the valid-length kernel's closed-form classes: a
(query tile, key tile) pair is skipped, run without a mask, or masked per
element. Skipping a pair that holds an allowed (query < length, key)
element, or running a pair without its mask that holds a disallowed one,
would change the result; a seeded sweep over lengths at and around the
tile edges, the paths' bucket widths and both masks checks that neither
happens. `column_plan` is how the kernel reads a head dim (64-column
pieces, and a 16-column piece for d = 72). The routes are checked with the
library loader and the CUDA calls replaced by stand-ins, so no card is
needed; chip_smoke.py holds the kernels themselves against the plain
versions on the card.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from visrag_tpu_torch.ops import _build
from visrag_tpu_torch.ops import attention_lengths as al
from visrag_tpu_torch.ops import norms

EDGE_LENGTHS = [0, 1, 63, 64, 65, 127, 128, 129]
TILES = [al.HOPPER_TILE, (64, 64)]


def _tile_any_all(allow, s, bq, bk):
    """(S, S) bool → per (query tile, key tile): any element True, every
    element True (cells past S count as False for any, True for all)."""
    nq, nk = -(-s // bq), -(-s // bk)
    pad_any = torch.zeros((nq * bq, nk * bk), dtype=torch.bool)
    pad_all = torch.ones((nq * bq, nk * bk), dtype=torch.bool)
    pad_any[:s, :s] = allow
    pad_all[:s, :s] = allow
    return (pad_any.reshape(nq, bq, nk, bk).any(3).any(1),
            pad_all.reshape(nq, bq, nk, bk).all(3).all(1))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [704, 1088, 1152, 4096])
def test_pair_classes_are_exact(s, causal):
    """No skipped pair holds an allowed (query < length, key) element; every
    element of an unmasked pair is allowed (`_allowed`, the plain
    version's mask); at the kernel's tiles and at 64 x 64."""
    rng = np.random.default_rng(s + causal)
    lens = EDGE_LENGTHS + [s] + [int(x) for x in rng.integers(0, s + 1, 2)]
    lengths = torch.tensor(lens, dtype=torch.int32)
    # the kernel's tiles everywhere; 64 x 64 as well at the shorter buckets
    tiles = TILES if s < 4096 else TILES[:1]
    classes = {t: al.lengths_pair_classes_reference(lengths, s, *t, causal)
               for t in tiles}
    rows = torch.arange(s)
    for i, n in enumerate(lens):
        allow = al._allowed(s, lengths[i:i + 1], causal, "cpu")[0, 0]
        live = allow & (rows[:, None] < n)
        for (bq, bk), cls in classes.items():
            any_live, _ = _tile_any_all(live, s, bq, bk)
            _, all_allowed = _tile_any_all(allow, s, bq, bk)
            c = cls[i]
            assert not (any_live & (c == al.SKIP)).any(), (n, bq, bk)
            assert all_allowed[c == al.UNMASKED].all(), (n, bq, bk)


def test_pair_classes_of_one_prompt():
    """A 586-token prompt in a 4096-row causal bucket: query tiles 0-4 each
    see their diagonal (masked) and the tiles before it (unmasked); every
    query tile from row 640 on, and every key tile past the diagonal, is
    skipped."""
    cls = al.lengths_pair_classes_reference(torch.tensor([586]), 4096, 128,
                                            128, True)[0]
    assert cls.shape == (32, 32)
    for qt in range(5):
        want = [al.UNMASKED] * qt + [al.MASKED] + [al.SKIP] * (31 - qt)
        assert cls[qt].tolist() == want
    assert (cls[5:] == al.SKIP).all()
    assert int((cls != al.SKIP).sum()) == 15


@pytest.mark.parametrize("d", al.KERNEL_HEAD_DIMS)
def test_column_plan_covers_the_head_dim(d):
    """64-column pieces with the 128-byte swizzle, then at most one
    16-column piece with the 32-byte swizzle, in order from column 0; the
    pieces reach d and pass it by less than 16 columns."""
    plan = al.column_plan(d)
    at = 0
    for i, (c0, width, swizzle) in enumerate(plan):
        assert c0 == at
        assert (width, swizzle) in ((64, 128), (16, 32))
        if width == 16:
            assert i == len(plan) - 1
        at += width
    assert d <= at < d + 16


def test_column_plan_of_each_head_dim():
    assert al.column_plan(64) == ((0, 64, 128),)
    assert al.column_plan(72) == ((0, 64, 128), (64, 16, 32))
    assert al.column_plan(128) == ((0, 64, 128), (64, 64, 128))
    for d in (0, 60, 100, 36):
        with pytest.raises(ValueError):
            al.column_plan(d)


def test_route_by_head_dim():
    for d in al.KERNEL_HEAD_DIMS:
        assert al._route(d) == ("attention_lengths_hopper",
                                "visrag_lengths_hopper_fwd")
        assert al._route(d, legacy=True) == ("attention_lengths",
                                             "visrag_lengths_attention_fwd")
    with pytest.raises(ValueError):
        al._route(80)


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
    """The loader returns _FakeLibrary; the CUDA calls around a launch are
    stand-ins. → (calls, set_rc)."""
    calls, state = [], {"rc": 0}
    monkeypatch.setattr(_build, "load_library",
                        lambda name: _FakeLibrary(name, calls, state))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(al, "_stream", lambda t: 0)
    for cached in (norms._kernel, al._entry):
        cached.cache_clear()
    yield calls, lambda rc: state.__setitem__("rc", rc)
    for cached in (norms._kernel, al._entry):
        cached.cache_clear()


def _qkv(b, s, h, hk, d):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, s, h, d, generator=g).bfloat16()
    k, v = (torch.randn(b, s, hk, d, generator=g).bfloat16()
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("d", al.KERNEL_HEAD_DIMS)
def test_every_launch_takes_the_hopper_kernel(fake_card, d):
    """_fwd launches the Hopper entry point with the column plan, causal or
    not, with or without the LSE, grouped kv heads or not; legacy=True, and
    only that, launches the mma.sync one; each route counts its own."""
    calls, _ = fake_card
    al.reset_launch_counts()
    lengths = torch.tensor([5, 0], dtype=torch.int32)
    for causal in (False, True):
        for hk in (4, 2):
            q, k, v = _qkv(2, 16, 4, hk, d)
            o = torch.empty_like(q)
            for lse in (None, torch.empty(2, 4, 16)):
                al._fwd(q, k, v, o, lse, lengths, causal, d ** -0.5)
    plan = [x for piece in al.column_plan(d) for x in piece]
    assert len(calls) == 8
    for name, entry, args in calls:
        assert (name, entry) == ("attention_lengths_hopper",
                                 "visrag_lengths_hopper_fwd")
        assert list(args[-3]) == plan and args[-2] == len(plan) // 3
    assert al.route_counts() == {"hopper": 8, "legacy": 0}
    calls.clear()
    q, k, v = _qkv(2, 16, 4, 4, d)
    al._fwd(q, k, v, torch.empty_like(q), None, lengths, True, 0.1,
            legacy=True)
    assert [(n, e) for n, e, _ in calls] == [("attention_lengths",
                                              "visrag_lengths_attention_fwd")]
    assert len(calls[0][2]) == 26       # no plan: the legacy signature
    assert al.route_counts() == {"hopper": 8, "legacy": 1}
    al.reset_launch_counts()


def test_a_refused_launch_raises(fake_card):
    """A refused tensor map (-1) or a launch error raises; no
    other kernel and no plain version runs instead."""
    calls, set_rc = fake_card
    q, k, v = _qkv(1, 16, 4, 4, 72)
    lengths = torch.tensor([9], dtype=torch.int32)
    al.reset_launch_counts()
    for rc, words in ((-1, "tensor map"), (1, "CUDA error 1")):
        set_rc(rc)
        calls.clear()
        with pytest.raises(RuntimeError, match=words):
            al._fwd(q, k, v, torch.empty_like(q), None, lengths, False, 0.1)
        assert [e for _, e, _ in calls] == ["visrag_lengths_hopper_fwd"]
    assert al.route_counts() == {"hopper": 0, "legacy": 0}


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_library(name):
        raise AssertionError(f"library {name} loaded for CPU tensors")
    monkeypatch.setattr(_build, "load_library", no_library)
    al.reset_launch_counts()
    q, k, v = _qkv(2, 24, 4, 2, 72)
    lengths = torch.tensor([24, 7], dtype=torch.int32)
    got = al.flash_fwd_lengths(q, k, v, lengths, True, 0.1)
    assert torch.equal(got, al.lengths_attention_reference(q, k, v, lengths,
                                                           True, 0.1))
    qkv = torch.randn(2 * 24, 3 * 4 * 72).bfloat16()
    flat = al.flash_fwd_lengths_flat(qkv, lengths, 2, 24, 4, 72, False, 0.1)
    assert flat.shape == (48, 288)
    assert al.route_counts() == {"hopper": 0, "legacy": 0}
    assert al.launch_counts()["flat"] == al.launch_counts()["stacked"] == 0


def test_rms_route_by_width_dtype_and_rows():
    bf, f32 = torch.bfloat16, torch.float32
    many = norms.WARP_MIN_ROWS
    for dtype in (bf, f32):
        for d in (8, 64, 1280, 2048, 2304, 3584, 4096):
            assert norms.rms_route(dtype, d, many) == "warp", (dtype, d)
            assert norms.rms_route(dtype, d, 16384) == "warp", (dtype, d)
            # a few rows (the decode step's 4) spread over more SMs as a
            # block each
            assert norms.rms_route(dtype, d, many - 1) == "block", (dtype, d)
            assert norms.rms_route(dtype, d, 4) == "block", (dtype, d)
        assert norms.rms_route(dtype, 4104, many) == "block"
        assert norms.rms_route(dtype, 8192, many) == "block"
        assert norms.rms_route(dtype, 2048, many, legacy=True) == "block"
        assert norms.rms_route(dtype, 2048, many, aligned=False) \
            == "block_scalar"
    # ragged: not a multiple of 8, so not the warp kernel; bf16 then has no
    # 16-byte vectors either, fp32 does at a multiple of 4
    assert norms.rms_route(bf, 4099, many) == "block_scalar"
    assert norms.rms_route(bf, 2052, many) == "block_scalar"
    assert norms.rms_route(f32, 2052, many) == "block"
    with pytest.raises(TypeError):
        norms.rms_route(torch.float16, 2048, many)


def test_norm_launch_takes_the_routed_entry(fake_card):
    """RMSNorm launches the entry point rms_route names (the warp kernel
    without the vector flag); LayerNorm always the block kernel; the warp
    launches are counted apart."""
    calls, _ = fake_card
    norms.reset_launch_counts()
    g = torch.Generator().manual_seed(1)
    w = torch.randn(64, generator=g).bfloat16()
    x = torch.randn(norms.WARP_MIN_ROWS, 64, generator=g).bfloat16()
    norms._launch(x, w, None, 1e-6)
    norms._launch(x, w, None, 1e-6, legacy=True)
    norms._launch(x, w, w, 1e-6)
    norms._launch(x[:4], w, None, 1e-6)
    x2 = torch.randn(3, 4099, generator=g).bfloat16()
    norms._launch(x2, torch.randn(4099, generator=g).bfloat16(), None, 1e-6)
    entries = [(e, len(a)) for _, e, a in calls]
    assert entries == [("visrag_rmsnorm_warp", 9), ("visrag_rmsnorm", 10),
                       ("visrag_layernorm", 11), ("visrag_rmsnorm", 10),
                       ("visrag_rmsnorm", 10)]
    assert calls[0][2][3] == norms.WARP_MIN_ROWS and calls[3][2][3] == 4
    assert calls[1][2][-2] == 1 and calls[4][2][-2] == 0   # vector flag
    assert norms.route_counts() == {"rms_warp": 1, "rms_block": 3}
    assert norms.launch_counts() == {"rmsnorm": 4, "layernorm": 1}
    norms.reset_launch_counts()

"""The Hopper K2's tile classes and walks, and its routes, on the CPU.

`lengths_bwd_pair_classes_reference` (visrag_tpu_torch/ops/
attention_lengths.py) is the plain version of the valid-length backward
kernels' closed-form classes at their 64 x 64 tiles (a dk/dv block's 64
keys against 64-row query tiles; a dq warpgroup's 64 rows against 64-key
tiles): a pair is skipped, run without a mask, or masked per element.
Skipping a pair that holds a live (query < length, key < length, causal)
element would drop a gradient term; running a pair unmasked that holds a
query row at or past the length would let the caller's garbage `do` there
into dk and dv. A seeded sweep over lengths at and around the tile edges,
the paths' widths and both masks checks that neither happens, and that the
kernels' walks (documented in csrc/attention_lengths_bwd_hopper.cu) reach
every pair that is not skipped. The routes are checked with the library
loader and the CUDA calls replaced by stand-ins, so no card is needed;
chip_smoke.py holds the kernels themselves against the plain autograd on
the card.
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from visrag_tpu_torch.ops import _build
from visrag_tpu_torch.ops import attention_lengths as al

EDGE_LENGTHS = [0, 1, 63, 64, 65, 127, 128, 129]
BQ, BK = al.BWD_TILE


def _live(s, n, causal):
    """(S, S) bool: query < n, key < n, key <= query when causal."""
    pos = torch.arange(s)
    live = (pos[:, None] < n) & (pos[None, :] < n)
    if causal:
        live = live & (pos[:, None] >= pos[None, :])
    return live


def _tiles(mask, s, bq, bk, reduce):
    nq, nk = -(-s // bq), -(-s // bk)
    pad = torch.full((nq * bq, nk * bk), reduce == "all", dtype=torch.bool)
    pad[:s, :s] = mask
    t = pad.reshape(nq, bq, nk, bk)
    return t.any(3).any(1) if reduce == "any" else t.all(3).all(1)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [300, 704, 1152])
def test_bwd_pair_classes_are_exact(s, causal):
    """No skipped pair holds a live element and every element of an
    unmasked pair is live, at the kernels' 64 x 64 tiles."""
    rng = np.random.default_rng(s + causal)
    lens = EDGE_LENGTHS + [s] + [int(x) for x in rng.integers(0, s + 1, 2)]
    lengths = torch.tensor(lens, dtype=torch.int32)
    classes = al.lengths_bwd_pair_classes_reference(lengths, s, BQ, BK,
                                                    causal)
    assert classes.shape == (len(lens), -(-s // BQ), -(-s // BK))
    for i, n in enumerate(lens):
        live = _live(s, n, causal)
        c = classes[i]
        assert not (_tiles(live, s, BQ, BK, "any") & (c == al.SKIP)).any(), n
        assert _tiles(live, s, BQ, BK, "all")[c == al.UNMASKED].all(), n


def test_bwd_classes_never_unmask_a_pad_query_row():
    """Where the forward's classes run a pair unmasked whose query tile
    reaches past the length (the forward writes those rows as zeros
    afterwards), the backward's mask it: a 100-token row, non-causal."""
    fwd = al.lengths_pair_classes_reference(torch.tensor([100]), 128, 64,
                                            64, False)[0]
    bwd = al.lengths_bwd_pair_classes_reference(torch.tensor([100]), 128,
                                                64, 64, False)[0]
    assert fwd.tolist() == [[al.UNMASKED, al.MASKED],
                            [al.UNMASKED, al.MASKED]]
    assert bwd.tolist() == [[al.UNMASKED, al.MASKED],
                            [al.MASKED, al.MASKED]]


@pytest.mark.parametrize("causal", [False, True])
def test_kernel_walks_reach_every_pair(causal):
    """dk/dv: the 64 keys at k0 < len (a block of the split kernel, a
    warpgroup of the d <= 72 kernel, whose block walks the union of its two
    warpgroups' walks) walk query tiles from k0 // 64 (causal) or 0 to
    ceil(len / 64); keys at k0 >= len write zeros. dq: a 128-row tile at
    q0 < len walks key tiles below
    ceil(min(len, q0 + 128 if causal) / 64), each warpgroup classing its
    own 64 rows; a tile at q0 >= len writes zeros. Every pair the classes
    do not skip lies inside both walks."""
    s = 1152
    for n in EDGE_LENGTHS + [300, 1000, s]:
        c = al.lengths_bwd_pair_classes_reference(torch.tensor([n]), s, BQ,
                                                  BK, causal)[0]
        live = c != al.SKIP
        nq, nk = c.shape
        in_dkv = torch.zeros_like(live)
        for kt in range(nk):
            k0 = kt * BK
            if k0 >= n:
                continue
            begin = k0 // BQ if causal else 0
            in_dkv[begin:-(-n // BQ), kt] = True
        in_dq = torch.zeros_like(live)
        for qt in range(-(-s // 128)):
            q0 = qt * 128
            if q0 >= n:
                continue
            end = min(n, q0 + 128) if causal else n
            in_dq[2 * qt:2 * qt + 2, :-(-end // BK)] = True
        assert not (live & ~in_dkv).any(), (n, causal)
        assert not (live & ~in_dq).any(), (n, causal)


def test_bwd_route_by_head_dim():
    for d in al.BWD_HEAD_DIMS:
        lib, entries = al._bwd_route(d)
        assert lib == "attention_lengths_bwd_hopper"
        assert entries == {"dq": "visrag_lengths_hopper_bwd_dq",
                           "dkv": "visrag_lengths_hopper_bwd_dkv"}
        lib, entries = al._bwd_route(d, legacy=True)
        assert lib == "attention_lengths_bwd"
        assert entries == {"dq": "visrag_lengths_attention_bwd_dq",
                           "dkv": "visrag_lengths_attention_bwd_dkv"}
    for d in (80, 96):
        with pytest.raises(ValueError):
            al._bwd_route(d)


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
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(al, "_stream", lambda t: 0)
    for cached in (al._entry, al._bwd_entry):
        cached.cache_clear()
    al.reset_launch_counts()
    yield calls, lambda rc: state.__setitem__("rc", rc)
    for cached in (al._entry, al._bwd_entry):
        cached.cache_clear()
    al.reset_launch_counts()


def _bwd_inputs(b, s, h, hk, d):
    g = torch.Generator().manual_seed(0)
    q, o, do = (torch.randn(b, s, h, d, generator=g).bfloat16()
                for _ in range(3))
    k, v = (torch.randn(b, s, hk, d, generator=g).bfloat16()
            for _ in range(2))
    lse, delta = torch.zeros(b, h, s), torch.zeros(b, h, s)
    lengths = torch.tensor([s, 3][:b], dtype=torch.int32)
    return q, k, v, o, do, lse, delta, lengths


@pytest.mark.parametrize("d", al.BWD_HEAD_DIMS)
def test_every_bwd_launch_takes_the_hopper_kernels(fake_card, d):
    """flash_bwd_dq and flash_bwd_dkv launch the Hopper entry points with
    the column plan, causal or not, H_kv = H and 16/2; each launch counts
    on the Hopper route and by head dim."""
    calls, _ = fake_card
    plan = [x for piece in al.column_plan(d) for x in piece]
    for hk in (16, 2):
        q, k, v, o, do, lse, delta, lengths = _bwd_inputs(2, 16, 16, hk, d)
        for causal in (False, True):
            al.flash_bwd_dq(q, k, v, o, do, lse, delta, lengths, causal,
                            d ** -0.5, torch.empty_like(q))
            al.flash_bwd_dkv(q, k, v, o, do, lse, delta, lengths, causal,
                             d ** -0.5, torch.empty_like(k),
                             torch.empty_like(v))
    assert [e for _, e, _ in calls] == [
        "visrag_lengths_hopper_bwd_dq", "visrag_lengths_hopper_bwd_dkv"] * 4
    for name, entry, args in calls:
        assert name == "attention_lengths_bwd_hopper"
        assert len(args) == 22
        assert list(args[-3]) == plan and args[-2] == len(plan) // 3
        assert args[15] == d
    assert [args[14] for _, _, args in calls] == [16] * 4 + [2] * 4
    assert al.bwd_route_counts() == {"hopper": 8, "legacy": 0}
    assert al.bwd_head_dim_counts() == {
        kind: {x: 4 if x == d else 0 for x in al.BWD_HEAD_DIMS}
        for kind in ("dq", "dkv")}
    assert al.launch_counts()["dq"] == al.launch_counts()["dkv"] == 4
    assert al.route_counts() == {"hopper": 0, "legacy": 0}


def test_flat_backward_passes_the_flat_strides(fake_card):
    """The ViT's flat form on a fake card: K1 with the LSE forward, then K2
    dq and dk/dv on (n, S, H, D) views of one (n S, 3 H D) gradient buffer,
    with the views' strides."""
    calls, _ = fake_card
    n, s, h, d = 2, 16, 4, 72
    qkv = torch.randn(n * s, 3 * h * d).bfloat16().requires_grad_(True)
    lengths = torch.tensor([16, 5], dtype=torch.int32)
    # the CUDA checks look only at dtype, strides and alignment
    monkey = al._device_kind
    try:
        al._device_kind = lambda t: "cuda"
        o = al.flash_fwd_lengths_flat(qkv, lengths, n, s, h, d, False, 0.1)
        o.backward(torch.ones_like(o))
    finally:
        al._device_kind = monkey
    entries = [e for _, e, _ in calls]
    assert entries == ["visrag_lengths_hopper_fwd",
                       "visrag_lengths_hopper_bwd_dq",
                       "visrag_lengths_hopper_bwd_dkv"]
    row = 3 * h * d
    flat, stacked = [s * row, row, d], [s * h * d, h * d, d]
    for _, _, args in calls[1:]:
        # (batch, row, head) strides of q, k, v, o, do, dq, dk, dv
        strides = list((ctypes.c_longlong * 24).from_address(args[16].value))
        assert strides == flat * 3 + stacked * 2 + flat * 3
    assert al.bwd_route_counts() == {"hopper": 2, "legacy": 0}
    assert al.bwd_head_dim_counts()["dq"][72] == 1
    assert qkv.grad.shape == qkv.shape


def test_legacy_reaches_the_mma_sync_kernels(fake_card):
    calls, _ = fake_card
    q, k, v, o, do, lse, delta, lengths = _bwd_inputs(2, 16, 16, 2, 128)
    al._bwd("dq", q, k, v, o, do, lse, delta, lengths, True, 0.1,
            torch.empty_like(q), k, v, legacy=True)
    al._bwd("dkv", q, k, v, o, do, lse, delta, lengths, True, 0.1, q,
            torch.empty_like(k), torch.empty_like(v), legacy=True)
    assert [(n, e) for n, e, _ in calls] == [
        ("attention_lengths_bwd", "visrag_lengths_attention_bwd_dq"),
        ("attention_lengths_bwd", "visrag_lengths_attention_bwd_dkv")]
    assert all(len(args) == 20 for _, _, args in calls)   # no plan
    assert al.bwd_route_counts() == {"hopper": 0, "legacy": 2}
    assert al.bwd_head_dim_counts()["dq"][128] == 0


@pytest.mark.parametrize("kind", ["dq", "dkv"])
def test_a_refused_bwd_launch_raises(fake_card, kind):
    """A refused tensor map (-1) or a launch error raises; no other kernel
    and no plain version runs instead, and nothing is counted."""
    calls, set_rc = fake_card
    q, k, v, o, do, lse, delta, lengths = _bwd_inputs(2, 16, 4, 4, 72)
    for rc, words in ((-1, "tensor map"), (1, "CUDA error 1"),
                      (700, "CUDA error 700")):
        set_rc(rc)
        calls.clear()
        with pytest.raises(RuntimeError, match=words):
            if kind == "dq":
                al.flash_bwd_dq(q, k, v, o, do, lse, delta, lengths, False,
                                0.1, torch.empty_like(q))
            else:
                al.flash_bwd_dkv(q, k, v, o, do, lse, delta, lengths, False,
                                 0.1, torch.empty_like(k),
                                 torch.empty_like(v))
        assert [e for _, e, _ in calls] == [
            f"visrag_lengths_hopper_bwd_{kind}"]
    assert al.bwd_route_counts() == {"hopper": 0, "legacy": 0}
    assert al.launch_counts()[kind] == 0


def test_cpu_tensors_take_the_plain_backward(monkeypatch):
    def no_library(name):
        raise AssertionError(f"library {name} loaded for CPU tensors")
    monkeypatch.setattr(_build, "load_library", no_library)
    al.reset_launch_counts()
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 24, 4, 72, generator=g).requires_grad_(True)
    k, v = (torch.randn(2, 24, 2, 72, generator=g).requires_grad_(True)
            for _ in range(2))
    lengths = torch.tensor([24, 7], dtype=torch.int32)
    al.flash_fwd_lengths(q, k, v, lengths, True, 0.1).square().sum() \
        .backward()
    ref = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    al.lengths_attention_reference(*ref, lengths, True, 0.1).square().sum() \
        .backward()
    for got, want in zip((q, k, v), ref):
        assert torch.equal(got.grad, want.grad)
    assert al.bwd_route_counts() == {"hopper": 0, "legacy": 0}
    assert al.launch_counts()["dq"] == al.launch_counts()["dkv"] == 0

"""The Hopper K4 dq's tile classes and walk, and K4's routes, on the CPU.

`segment_dq_pair_classes_reference` (visrag_tpu_torch/ops/attention.py) is
the plain version of the dq kernel's walk on the shared Hopper dq body: a
128-row query block, each consumer warpgroup classing its 64 rows against
each 64-key tile from the pre-pass's [min, max, uniform] tile classes. A
SKIP pair that holds a visible (query, key) element would drop a dq term;
an UNMASKED pair that holds an invisible one would let a pad row's or
another segment's key in. A seeded sweep over packed rows (non-ascending
and negative ids, pads, all-pad rows, Sq != Sk, causal and not) holds the
walk against the visibility mask that `segment_backward_reference` uses.
The routes are checked with the library loader and the CUDA calls replaced
by stand-ins, so no card is needed; chip_smoke.py holds the kernel itself
against the plain backward on the card.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from test_torch_segment_tiles import _ids
from visrag_tpu_torch.ops import _build
from visrag_tpu_torch.ops import attention as seg

BQ, BK = 64, 64    # a warpgroup's rows, a key tile


def _walk(q_seg, kv_seg, causal):
    """(B, Sq, Sk) class of the (warpgroup, key tile) pair holding each
    (query, key) element, from the plain walk."""
    b, sq = q_seg.shape
    sk = kv_seg.shape[1]
    cls = seg.segment_dq_pair_classes_reference(q_seg, kv_seg, causal)
    per_half = cls.reshape(b, -1, cls.shape[-1])          # (B, 2 nblk, nk)
    return per_half.repeat_interleave(BQ, 1).repeat_interleave(BK, 2)[
        :, :sq, :sk], cls


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("causal", [False, True])
def test_dq_classes_hold_every_visible_pair(seed, causal):
    """No SKIP pair holds a visible element and every UNMASKED pair is
    wholly visible, per warpgroup at 64 x 64; every visible element's key
    tile is loaded; a key tile both warpgroups skip is not."""
    rng = np.random.default_rng(100 + seed)
    b = 3
    sq = int(rng.integers(1, 700))
    sk = sq if seed % 2 == 0 else int(rng.integers(1, 700))
    q_seg = _ids(rng, b, sq)
    kv_seg = q_seg.clone() if sk == sq and rng.random() < 0.7 \
        else _ids(rng, b, sk)
    vis = seg._visible(q_seg, kv_seg, causal)
    per_elem, cls = _walk(q_seg, kv_seg, causal)
    assert not (vis & (per_elem == seg.SKIP)).any()
    assert cls.shape == (b, -(-sq // 128), 2, -(-sk // 64))
    # every element of an unmasked pair is visible (cells past Sq or Sk are
    # not elements of the pair's tiles)
    nblk, nk = cls.shape[1], cls.shape[3]
    padded = torch.zeros((b, 2 * nblk * BQ, nk * BK), dtype=torch.bool)
    padded[:, :sq, :sk] = vis
    tiles = padded.reshape(b, 2 * nblk, BQ, nk, BK).all(-1).all(2)
    assert tiles[cls.reshape(b, 2 * nblk, nk) == seg.UNMASKED].all()
    # the producer loads a key tile iff one warpgroup does not skip it
    loads = (cls != seg.SKIP).any(2)                       # (B, nblk, nk)
    needed = padded.reshape(b, nblk, 2 * BQ, nk, BK).any(-1).any(2)
    assert not (needed & ~loads).any()


def test_dq_walk_on_whole_segments_and_pad_blocks():
    """One 640-token segment (causal): below the diagonal every pair is
    unmasked, the diagonal's are masked and the rest skipped; a 128-row
    block of pad rows walks nothing; Sq != Sk ends the causal walk at the
    block's last row."""
    ids = torch.zeros((1, 896), dtype=torch.int32)
    ids[0, :640] = 3
    cls = seg.segment_dq_pair_classes_reference(ids, ids, True)[0]
    for blk in range(5):
        for w in range(2):
            r = 2 * blk + w
            want = [seg.UNMASKED if t < r else seg.MASKED if t == r
                    else seg.SKIP for t in range(14)]
            assert cls[blk, w].tolist() == want, (blk, w)
    assert (cls[5:] == seg.SKIP).all()          # rows 640-895: pad
    q = torch.ones((1, 100), dtype=torch.int32)
    k = torch.ones((1, 300), dtype=torch.int32)
    cls = seg.segment_dq_pair_classes_reference(q, k, True)[0]
    assert cls.shape == (1, 2, 5)
    assert (cls[0, :, 2:] == seg.SKIP).all()    # keys 128+ past row 99
    assert cls[0, 1].tolist() == [seg.MASKED, seg.MASKED] + [seg.SKIP] * 3


@pytest.mark.parametrize("d", [64, 80, 128])
def test_dq_routes_to_the_hopper_entry(d):
    lib, entry, tiles = seg._route("dq", d)
    assert (lib, entry) == ("attention_segment_hopper",
                            "visrag_segment_hopper_dq")
    assert tiles == seg.HOPPER_TILES["dq"] == seg.HOPPER_TILES["dkv"]
    assert seg._route("dq", d, legacy=True) == (
        "attention_segment", "visrag_segment_attention_bwd_dq",
        seg.LEGACY_TILES)


def test_dq_at_80_stays_on_the_mma_sync_kernel():
    """The mma.sync dq at d 80 stays reachable with `legacy=True` only;
    the vision tower's dq (K3's backward) runs the Hopper dq."""
    assert seg._route("dq", 80, legacy=True) == (
        "attention_segment", "visrag_segment_attention_bwd_dq",
        seg.LEGACY_TILES)
    assert seg._route("dq", 80) == ("attention_segment_hopper",
                                    "visrag_segment_hopper_dq",
                                    seg.HOPPER_TILES["dq"])


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
    monkeypatch.setattr(seg, "_stream", lambda t: 0)
    seg.reset_launch_counts()
    yield calls, lambda rc: state.__setitem__("rc", rc)
    seg.reset_launch_counts()


def _bwd_inputs(b, sq, sk, h, hk, d):
    g = torch.Generator().manual_seed(d)
    q, o, do = (torch.randn(b, sq, h, d, generator=g).bfloat16()
                for _ in range(3))
    k, v = (torch.randn(b, sk, hk, d, generator=g).bfloat16()
            for _ in range(2))
    lse = torch.zeros(b, h, sq)
    q_seg = torch.ones((b, sq), dtype=torch.int32)
    kv_seg = torch.ones((b, sk), dtype=torch.int32)
    return q, k, v, o, do, lse, q_seg, kv_seg


def _dims(args):
    return list((ctypes.c_int * 8).from_address(args[1].value))


@pytest.mark.parametrize("d", [64, 80, 128])
def test_segment_backward_launches_by_head_dim(fake_card, d):
    """segment_backward launches dq, then dk/dv, both on the Hopper entry
    points at every head dim (d 80 since the vision tower's K4 moved there),
    with the shapes in their dims and the sorted flag off; each launch
    counts on its route."""
    calls, _ = fake_card
    q, k, v, o, do, lse, q_seg, kv_seg = _bwd_inputs(2, 200, 150, 4, 2, d)
    seg.segment_backward(q, k, v, o, do, lse, q_seg, kv_seg, True, 0.1)
    hopper = d in seg.HOPPER_HEAD_DIMS
    lib = "attention_segment_hopper" if hopper else "attention_segment"
    assert [(n, e) for n, e, _ in calls] == [
        (lib, "visrag_segment_hopper_dq" if hopper
         else "visrag_segment_attention_bwd_dq"),
        (lib, "visrag_segment_hopper_dkv" if hopper
         else "visrag_segment_attention_bwd_dkv")]
    for _, _, args in calls:
        assert _dims(args) == [2, 200, 150, 4, 2, d, 1, 0]
    route = "hopper" if hopper else "legacy"
    assert seg.route_counts() == {
        "fwd": {"hopper": 0, "legacy": 0},
        "dq": {"hopper": int(hopper), "legacy": int(not hopper)},
        "dkv": {"hopper": int(hopper), "legacy": int(not hopper)}}
    assert seg.route_counts()["dq"][route] == seg.launch_counts()["seg_dq"]


def test_legacy_dq_counts_nothing(fake_card):
    """_launch_segment(..., legacy=True), the timing path, reaches the
    mma.sync dq at d 128 and counts no launch."""
    calls, _ = fake_card
    q, k, v, o, do, lse, q_seg, kv_seg = _bwd_inputs(1, 64, 64, 2, 2, 128)
    seg._launch_segment("dq", q, k, v, q_seg, kv_seg, False, 0.1, o=o,
                        do=do, dq=torch.empty_like(q), lse=lse,
                        delta=torch.empty_like(lse), legacy=True)
    assert [(n, e) for n, e, _ in calls] == [
        ("attention_segment", "visrag_segment_attention_bwd_dq")]
    assert seg.launch_counts()["seg_dq"] == 0
    assert seg.route_counts()["dq"] == {"hopper": 0, "legacy": 0}


def test_a_refused_dq_launch_raises(fake_card):
    """A refused tensor map (-1) or a launch error raises; no other kernel
    and no plain version runs instead, and nothing is counted."""
    calls, set_rc = fake_card
    q, k, v, o, do, lse, q_seg, kv_seg = _bwd_inputs(1, 64, 64, 2, 2, 64)
    for rc, words in ((-1, "tensor map"), (1, "CUDA error 1"),
                      (700, "CUDA error 700")):
        set_rc(rc)
        calls.clear()
        with pytest.raises(RuntimeError, match=words):
            seg.segment_bwd_dq(q, k, v, o, do, lse, torch.empty_like(lse),
                               q_seg, kv_seg, True, 0.1, torch.empty_like(q))
        assert [e for _, e, _ in calls] == ["visrag_segment_hopper_dq"]
    assert seg.launch_counts()["seg_dq"] == 0
    assert seg.route_counts()["dq"] == {"hopper": 0, "legacy": 0}


def test_cpu_tensors_take_the_plain_backward(monkeypatch):
    """flash_attention on CPU tensors loads no library, counts nothing, and
    its gradients are the written-out plain backward's (fp32, 1e-5)."""
    def no_library(name):
        raise AssertionError(f"library {name} loaded for CPU tensors")
    monkeypatch.setattr(_build, "load_library", no_library)
    seg.reset_launch_counts()
    rng = np.random.default_rng(7)
    q_seg = _ids(rng, 2, 150)
    kv_seg = q_seg.clone()
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 150, 4, 64, generator=g).requires_grad_(True)
    k, v = (torch.randn(2, 150, 2, 64, generator=g).requires_grad_(True)
            for _ in range(2))
    do = torch.randn(2, 150, 4, 64, generator=g)
    o = seg.flash_attention(q, k, v, q_seg, kv_seg, causal=True)
    got = torch.autograd.grad(o, (q, k, v), do)
    want = seg.segment_backward_reference(q.detach(), k.detach(), v.detach(),
                                          do, q_seg, kv_seg, True, 64 ** -0.5)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    pad = q_seg <= 0
    assert (got[0][pad] == 0).all()
    assert seg.launch_counts() == {"seg_fwd": 0, "seg_dq": 0, "seg_dkv": 0}
    assert seg.route_counts()["dq"] == {"hopper": 0, "legacy": 0}

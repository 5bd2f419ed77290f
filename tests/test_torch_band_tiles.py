"""K3's walk on the Hopper forward body, its routes, and the sorted-ids
walk of K3's backward, on the CPU.

The Hopper K3 (visrag_tpu_torch/csrc/attention_kvgrid_hopper.cu) finds each
128-row query tile's key band itself and classes the tile pairs in closed
form. Their plain versions (ops/attention_kvgrid.py `band_bounds`,
`band_tile_range_reference`, `band_pair_classes_reference`) are held here
against the JAX package's `_band_bounds` (exactly, at 128 x 128 and 64 x
64 tiles) and against the visibility mask, on ids that
`preprocess/qwen_vision` makes for small images and on edge ids; the
kernel's own search (`BandMask::locate`: one round of probes on either side
of the tile, then a 32-way search) is transcribed step by step and held to
`band_bounds`. The routes are checked with the library loader and the CUDA
calls replaced by stand-ins; chip_smoke.py holds the kernels themselves
against the plain versions on the card.
"""

import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_segment_tiles import _tiled_any_all
from visrag_tpu.ops.attention_kvgrid import _band_bounds
from visrag_tpu_torch.ops import _build
from visrag_tpu_torch.ops import attention as seg
from visrag_tpu_torch.ops import attention_kvgrid as kg
from visrag_tpu_torch.preprocess.qwen_vision import prepare_vision_batch


def _runs(sizes, pad=0):
    """Contiguous ascending ids 1..n over runs of `sizes`, then `pad`
    zeros."""
    ids = np.repeat(np.arange(1, len(sizes) + 1), sizes)
    return np.concatenate([ids, np.zeros(pad)]).astype(np.int32)


def _vision_ids():
    """seg_window and seg_full of two small images through the port's own
    preprocessing (windows of up to 64 patches, one segment per image)."""
    rng = np.random.default_rng(2)
    imgs = [Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))
            for h, w in ((196, 252), (140, 308))]
    vb = prepare_vision_batch(imgs, head_dim=80, min_pixels=28 * 28,
                              max_pixels=196 * 308)
    return {"window": np.asarray(vb.seg_window, np.int32),
            "full": np.asarray(vb.seg_full, np.int32)}


def _edge_ids():
    """Windows of 63/64/65 and 127/128/129 tokens straddling tile edges, one
    segment over all of S, a pad tail that fills whole tiles."""
    return {
        "63/64/65": _runs([63, 64, 65, 1, 64, 63, 65] * 3, pad=5),
        "127/128/129": _runs([127, 128, 129, 128, 1, 127, 129], pad=130),
        "one segment": _runs([700]),
        "whole pad tiles": _runs([200, 56, 128], pad=384),
        "one token": _runs([1]),
    }


def _cases():
    cases = {**{f"vision {k}": v for k, v in _vision_ids().items()},
             **_edge_ids()}
    return [(name, ids[None]) for name, ids in cases.items()] + [
        # a batch row of pad only, beside a real one
        ("pad row", np.stack([_runs([40, 90, 3], pad=123),
                              np.zeros(256, np.int32)]))]


CASES = _cases()


@pytest.mark.parametrize("bq,bk", [(128, 128), (64, 64)])
@pytest.mark.parametrize("name,ids", CASES, ids=[c[0] for c in CASES])
def test_band_tile_range_equals_the_jax_band_bounds(name, ids, bq, bk):
    """The kernel's walk in key tiles is the JAX kernel's band, exactly, on
    every query tile (an all-pad tile included)."""
    b, s = ids.shape
    sp = -(-s // max(bq, bk)) * max(bq, bk)
    padded = np.zeros((b, sp), np.int32)
    padded[:, :s] = ids
    jstart, jend = (np.asarray(x) for x in _band_bounds(
        jnp.asarray(padded), jnp.asarray(padded), bq, bk))
    first, last = kg.band_tile_range_reference(torch.from_numpy(ids), bq, bk)
    nq = -(-s // bq)
    assert first.shape == last.shape == (b, nq)
    np.testing.assert_array_equal(first.numpy(), jstart[:, :nq])
    np.testing.assert_array_equal(last.numpy(), jend[:, :nq])


@pytest.mark.parametrize("bq,bk", [(128, 128), (64, 64), (128, 64)])
@pytest.mark.parametrize("name,ids", CASES, ids=[c[0] for c in CASES])
def test_band_pair_classes_hold_every_visible_pair(name, ids, bq, bk):
    """No visible (query, key) pair lies in a SKIP tile pair, every
    UNMASKED pair is wholly visible, and the full layers' image-sized
    segments run almost all of their pairs unmasked."""
    t = torch.from_numpy(ids)
    vis = seg._visible(t, t, False)
    cls = kg.band_pair_classes_reference(t, bq, bk)
    any_vis, all_vis = _tiled_any_all(vis, bq, bk)
    assert cls.shape == any_vis.shape
    assert not (any_vis & (cls == seg.SKIP)).any()
    assert all_vis[cls == seg.UNMASKED].all()
    if name == "one segment":                 # 700 rows: every whole tile
        assert (cls == seg.UNMASKED).sum() == (700 // bq) * (700 // bk)


# ---- the kernel's search, transcribed ---------------------------------------


def _narrow(r, holds):
    """warp_narrow (csrc/hopper_attention_fwd.cuh): one round of 32 lanes."""
    lo, hi = r
    if lo >= hi:
        return r
    step = (hi - lo + 31) >> 5
    n = sum(1 for lane in range(32)
            if lo + lane * step < hi and holds(lo + lane * step))
    if n == 0:
        return lo, lo
    return lo + (n - 1) * step + 1, min(hi, lo + n * step)


def _locate(row, q0, probe=64, tile=128):
    """BandMask::locate (csrc/attention_kvgrid_hopper.cu) on one live tile:
    → ((start, end), the halves' bands ((start, end0), (start1, end)),
    whether each half holds one id, whether the second has a real row,
    search rounds)."""
    s = len(row)
    ids = [row[r] if r < s else 0 for r in range(q0, q0 + tile)]
    qid, hi, hi0 = ids[0], max(ids), max(ids[:tile // 2])
    lo1 = ids[tile // 2]
    real = sum(i > 0 for i in ids)
    uniform = (real >= tile // 2 and hi0 == qid, real == tile and lo1 == hi)
    back = [row[r] if r >= 0 else 0 for r in range(q0 - probe, q0)]
    ahead = [row[r] if r < s else 0
             for r in range(q0 + tile, q0 + tile + probe)]
    below = sum(x < qid for x in back)
    within = sum(0 < x <= hi for x in ahead)
    below1 = sum(x < lo1 for x in back + ids[:tile // 2])
    upto0 = sum(0 < x <= hi0 for x in ids)
    s_rng, e_rng = (0, 0), (0, 0)
    start = end = None
    if below > 0:
        start = q0 - probe + below
    else:
        s_rng = (0, q0 - probe)
    if real < tile:
        end = q0 + real
    elif within < probe:
        end = q0 + tile + within
    else:
        e_rng = (q0 + tile + probe, s)
    rounds = 0
    while s_rng[0] < s_rng[1] or e_rng[0] < e_rng[1]:
        s_rng = _narrow(s_rng, lambda j: row[j] < qid)
        e_rng = _narrow(e_rng, lambda j: 0 < row[j] <= hi)
        rounds += 1
    if start is None:
        start = s_rng[0]
    if end is None:
        end = e_rng[0]
    end0 = q0 + upto0 if upto0 < tile else end
    start1 = q0 - probe + below1 if below1 > 0 else start
    return (start, end), ((start, end0), (start1, end)), uniform, lo1 > 0, \
        rounds


def _pair(t, w, halves, uniform, live1, bk=128):
    """BandMask::pair: (the class, the 64-key halves taken) of key tile t
    for warpgroup w."""
    a, e = halves[w]
    k0 = t * bk
    taken = [h for h in (0, 1)
             if a < k0 + (h + 1) * bk // 2 and e > k0 + h * bk // 2]
    if (w and not live1) or not taken:
        return seg.SKIP, []
    ks, ke = k0 + taken[0] * bk // 2, k0 + (taken[-1] + 1) * bk // 2
    whole = uniform[w] and ks >= a and ke <= e
    return (seg.UNMASKED if whole else seg.MASKED), taken


def test_the_kernels_search_finds_the_band():
    """The transcribed search gives band_bounds' band on every live tile of
    every case and of seeded long rows (up to 17,668 keys, the tower's), and
    each consumer warpgroup's band that of its 64 rows; the walk's key tiles
    are the plain ones, and each warpgroup takes exactly the 64-key halves
    of a tile that meet its band, unmasked when all of them are
    (band_pair_classes_reference at 64 x 64 tiles); a window layer needs no
    search round past the probes, a full layer at most 3."""
    rng = np.random.default_rng(0)
    rows = [ids[0] for _, ids in CASES]
    for s, longest in ((17668, 64), (17668, 5000), (3000, 2000)):
        sizes = []
        while sum(sizes) < s:
            sizes.append(int(rng.integers(1, longest + 1)))
        rows.append(_runs(sizes)[:s - 37].tolist() + [0] * 37)
    for row in rows:
        row = np.asarray(row, np.int32)
        t = torch.from_numpy(row)[None]
        start, end = (x[0].tolist() for x in kg.band_bounds(t, 128))
        start64, end64 = (x[0].tolist() for x in kg.band_bounds(t, 64))
        classes = kg.band_pair_classes_reference(t)[0]
        halves64 = kg.band_pair_classes_reference(t, 64, 64)[0]
        windows = np.bincount(row[row > 0]).max() <= 64
        for qt in range(len(start)):
            if row[qt * 128] <= 0:
                assert end[qt] == 0          # a dead tile walks nothing
                continue
            (a, e), halves, uniform, live1, rounds = _locate(row, qt * 128)
            assert (a, e) == (start[qt], end[qt]), qt
            assert halves[0] == (start64[2 * qt], end64[2 * qt]), qt
            if live1:
                assert halves[1] == (start64[2 * qt + 1],
                                     end64[2 * qt + 1]), qt
            assert rounds <= (0 if windows else 3)
            walk = range(a // 128, -(-e // 128))
            assert list(walk) == [k for k in range(classes.shape[1])
                                  if classes[qt, k] != seg.SKIP]
            for w in (0, 1):
                r = 2 * qt + w
                for k in walk:
                    cls, taken = _pair(k, w, halves, uniform, live1)
                    want = [int(halves64[r, 2 * k + h])
                            if r < halves64.shape[0]
                            and 2 * k + h < halves64.shape[1] else seg.SKIP
                            for h in (0, 1)]
                    assert taken == [h for h in (0, 1)
                                     if want[h] != seg.SKIP], (qt, w, k)
                    assert (cls == seg.UNMASKED) == (bool(taken) and all(
                        want[h] == seg.UNMASKED for h in taken)), (qt, w, k)


# ---- the backward's sorted walk ---------------------------------------------


@pytest.mark.parametrize("name,ids", CASES, ids=[c[0] for c in CASES])
def test_sorted_walk_covers_every_visible_tile(name, ids):
    """The dq and dk/dv walks on sorted ids (sorted_walk_reference over the
    pre-pass's 64-row classes, both ways round) leave out no tile that
    holds a visible pair."""
    t = torch.from_numpy(ids)
    cls = seg.segment_tile_classes_reference(t, 64)
    first, end = seg.sorted_walk_reference(cls, cls)
    any_vis, _ = _tiled_any_all(seg._visible(t, t, False), 64, 64)
    tiles = torch.arange(cls.shape[1])
    walked = (tiles[None, None] >= first[..., None]) \
        & (tiles[None, None] < end[..., None])
    assert not (any_vis & ~walked).any()
    assert not (any_vis.transpose(1, 2) & ~walked).any()


def test_sorted_ids_give_the_same_plain_backward():
    """segment_backward_reference with sorted_ids (each chunk's keys from
    the sorted walk) equals the full one at the vision tower's ids, d 80,
    grouped and not, fp32 within 1e-5."""
    ids = _vision_ids()
    g = torch.Generator().manual_seed(4)
    for name, hk in (("window", 2), ("full", 1)):
        t = torch.from_numpy(ids[name])[None]
        s = t.shape[1]
        q, do = (torch.randn(1, s, 2, 80, generator=g) for _ in range(2))
        k, v = (torch.randn(1, s, hk, 80, generator=g) for _ in range(2))
        full = seg.segment_backward_reference(q, k, v, do, t, t, False,
                                              80 ** -0.5)
        band = seg.segment_backward_reference(q, k, v, do, t, t, False,
                                              80 ** -0.5, rows=128,
                                              sorted_ids=True)
        for a, b in zip(full, band):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---- the routes, with the card stood in for --------------------------------


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
    monkeypatch.setattr(kg, "_stream", lambda t: 0)
    monkeypatch.setattr(seg, "_stream", lambda t: 0)
    kg.reset_launch_counts()
    seg.reset_launch_counts()
    yield calls, lambda rc: state.__setitem__("rc", rc)
    kg.reset_launch_counts()
    seg.reset_launch_counts()


def _fused_qkv(s=300, h=16, d=80):
    """q, k, v as the vision block takes them: views of one (1, S, 3, H, D)
    bf16 tensor (row stride 3 H D), and its (1, S) ids."""
    qkv = torch.zeros((1, s, 3, h, d), dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    return q, k, v, torch.from_numpy(_runs([64] * (s // 64), s % 64))[None]


def test_k3_launches_the_hopper_kernel_on_fused_qkv_views(fake_card):
    """Every K3 launch reaches visrag_kvgrid_hopper_fwd with the views' dims
    and element strides (row stride 3 H D, head stride D) and scale *
    log2(e); counted by kind and route."""
    calls, _ = fake_card
    q, k, v, ids = _fused_qkv()
    with torch.no_grad():
        out = kg._on_card(q, k, v, ids, 80 ** -0.5)
    assert out.shape == q.shape and out.is_contiguous()
    [(lib, entry, args)] = calls
    assert (lib, entry) == ("attention_kvgrid_hopper",
                            "visrag_kvgrid_hopper_fwd")
    assert args[6:11] == (1, 300, 16, 16, 80)
    strides = args[11:23]
    assert strides[0:3] == (300 * 3 * 16 * 80, 3 * 16 * 80, 80)    # q
    assert strides[3:6] == strides[6:9] == strides[0:3]            # k, v
    assert strides[9:12] == (300 * 16 * 80, 16 * 80, 80)           # o
    assert args[2] - args[0] == 2 * 16 * 80 * 2                    # v's base
    assert args[23] == pytest.approx(80 ** -0.5 * kg.LOG2E)
    assert args[4] is None                                         # no LSE
    assert kg.launches == 1 and kg.lse_launches == 0
    assert kg.route_counts() == {"fwd": {"hopper": 1, "legacy": 0},
                                 "fwd_lse": {"hopper": 0, "legacy": 0}}


def test_k3_route_counts_with_and_without_the_lse(fake_card):
    """K3 on a (stood-in) card: without a gradient one launch on "fwd", with
    one a launch on "fwd_lse" whose backward runs K4's Hopper dq and dk/dv
    at d 80, told the ids are sorted."""
    calls, _ = fake_card
    q, k, v, ids = _fused_qkv(s=256)
    kg._on_card(q, k, v, ids, 80 ** -0.5)
    assert kg.launches == 1 and kg.lse_launches == 0
    assert kg.route_counts()["fwd"] == {"hopper": 1, "legacy": 0}
    calls.clear()
    qg, kg_, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    o = kg._on_card(qg, kg_, vg, ids, 80 ** -0.5)
    torch.autograd.grad(o, (qg, kg_, vg), torch.ones_like(o))
    assert kg.lse_launches == 1
    assert kg.route_counts() == {"fwd": {"hopper": 1, "legacy": 0},
                                 "fwd_lse": {"hopper": 1, "legacy": 0}}
    assert [(n, e) for n, e, _ in calls] == [
        ("attention_kvgrid_hopper", "visrag_kvgrid_hopper_fwd"),
        ("attention_segment_hopper", "visrag_segment_hopper_dq"),
        ("attention_segment_hopper", "visrag_segment_hopper_dkv")]
    assert calls[0][2][4] is not None                      # the LSE
    for _, _, args in calls[1:]:
        dims = list((ctypes.c_int * 8).from_address(args[1].value))
        assert dims == [1, 256, 256, 16, 16, 80, 0, 1]     # sorted ids
    assert seg.route_counts()["dq"] == {"hopper": 1, "legacy": 0}
    assert seg.route_counts()["dkv"] == {"hopper": 1, "legacy": 0}


def test_legacy_k3_reaches_the_first_kernel_and_counts_nothing(fake_card):
    """_launch(..., legacy=True), the timing path, reaches the first
    kernel's visrag_kvgrid_attention_fwd with the same arguments and counts no
    launch; a refused tensor map or launch raises, with no other kernel and
    no plain version instead."""
    calls, set_rc = fake_card
    q, k, v, ids = _fused_qkv(s=200)
    kg._launch(q, k, v, ids, 0.1, legacy=True)
    [(lib, entry, args)] = calls
    assert (lib, entry) == ("attention_kvgrid", "visrag_kvgrid_attention_fwd")
    assert args[6:11] == (1, 200, 16, 16, 80)
    assert kg.launches == kg.lse_launches == 0
    assert kg.route_counts()["fwd"] == {"hopper": 0, "legacy": 0}
    assert kg._route() == ("attention_kvgrid_hopper",
                           "visrag_kvgrid_hopper_fwd")
    for rc, words in ((-1, "tensor map"), (700, "CUDA error 700")):
        set_rc(rc)
        calls.clear()
        with pytest.raises(RuntimeError, match=words):
            kg._launch(q, k, v, ids, 0.1)
        assert [e for _, e, _ in calls] == ["visrag_kvgrid_hopper_fwd"]


def test_k3_refuses_what_the_kernel_does_not_take(fake_card):
    """Head dims other than 80, fp32, and ids that are not contiguous (B, S)
    int32 raise before any launch."""
    calls, _ = fake_card
    q, k, v, ids = _fused_qkv(s=128)
    with pytest.raises(ValueError, match="head_dim"):
        kg._launch(q[..., :64], k[..., :64], v[..., :64], ids, 0.1)
    with pytest.raises(TypeError, match="bfloat16"):
        kg._launch(q.float(), k.float(), v.float(), ids, 0.1)
    with pytest.raises(ValueError, match="int32"):
        kg._launch(q, k, v, ids.long(), 0.1)
    assert calls == []

"""K5's schedule and routes on the CPU.

`split_bounds` and `paged_decode_schedule_reference`
(visrag_tpu_torch/serving/paged_kv.py) are the plain mirror of the paged
decode kernel's schedule (csrc/paged_decode_hopper.cu): the grid's split
count from shapes alone (`split_plan`), each block's equal share of its
slot's 64-token tiles read from the length on the device, each warp's
16-token sub-tiles of that share, every token read through its own table
entry, and the last block's merge of the splits' (m, l, acc). A token
covered twice, or one at or past the length, would change the result; the
sweeps below check neither happens, at every block size the engines pick
and at the edge lengths, and that the per-split partials and their merge
equal the plain version (fp32 pools: 1e-5 absolute and relative, the
rounding of two fp32 orders of summation). The routes are checked with the
library loader and the CUDA calls replaced by stand-ins, so no card is
needed; chip_smoke.py and tools/torch_check_paged.py hold the kernel itself
against the plain version on the card.
"""

import contextlib
import math
import types

import pytest
import torch

from visrag_tpu_torch.ops import _build
from visrag_tpu_torch.serving import paged_kv as pk

SLOTS, TABLE = 8, 2067          # the 3B rollout engine's table (bs 8)
SUB, WARPS = 16, 4              # the kernel's warp sub-tile and warps a block


def _lengths(bs):
    return [0, 1, bs, bs + 1, 650, 16536, 15064, 4096]


def _warp_tokens(lo, hi):
    """The tokens the kernel's warps take in a split [lo, hi): warp w reads
    16-token sub-tiles from lo + 16 w every 64 tokens, cut at hi (the
    kernel's `first`, `nk` and its masked rows)."""
    out = []
    for w in range(WARPS):
        first = lo + w * SUB
        nk = -(-(hi - first) // pk.TILE) if first < hi else 0
        for k in range(nk):
            t0 = first + k * pk.TILE
            out.extend(range(t0, min(t0 + SUB, hi)))
    return out


def _clusters(per_sm, sms=132):
    """Clusters of 1..MAX_SPLITS blocks a card of `sms` SMs holds at
    `per_sm` blocks an SM (the occupancy query's answer, GPC limits aside)."""
    return tuple(sms * per_sm // c for c in range(1, pk.MAX_SPLITS + 1))


@pytest.mark.parametrize("bs", [1, 8, 16, 128])
def test_split_bounds_cover_every_valid_token_once(bs):
    """Every token below the length (clamped to the table's capacity) is
    taken by exactly one warp of one split, none at or past it, each split
    starting on a tile edge; at every split count the plan can give and at
    a few it cannot."""
    lens = _lengths(bs)
    cap = TABLE * bs
    counts = {pk.split_plan(SLOTS, kvh, TABLE, bs, _clusters(per))
              for kvh in (2, 4, 36) for per in (1, 2, 3, 6)}
    for splits in sorted(counts | {1, 2, 5, 17, 128}):
        bounds = pk.split_bounds(torch.tensor(lens, dtype=torch.int32),
                                 TABLE, bs, splits)
        assert bounds.shape == (SLOTS, splits, 2)
        for i, n in enumerate(lens):
            valid = min(n, cap)
            taken = []
            for lo, hi in bounds[i].tolist():
                assert lo % pk.TILE == 0 and lo <= hi <= valid
                taken += _warp_tokens(lo, hi)
            assert sorted(taken) == list(range(valid)), (splits, n)


def test_split_plan_depends_on_shapes_only():
    """The split count is the largest cluster size (at most MAX_SPLITS and
    one split a tile of the table) whose slots x kv heads clusters the card
    holds at once, else 1; the 7B decode shape (4 slots, 4 kv heads, a
    64-block table of 128 tokens) at 2 blocks an SM gives 16 splits, and at
    its lengths 236 of the 256 blocks hold work, against the first kernel's
    128 of 256; MiniCPM-2B's 4 x 36 pairs at 3 blocks an SM give 2."""
    for slots, kvh, mb, bs in ((4, 4, 64, 128), (8, 2, 2067, 8),
                               (4, 36, 64, 64), (1, 1, 1, 1), (4, 4, 1, 16)):
        tiles = -(-mb * bs // pk.TILE)
        for per in (1, 2, 3, 6):
            clusters = _clusters(per)
            n = pk.split_plan(slots, kvh, mb, bs, clusters)
            assert 1 <= n <= min(pk.MAX_SPLITS, tiles)
            assert n == 1 or slots * kvh <= clusters[n - 1]
            bigger = range(n + 1, min(pk.MAX_SPLITS, tiles) + 1)
            assert all(slots * kvh > clusters[c - 1] for c in bigger)
    assert pk.split_plan(4, 36, 64, 128, _clusters(3)) == 2
    assert pk.split_plan(8, 2, 2067, 8, _clusters(2)) == 16
    splits = pk.split_plan(4, 4, 64, 128, _clusters(2))
    assert splits == 16
    bounds = pk.split_bounds(torch.tensor([4815, 4643, 4879, 650]), 64, 128,
                             splits)
    busy = int((bounds[..., 1] > bounds[..., 0]).sum()) * 4
    assert (busy, splits * 4 * 4) == (236, 256)


def _case(seed, slots, h, kvh, d, bs, mb, lens):
    g = torch.Generator().manual_seed(seed)
    nb = slots * mb + 1
    kp = torch.randn(nb, kvh, bs, d, generator=g)
    vp = torch.randn(nb, kvh, bs, d, generator=g)
    table = torch.randperm(nb - 1, generator=g)[:slots * mb] \
        .reshape(slots, mb).int()
    q = torch.randn(slots, h, d, generator=g)
    return q, kp, vp, table, torch.tensor(lens, dtype=torch.int32)


@pytest.mark.parametrize("bs,rep", [(1, 1), (8, 8), (16, 7), (128, 3)])
def test_split_partials_and_merge_match_reference(bs, rep):
    """Each split's (m, l, acc) equals the max, sum and weighted sum of the
    plain version's scores over that split's tokens, and the merge equals
    paged_decode_reference, at several split counts (fp32: 1e-5)."""
    kvh, d = 2, 16
    mb = max(1, 700 // bs + 2)
    lens = [1, bs, bs + 1, min(650, mb * bs)]
    q, kp, vp, table, lengths = _case(bs + rep, 4, rep * kvh, kvh, d, bs, mb,
                                      lens)
    scale = d ** -0.5
    ref = pk.paged_decode_reference(q, kp, vp, table, lengths, scale)
    kg, _ = pk._gather_heads(kp, table.long())
    vg, _ = pk._gather_heads(vp, table.long())
    scores = torch.einsum("sgrd,sgld->sgrl", q.reshape(4, kvh, rep, d),
                          kg) * scale
    for splits in (1, 3, 11):
        out, m, l, acc = pk.paged_decode_schedule_reference(
            q, kp, vp, table, lengths, scale, splits)
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
        bounds = pk.split_bounds(lengths, mb, bs, splits)
        for i in range(4):
            for j, (lo, hi) in enumerate(bounds[i].tolist()):
                if hi <= lo:
                    assert (m[i, :, j] == -math.inf).all()
                    assert (l[i, :, j] == 0).all()
                    continue
                sc = scores[i, :, :, lo:hi]
                mj = sc.amax(-1)
                p = torch.exp(sc - mj[..., None])
                torch.testing.assert_close(m[i, :, j], mj)
                torch.testing.assert_close(l[i, :, j], p.sum(-1), atol=1e-5,
                                           rtol=1e-5)
                torch.testing.assert_close(
                    acc[i, :, j], torch.einsum("grl,gld->grd", p,
                                               vg[i, :, lo:hi]),
                    atol=1e-5, rtol=1e-5)


# ---- the wrapper's routes, with stand-ins for the library -------------------


class _FakeLibrary:
    """Stands in for a built library: every entry point records its
    arguments and returns state["rc"] (the occupancy query: 264 blocks
    in clusters of the size asked)."""

    def __init__(self, name, calls, state):
        self.name, self.calls, self.state = name, calls, state

    def __getattr__(self, entry):
        def fn(*args):
            self.calls.append((self.name, entry, args))
            if entry.endswith("_clusters"):
                return 264 // args[2]
            return self.state["rc"]
        return fn


@pytest.fixture
def fake_card(monkeypatch):
    calls, state = [], {"rc": 0}
    monkeypatch.setattr(_build, "load_library",
                        lambda name: _FakeLibrary(name, calls, state))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    for cached in (pk._hopper_fn, pk._legacy_fn, pk._occupancy):
        cached.cache_clear()
    pk.reset_launch_counts()
    yield calls, lambda rc: state.__setitem__("rc", rc)
    for cached in (pk._hopper_fn, pk._legacy_fn, pk._occupancy):
        cached.cache_clear()
    pk.reset_launch_counts()


class _NoHostRead(torch.Tensor):
    """A tensor whose values the host may not read (item, tolist, numpy,
    bool, int): the kernel reads the lengths on the device."""

    @classmethod
    def __torch_function__(cls, func, types_, args=(), kwargs=None):
        if func in (torch.Tensor.item, torch.Tensor.tolist,
                    torch.Tensor.numpy, torch.Tensor.__bool__,
                    torch.Tensor.__int__, torch.Tensor.__index__):
            raise AssertionError(f"host read of the lengths: {func}")
        return super().__torch_function__(func, types_, args, kwargs or {})


def _pools(quant, nb, kvh, bs, d):
    if quant:
        return tuple(pk.KVQuant(torch.zeros(nb, kvh, bs, d, dtype=torch.int8),
                                torch.ones(nb, kvh, bs)) for _ in range(2))
    return tuple(torch.zeros(nb, kvh, bs, d, dtype=torch.bfloat16)
                 for _ in range(2))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("h,kvh,d,bs,mb", [(28, 4, 128, 128, 64),
                                           (16, 2, 128, 8, 2067),
                                           (36, 36, 64, 8, 512),
                                           (6, 2, 64, 1, 40)])
def test_every_launch_takes_the_new_kernel(fake_card, quant, h, kvh, d, bs,
                                           mb):
    """One launch of visrag_paged_decode_hopper a call, with the plan's
    split count (from the cluster occupancy, queried once) and the shapes
    as given, no scratch; counted in launches or int8_launches, never in
    legacy_launches; the lengths never read on the host."""
    calls, _ = fake_card
    slots = 4
    q = torch.zeros(slots, h, d, dtype=torch.bfloat16)
    table = torch.zeros(slots, mb, dtype=torch.int32)
    lengths = torch.ones(slots, dtype=torch.int32).as_subclass(_NoHostRead)
    kp, vp = _pools(quant, 3, kvh, bs, d)
    for _ in range(2):
        o = pk._launch(q, kp, vp, table, lengths, 0.125)
        assert o.shape == q.shape and o.dtype == torch.bfloat16
    launches = [c for c in calls if c[1] == "visrag_paged_decode_hopper"]
    queries = [c for c in calls
               if c[1] == "visrag_paged_decode_hopper_clusters"]
    assert len(launches) == 2
    assert [a for _, _, a in queries] == [
        (d, int(quant), c) for c in range(1, pk.MAX_SPLITS + 1)]
    splits = pk.split_plan(slots, kvh, mb, bs,
                           tuple(264 // c for c in range(1, 17)))
    for name, _, args in launches:
        assert name == "paged_decode_hopper" and len(args) == 17
        assert args[8:15] == (slots, h, kvh, d, bs, mb, splits)
        assert (args[3] is None) != quant          # the k scales
        assert args[15] == 0.125 and args[16] == 7
    assert (pk.launches, pk.int8_launches, pk.legacy_launches) == \
        ((0, 2, 0) if quant else (2, 0, 0))
    assert pk._hopper_fn() is pk._hopper_fn()    # the signature, set once


def test_legacy_reaches_the_first_kernel_only(fake_card):
    calls, _ = fake_card
    q = torch.zeros(4, 28, 128, dtype=torch.bfloat16)
    table = torch.zeros(4, 64, dtype=torch.int32)
    lengths = torch.ones(4, dtype=torch.int32)
    for quant in (False, True):
        kp, vp = _pools(quant, 3, 4, 128, 128)
        pk._launch(q, kp, vp, table, lengths, 0.1, legacy=True)
    assert [(n, e) for n, e, _ in calls] == [
        ("paged_decode", "visrag_paged_decode")] * 2
    assert (pk.launches, pk.int8_launches, pk.legacy_launches) == (0, 0, 2)
    kp, vp = _pools(False, 3, 2, 8, 128)      # bs 8: not the first kernel's
    with pytest.raises(ValueError, match="legacy"):
        pk._launch(torch.zeros(4, 16, 128, dtype=torch.bfloat16), kp, vp,
                   table, lengths, 0.1, legacy=True)


@pytest.mark.parametrize("what", ["d80", "bs256", "rep9", "fp32 q",
                                  "int64 table", "launch error"])
def test_a_refused_call_raises(fake_card, what):
    """What the kernel does not take raises, before any launch, and a
    failed launch raises; nothing runs the plain version instead."""
    calls, set_rc = fake_card
    h, kvh, d, bs = 28, 4, 128, 128
    if what == "d80":
        d = 80
    elif what == "bs256":
        bs = 256
    elif what == "rep9":
        h, kvh = 18, 2
    q = torch.zeros(2, h, d, dtype=torch.float32 if what == "fp32 q"
                    else torch.bfloat16)
    table = torch.zeros(2, 4, dtype=torch.int64 if what == "int64 table"
                        else torch.int32)
    kp, vp = _pools(False, 3, kvh, bs, d)
    if what == "launch error":
        set_rc(1)
    with pytest.raises((ValueError, RuntimeError)):
        pk._launch(q, kp, vp, table, torch.ones(2, dtype=torch.int32), 0.1)
    assert all(e != "visrag_paged_decode_hopper" for _, e, _ in calls) \
        or what == "launch error"
    assert pk.launches == pk.int8_launches == pk.legacy_launches == 0


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_library(name):
        raise AssertionError(f"library {name} loaded for CPU tensors")
    monkeypatch.setattr(_build, "load_library", no_library)
    pk.reset_launch_counts()
    q, kp, vp, table, lengths = _case(0, 2, 4, 2, 16, 8, 6, [3, 40])
    for legacy in (False, True):
        got = pk.paged_decode_attention(q, kp, vp, table, lengths,
                                        legacy=legacy)
        torch.testing.assert_close(got, pk.paged_decode_reference(
            q, kp, vp, table, lengths, 0.25))
    assert pk.launches == pk.int8_launches == pk.legacy_launches == 0

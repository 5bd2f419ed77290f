"""The tile classes of K4's wgmma kernels, and the router between K4's two
CUDA sources, on the CPU.

`segment_tile_classes_reference` and `segment_pair_classes_reference`
(visrag_tpu_torch/ops/attention.py) are the plain versions of the kernels'
pre-pass and of their per-pair test: a (query tile, key tile) pair is
skipped, run without a mask, or masked per element. Skipping a pair that
holds a visible (query, key) element, or running a pair without its mask
that holds an invisible one, would change the result; a seeded sweep over
packed rows (non-ascending runs, pads, negative ids, all-pad rows, Sq != Sk,
lengths off the tile size, causal and not) checks that neither happens at
the kernels' tile sizes. No card is needed; the card's pre-pass is held
against the same reference in chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from visrag_tpu_torch.ops import attention as seg

TILE_SIZES = [(128, 128), (64, 64), (64, 128)]   # fwd, dq and dk/dv, mixed


def _row(rng, width):
    """One row of ids: contiguous runs with ids in no order, runs of pad (0)
    and negative ids, sometimes nothing but pad."""
    if rng.random() < 0.1:
        return np.zeros(width, np.int32)
    row = np.zeros(width, np.int32)
    at = 0
    while at < width:
        n = int(rng.choice([1, 5, 63, 64, 65, 127, 128, 129, 200, 300]))
        kind = rng.random()
        val = 0 if kind < 0.15 else -int(rng.integers(1, 4)) if kind < 0.25 \
            else int(rng.integers(1, 6))
        row[at:at + n] = val
        at += n
    return row


def _ids(rng, b, width):
    return torch.from_numpy(np.stack([_row(rng, width) for _ in range(b)]))


def _tiled_any_all(vis, bq, bk):
    """(B, Sq, Sk) bool → per (query tile, key tile): any visible, all
    visible (cells past Sq or Sk count as not visible)."""
    b, sq, sk = vis.shape
    nq, nk = -(-sq // bq), -(-sk // bk)
    pad = torch.zeros((b, nq * bq, nk * bk), dtype=torch.bool)
    pad[:, :sq, :sk] = vis
    t = pad.reshape(b, nq, bq, nk, bk)
    return t.any(-1).any(2), t.all(-1).all(2)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("causal", [False, True])
def test_pair_classes_are_exact(seed, causal):
    """No skipped pair holds a visible element; every unmasked pair is
    wholly visible; at each tile size, on rows with and without Sq == Sk."""
    rng = np.random.default_rng(seed)
    b = 3
    sq = int(rng.integers(1, 700))
    sk = sq if seed % 2 == 0 else int(rng.integers(1, 700))
    q_seg = _ids(rng, b, sq)
    kv_seg = q_seg.clone() if sk == sq and rng.random() < 0.7 \
        else _ids(rng, b, sk)
    vis = seg._visible(q_seg, kv_seg, causal)
    for bq, bk in TILE_SIZES:
        cls = seg.segment_pair_classes_reference(
            seg.segment_tile_classes_reference(q_seg, bq),
            seg.segment_tile_classes_reference(kv_seg, bk), bq, bk, causal)
        any_vis, all_vis = _tiled_any_all(vis, bq, bk)
        assert not (any_vis & (cls == seg.SKIP)).any(), (bq, bk)
        assert (all_vis[cls == seg.UNMASKED]).all(), (bq, bk)


def test_uniform_segment_runs_unmasked():
    """One segment filling whole 128-row tiles: every pair below the
    diagonal runs without a mask, the diagonal is masked, above is skipped;
    a tile that runs past the row's end, or holds one pad row, is masked."""
    ids = torch.full((1, 640), 3, dtype=torch.int32)
    tiles = seg.segment_tile_classes_reference(ids, 128)
    assert tiles[0].tolist() == [[3, 3, 1]] * 5
    cls = seg.segment_pair_classes_reference(tiles, tiles, 128, 128, True)[0]
    want = torch.tensor([[1 if i == j else 2 if j < i else 0
                          for j in range(5)] for i in range(5)])
    assert torch.equal(cls, want.to(torch.int32))
    ragged = torch.full((1, 700), 3, dtype=torch.int32)
    ragged[0, 300] = 0
    tiles = seg.segment_tile_classes_reference(ragged, 128)
    assert tiles[0, :, 2].tolist() == [1, 1, 0, 1, 1, 0]
    assert tiles[0, 5].tolist() == [3, 3, 0]          # rows 640-699 of 768


def test_tile_classes_ranges():
    """(lo, hi) of the positive ids per tile, (2**31 - 1, 0) for a tile of
    pad and negative ids only; 127 / 128 / 129-token segments."""
    ids = torch.zeros((1, 500), dtype=torch.int32)
    ids[0, :127], ids[0, 127:255], ids[0, 255:384] = 4, 6, 8
    ids[0, 384:450] = -2
    tiles = seg.segment_tile_classes_reference(ids, 128)[0].tolist()
    big = torch.iinfo(torch.int32).max
    assert tiles == [[4, 6, 0], [6, 8, 0], [8, 8, 1], [big, 0, 0]]


@pytest.mark.parametrize("d", [64, 80, 128])
def test_router_sends_64_and_128_to_the_wgmma_kernels(d):
    """d 64 / 128 (the LMs) and, since the vision tower's K4 moved onto the
    Hopper bodies, d 80: every kernel on the wgmma source."""
    for kind in ("fwd", "dq", "dkv"):
        lib, entry, tiles = seg._route(kind, d)
        assert lib == "attention_segment_hopper"
        assert entry == f"visrag_segment_hopper_{kind}"
        assert tiles == seg.HOPPER_TILES[kind]
        # the private switch reaches the mma.sync kernel at the same d
        assert seg._route(kind, d, legacy=True)[0] == "attention_segment"
    # dq classes its 128-row blocks by 64-row halves: dk/dv's classes
    assert seg.HOPPER_TILES["dq"] == seg.HOPPER_TILES["dkv"] == (64, 64)


def test_router_keeps_80_on_the_mma_sync_kernels():
    """d 80 keeps the mma.sync kernels only behind `legacy=True` (the
    timing path); by default it reaches the Hopper entry points."""
    for kind in ("fwd", "dq", "dkv"):
        lib, entry, tiles = seg._route(kind, 80, legacy=True)
        assert lib == "attention_segment"
        assert entry.startswith("visrag_segment_attention_")
        assert tiles == seg.LEGACY_TILES
        assert seg._route(kind, 80) == ("attention_segment_hopper",
                                        f"visrag_segment_hopper_{kind}",
                                        seg.HOPPER_TILES[kind])


def test_tile_classes_wrapper_on_cpu_is_the_reference():
    ids = torch.tensor([[2] * 100 + [0] * 28 + [5] * 130], dtype=torch.int32)
    assert torch.equal(seg.segment_tile_classes(ids, 128),
                       seg.segment_tile_classes_reference(ids, 128))

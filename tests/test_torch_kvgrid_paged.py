"""The serving slice's attention against the JAX package's kernels.

K3 (banded segment attention), K5 (paged decode) and K1's grouped-query
d = 128 form: the port's plain PyTorch versions (what a CPU tensor runs)
against the Pallas kernels in interpret mode and the JAX XLA paths, with
inputs from numpy at fixed seeds; also the chunked-prefill attention and
the band bounds. fp32 unless a kernel feeds bf16 operands by design. The
tests marked `gpu` hold the CUDA kernels against the plain versions on a
card and skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visrag_tpu.ops.attention import flash_attention, mha_reference
from visrag_tpu.ops.attention import xla_chunk_attention
from visrag_tpu.ops.attention_kvgrid import (_band_bounds,
                                             flash_attention_kvgrid as jkv)
from visrag_tpu.serving.paged_kv import (_xla_paged_decode,
                                         paged_decode_attention as jpaged)
from visrag_tpu_torch.ops import attention_kvgrid as kg
from visrag_tpu_torch.ops import attention_lengths as al
from visrag_tpu_torch.ops.attention import (chunk_attention,
                                            chunk_attention_reference,
                                            segment_attention_reference)
from visrag_tpu_torch.serving import paged_kv as pk


def _contig_segs(rng, total, max_len, pad):
    """Contiguous ascending ids 1..n with sizes <= max_len, then `pad`
    zeros (as tests/test_attention_kvgrid.py builds them)."""
    sizes, left = [], total
    while left > 0:
        s = min(int(rng.integers(1, max_len + 1)), left)
        sizes.append(s)
        left -= s
    seg = np.repeat(np.arange(1, len(sizes) + 1), sizes)
    return np.concatenate([seg, np.zeros(pad, np.int32)]).astype(np.int32)


def _qkv(rng, b, s, h, d, hk=None):
    hk = hk or h
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, hk, d)).astype(np.float32),
            rng.standard_normal((b, s, hk, d)).astype(np.float32))


def _check_kvgrid(q, k, v, seg_b, want, full_pad_tiles=128):
    """Port plain K3 vs a JAX output: 1e-5 on real rows, the port's pad rows
    exactly 0, and the JAX kernel's all-pad tiles exactly 0 too."""
    got = kg.flash_attention_kvgrid(*(torch.from_numpy(x) for x in (q, k, v)),
                                    torch.from_numpy(seg_b)).numpy()
    want = np.asarray(want)
    real = seg_b > 0
    np.testing.assert_allclose(got[real], want[real], atol=1e-5, rtol=1e-5)
    assert (got[~real] == 0).all()
    s = seg_b.shape[1]
    for i in range(s // full_pad_tiles):
        tile = slice(i * full_pad_tiles, (i + 1) * full_pad_tiles)
        if not real[:, tile].any():
            assert (want[:, tile] == 0).all()


@pytest.mark.parametrize("max_seg_len", [17, 64, None])
def test_kvgrid_plain_matches_pallas_interpret(max_seg_len):
    rng = np.random.default_rng(1)
    seg = _contig_segs(rng, 530, max_seg_len or 200, 110)
    q, k, v = _qkv(rng, 1, len(seg), 2, 32)
    want = jkv(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(seg)[None],
               max_seg_len=max_seg_len, block_q=128, block_k=128,
               interpret=True)
    _check_kvgrid(q, k, v, seg[None], want)


def test_kvgrid_plain_vision_geometry():
    """The window and per-image segment ids of a real two-image batch."""
    from PIL import Image

    from visrag_tpu_torch.preprocess.qwen_vision import prepare_vision_batch
    rng = np.random.default_rng(2)
    imgs = [Image.fromarray(rng.integers(0, 255, (252, 308, 3), np.uint8)),
            Image.fromarray(rng.integers(0, 255, (140, 196, 3), np.uint8))]
    vb = prepare_vision_batch(imgs, head_dim=32, min_pixels=56 * 56,
                              max_pixels=252 * 308, pad_to=640)
    q, k, v = _qkv(rng, 1, vb.patches.shape[0], 2, 32)
    for seg, msl in ((vb.seg_window, 64), (vb.seg_full, None)):
        want = jkv(*(jnp.asarray(x) for x in (q, k, v)),
                   jnp.asarray(seg)[None], max_seg_len=msl, block_q=128,
                   block_k=128, interpret=True)
        _check_kvgrid(q, k, v, seg[None], want)


def test_kvgrid_plain_gqa_uneven_seq():
    rng = np.random.default_rng(4)
    seg = _contig_segs(rng, 200, 30, 51)        # 251 rows: not a tile multiple
    b = 2
    q, k, v = _qkv(rng, b, len(seg), 4, 16, hk=2)
    segb = np.broadcast_to(seg, (b, len(seg))).copy()
    want = jkv(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(segb),
               max_seg_len=30, block_q=128, block_k=128, interpret=True)
    _check_kvgrid(q, k, v, segb, want)


def test_band_bounds_cover_the_jax_bands():
    """The port's per-tile key ranges are exact: every key a tile's real
    rows can see lies inside, and they sit inside the JAX kernel's block
    bands at the same tile size."""
    rng = np.random.default_rng(0)
    for _ in range(6):
        seg = _contig_segs(rng, int(rng.integers(100, 900)),
                           int(rng.integers(5, 90)), int(rng.integers(0, 300)))
        s = len(seg)
        sp = -(-s // 128) * 128
        seg_p = np.concatenate([seg, np.full(sp - s, -1, np.int32)])
        jstart, jend = (np.asarray(x)[0] for x in _band_bounds(
            jnp.asarray(seg_p)[None], jnp.asarray(seg_p)[None], 128, 128))
        start, end = (x[0].numpy() for x in kg.band_bounds(
            torch.from_numpy(seg)[None], 128))
        for i in range(len(start)):
            ids = seg[i * 128:(i + 1) * 128]
            ids = ids[ids > 0]
            if not len(ids):
                assert start[i] == end[i] == 0
                continue
            need = np.nonzero(np.isin(seg, ids))[0]
            assert start[i] == need.min() and end[i] == need.max() + 1
            assert jstart[i] * 128 <= start[i] and end[i] <= jend[i] * 128


def test_segment_reference_matches_jax():
    rng = np.random.default_rng(6)
    seg = _contig_segs(rng, 90, 20, 6)[None]
    q, k, v = _qkv(rng, 1, seg.shape[1], 4, 16, hk=2)
    for causal in (False, True):
        want = mha_reference(*(jnp.asarray(x) for x in (q, k, v)),
                             jnp.asarray(seg), jnp.asarray(seg),
                             causal=causal)
        got = segment_attention_reference(
            *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(seg),
            torch.from_numpy(seg), causal=causal)
        # ids <= 0 match nothing in the port (exact zeros); the JAX oracle
        # lets id-0 rows attend id-0 keys
        real = seg > 0
        np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                                   atol=1e-5, rtol=1e-5)
        assert (got.numpy()[~real] == 0).all()


def test_lengths_gqa_d128_matches_pallas_interpret():
    """K1's plain version with 28/4-style grouped kv heads at d = 128
    against the JAX flash attention (lengths, causal) in interpret mode,
    which repeats K/V itself; valid rows, 2e-4."""
    rng = np.random.default_rng(8)
    b, s, h, hk, d = 3, 128, 7, 1, 128
    q, k, v = _qkv(rng, b, s, h, d, hk=hk)
    lens = np.array([128, 65, 1], np.int32)
    want = flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                           lengths=jnp.asarray(lens), causal=True,
                           interpret=True, block_q=64, block_k=64)
    got = al.flash_fwd_lengths(*(torch.from_numpy(x) for x in (q, k, v)),
                               torch.from_numpy(lens), True, d ** -0.5)
    valid = np.arange(s)[None] < lens[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=2e-4, rtol=2e-4)


def test_lengths_wrapper_shapes():
    x = torch.zeros(2, 8, 4, 16)
    kv = torch.zeros(2, 8, 2, 16)
    assert al.flash_fwd_lengths(x, kv, kv, torch.tensor([8, 3]), True,
                                0.25).shape == x.shape
    with pytest.raises(ValueError):        # 3 kv heads do not divide 4
        al.flash_fwd_lengths(x, x[:, :, :3], x[:, :, :3],
                             torch.tensor([8, 3]), True, 0.25)


def _pool_case(rng, slots, h, kvh, d, bs, mb, lengths, dtype=np.float32):
    """A shuffled head-major pool holding each slot's dense cache, table
    entries past the length on a null block."""
    n_blocks = slots * mb + 1
    kp = rng.standard_normal((n_blocks, kvh, bs, d)).astype(dtype)
    vp = rng.standard_normal((n_blocks, kvh, bs, d)).astype(dtype)
    perm = rng.permutation(n_blocks - 1)[:slots * mb].reshape(slots, mb)
    table = np.full((slots, mb), n_blocks - 1, np.int32)
    for i, n in enumerate(lengths):
        used = -(-n // bs)
        table[i, :used] = perm[i, :used]
    q = rng.standard_normal((slots, h, d)).astype(dtype)
    return q, kp, vp, table, np.asarray(lengths, np.int32)


def test_paged_plain_matches_jax():
    """The plain version against the JAX XLA path (fp32, 1e-5) and against
    the Pallas kernel in interpret mode, which feeds the matrix unit bf16
    operands (2e-2 / 8e-3, the JAX test's own bar)."""
    rng = np.random.default_rng(0)
    q, kp, vp, table, lens = _pool_case(rng, 3, 8, 2, 64, 128, 4,
                                        [5, 300, 512])
    got = pk.paged_decode_attention(*(torch.from_numpy(x) for x in
                                      (q, kp, vp, table, lens))).numpy()
    args = [jnp.asarray(x) for x in (q, kp, vp, table, lens)]
    np.testing.assert_allclose(got, np.asarray(_xla_paged_decode(
        *args, 1.0 / np.sqrt(64))), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jpaged(*args, interpret=True)),
                               rtol=2e-2, atol=8e-3)


def test_paged_plain_matches_jax_bf16_gqa7():
    """bf16 pools with 7 query heads per kv head (the 7B's grouping),
    lengths 1, bs and bs + 1."""
    rng = np.random.default_rng(1)
    q, kp, vp, table, lens = _pool_case(rng, 3, 14, 2, 32, 16, 3,
                                        [1, 16, 17])
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, kp, vp))
    got = pk.paged_decode_attention(tq, tk, tv, torch.from_numpy(table),
                                    torch.from_numpy(lens)).float().numpy()
    jargs = [jnp.asarray(x, jnp.bfloat16) for x in (q, kp, vp)]
    want = _xla_paged_decode(*jargs, jnp.asarray(table), jnp.asarray(lens),
                             1.0 / np.sqrt(32))
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("lengths", [(1, 8, 9, 300), (5, 150, 301)])
def test_paged_plain_matches_jax_minicpm_grouping_bs8(lengths, dtype):
    """MiniCPM-2B's grouping (one query head a kv head, d = 64; 6/6 heads
    here) on 8-token pool blocks, the block size the engines take for the
    RL rollout: the plain version against the JAX XLA path and the Pallas
    kernel in interpret mode, on shared inputs. fp32: 1e-5 against XLA,
    2e-2 / 8e-3 against the kernel (its bf16 operands), as above; bf16
    pools: 1e-2 against both, as the 7-head bf16 test."""
    rng = np.random.default_rng(len(lengths) + len(dtype))
    q, kp, vp, table, lens = _pool_case(rng, len(lengths), 6, 6, 64, 8, 40,
                                        list(lengths))
    if dtype == "bf16":
        tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, kp, vp))
        jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, kp, vp))
    else:
        tq, tk, tv = (torch.from_numpy(x) for x in (q, kp, vp))
        jq, jk, jv = (jnp.asarray(x) for x in (q, kp, vp))
    got = pk.paged_decode_attention(tq, tk, tv, torch.from_numpy(table),
                                    torch.from_numpy(lens)).float().numpy()
    jargs = (jq, jk, jv, jnp.asarray(table), jnp.asarray(lens))
    xla = np.asarray(_xla_paged_decode(*jargs, 1.0 / np.sqrt(64)),
                     np.float32)
    kern = np.asarray(jpaged(*jargs, interpret=True), np.float32)
    if dtype == "bf16":
        np.testing.assert_allclose(got, xla, atol=1e-2, rtol=1e-2)
        np.testing.assert_allclose(got, kern, atol=1e-2, rtol=1e-2)
    else:
        np.testing.assert_allclose(got, xla, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got, kern, rtol=2e-2, atol=8e-3)


def test_paged_writes_and_split_plan():
    pool = torch.zeros(6, 2, 4, 3)
    table = torch.tensor([[3, 1, 5], [2, 0, 4]], dtype=torch.int32)
    x = torch.arange(12.).reshape(2, 2, 3)
    pk.write_token(pool, table, torch.tensor([5, 0]), x)
    torch.testing.assert_close(pool[1, :, 1], x[0])
    torch.testing.assert_close(pool[2, :, 0], x[1])
    assert pool.abs().sum() == x.abs().sum()
    # the plan: a cluster of 1..MAX_SPLITS blocks a (slot, kv head), at
    # most one a 64-token tile of the table, the grid one wave; the bounds
    # cover each slot's tokens below its length once
    clusters = tuple(264 // c for c in range(1, pk.MAX_SPLITS + 1))
    for slots, kvh, mb, bs in ((4, 4, 64, 128), (4, 4, 8, 8),
                               (1, 4, 128, 16), (8, 2, 1, 1)):
        splits = pk.split_plan(slots, kvh, mb, bs, clusters)
        assert 1 <= splits <= min(pk.MAX_SPLITS, -(-mb * bs // pk.TILE))
        assert splits == 1 or slots * kvh <= clusters[splits - 1]
        lens = torch.tensor([mb * bs, 1] + [mb * bs // 2] * (slots - 2))[
            :slots]
        bounds = pk.split_bounds(lens, mb, bs, splits)
        assert (bounds[:, 0, 0] == 0).all()
        assert torch.equal(bounds[:, -1, 1], lens)
        assert torch.equal(bounds[:, 1:, 0], bounds[:, :-1, 1])


def test_chunk_attention_matches_jax():
    rng = np.random.default_rng(9)
    b, c, h, kvh, d, L = 1, 32, 4, 2, 16, 80
    q = rng.standard_normal((b, c, h, d)).astype(np.float32)
    k = rng.standard_normal((b, L, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, L, kvh, d)).astype(np.float32)
    start = np.array([48], np.int32)
    want = xla_chunk_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(start), kv_block=32)
    args = [torch.from_numpy(a) for a in (q, k, v, start)]
    # the plain version in 32-key blocks, as the JAX call's, and the public
    # function on the CPU (one block of the default size)
    for got in (chunk_attention_reference(*args, kv_block=32),
                chunk_attention(*args)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_cpu_tensors_count_no_launch():
    before = (kg.launches, pk.launches)
    seg = torch.tensor([[1, 1, 2, 0]])
    x = torch.zeros(1, 4, 2, 8)
    kg.flash_attention_kvgrid(x, x, x, seg)
    pk.paged_decode_attention(torch.zeros(1, 2, 8), torch.zeros(2, 1, 4, 8),
                              torch.zeros(2, 1, 4, 8),
                              torch.zeros(1, 1, dtype=torch.int32),
                              torch.ones(1, dtype=torch.int32))
    assert (kg.launches, pk.launches) == before


# ---- on the card ------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.gpu
def test_kvgrid_kernel_matches_plain_on_card():
    """K3 at the vision tower's width (16 heads, d = 80) on window-sized and
    image-sized segments with a pad tail: 2e-2 on real rows, pad rows 0."""
    g = _card()
    rng = np.random.default_rng(0)
    for max_len in (64, 2000):
        seg = torch.from_numpy(_contig_segs(rng, 3000, max_len, 45))[None]
        seg = seg.cuda()
        q, k, v = (torch.randn(1, seg.shape[1], 16, 80, generator=g,
                               device="cuda").bfloat16() for _ in range(3))
        out = kg.flash_attention_kvgrid(q, k, v, seg)
        ref = kg.flash_attention_kvgrid_reference(q, k, v, seg)
        real = seg[0] > 0
        err = (out.float() - ref.float())[0][real].abs().max().item()
        assert err <= 2e-2, err
        assert (out[0][~real] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh,d,bs,lens", [
    (36, 36, 64, 8, [1, 8, 9, 4096]),        # MiniCPM-2B, bs 8
    (36, 36, 64, 128, [1, 128, 129, 4096]),  # MiniCPM-2B, bs 128
    (16, 2, 128, 8, [1, 8, 9, 16536, 15064, 700, 64, 65]),   # 3B rollout
    (28, 4, 128, 8, [4815, 4643, 4879, 650]),                # 7B, bs 8
])
def test_paged_kernel_new_shapes_on_card(h, kvh, d, bs, lens):
    """K5 at the head dims, groupings and block sizes the JAX kernel takes
    on the port's paths, lengths 1, bs and bs + 1 among them: 2e-2 max abs
    against the plain version, finite."""
    g = _card()
    nb = sum(-(-n // bs) for n in lens) + 1
    kp, vp = (torch.randn(nb, kvh, bs, d, generator=g,
                          device="cuda").bfloat16() for _ in range(2))
    mb = max(-(-n // bs) for n in lens)
    table = torch.full((len(lens), mb), nb - 1, dtype=torch.int32,
                       device="cuda")
    perm = torch.randperm(nb - 1, generator=g, device="cuda").int()
    at = 0
    for i, n in enumerate(lens):
        used = -(-n // bs)
        table[i, :used] = perm[at:at + used]
        at += used
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(len(lens), h, d, generator=g, device="cuda").bfloat16()
    out = pk.paged_decode_attention(q, kp, vp, table, lengths)
    ref = pk.paged_decode_reference(q, kp, vp, table, lengths, d ** -0.5)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.gpu
def test_paged_kernel_matches_plain_on_card():
    """K5 at the 7B decode shape (28 heads over 4 kv heads, d = bs = 128)
    with lengths 1, bs, bs + 1 and a long one: 2e-2 max abs."""
    g = _card()
    kp, vp = (torch.randn(300, 4, 128, 128, generator=g,
                          device="cuda").bfloat16() for _ in range(2))
    table = torch.randperm(299, device="cuda")[:4 * 64].view(4, 64).int()
    lens = torch.tensor([1, 128, 129, 8000], dtype=torch.int32,
                        device="cuda")
    q = torch.randn(4, 28, 128, generator=g, device="cuda").bfloat16()
    out = pk.paged_decode_attention(q, kp, vp, table, lens)
    ref = pk.paged_decode_reference(q, kp, vp, table, lens, 128 ** -0.5)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2

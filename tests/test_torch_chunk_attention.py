"""K8, the chunked-prefill attention kernel (visrag_tpu_torch/ops/attention.py
`chunk_attention`, csrc/attention_chunk_hopper.cu).

On the CPU: `chunk_pair_classes_reference`, the plain version of the
kernel's closed-form tile classes, against the element mask (key <= start
+ query, key < L) over seeded starts, chunk lengths, key counts and tile
sizes, with the kernel's walk of key tiles; the wrapper's CPU path (the
plain version, no library loaded), its refusals, its launch with the
library and the CUDA calls stood in for, and its `attention.chunk`
counter under a profiler. `test_chunk_attention_matches_jax`
(test_torch_kvgrid_paged.py) holds the plain version against the JAX
package.

On a card (`-m gpu`; skipped without one): K8 against the plain version
in bf16 at the 7B's chunks (28/4 heads, C 2048, start 0 / 2048 / 4096), a
final chunk whose last rows are pad, a prefix-cache start that is a
multiple of the block but not of C, the 3B rollout's 16/2 and a tp-2
rank's 14/2 heads, keys past start + C, and inputs dequantized from int8
pools; an exact check of each row's visible keys; one chunk of the 7B
stack launching K8 once a layer; a head dim of 64 refused.
"""

import contextlib

import pytest
import torch

from visrag_tpu_torch.ops import _build
from visrag_tpu_torch.ops import attention as at
from visrag_tpu_torch.utils import profiling

TILES = [at.CHUNK_TILES, (64, 64), (64, 128), (128, 64)]


def _allowed(start, c, L):
    """(C, L) bool: key j visible to query i of a chunk at `start`."""
    i = torch.arange(c)[:, None]
    j = torch.arange(L)[None, :]
    return j <= start + i


def _tile_any_all(allow, c, L, bq, bk):
    """(C, L) bool → per (query tile, key tile): any element True, every
    element True; query rows past C are not stored (True for all, False
    for any), keys past L are zero-filled by TMA (False for both)."""
    nq, nk = -(-c // bq), -(-L // bk)
    pad_any = torch.zeros((nq * bq, nk * bk), dtype=torch.bool)
    pad_all = torch.ones((nq * bq, nk * bk), dtype=torch.bool)
    pad_all[:, L:] = False
    pad_any[:c, :L] = allow
    pad_all[:c, :L] = allow
    return (pad_any.reshape(nq, bq, nk, bk).any(3).any(1),
            pad_all.reshape(nq, bq, nk, bk).all(3).all(1))


def _case(seed):
    """A seeded (start, C, L, tiles): starts at and off block edges, chunks
    short and long, L from start + C up (and below it, where rows past L
    see every key)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda n: int(torch.randint(n, (1,), generator=g))   # noqa: E731
    c = [1, 17, 128, 129, 300, 2048][seed % 6]
    start = [0, 128 * r(8), r(700), 1280][seed % 4]
    L = start + c + [0, 0, r(200), 1][seed % 4]
    if seed % 7 == 5:
        L = max(1, start + c - 1 - r(c))
    return start, c, L, TILES[seed % len(TILES)]


@pytest.mark.parametrize("seed", range(16))
def test_chunk_pair_classes_are_exact(seed):
    """No skipped pair holds a visible element; every element of an
    unmasked pair is visible and below L; the kernel walks exactly the
    tiles before the first skipped one (ChunkMask::ntiles)."""
    start, c, L, (bq, bk) = _case(seed)
    got = at.chunk_pair_classes_reference(torch.tensor([start]), c, L, bq,
                                          bk)[0]
    some, every = _tile_any_all(_allowed(start, c, L), c, L, bq, bk)
    assert got.shape == some.shape
    assert not bool(some[got == at.SKIP].any())
    assert bool(every[got == at.UNMASKED].all())
    for qt in range(got.shape[0]):
        walk = min(got.shape[1], (start + qt * bq + bq - 1) // bk + 1)
        assert bool((got[qt, :walk] != at.SKIP).all())
        assert bool((got[qt, walk:] == at.SKIP).all())


@pytest.mark.parametrize("start", [0, 2048, 4096, 1280])
def test_chunk_pair_classes_of_the_7b_chunks(start):
    """At the engine's 2048-token chunks (L = start + C) and 128 x 128
    tiles: every query tile walks start / 128 + its index + 1 key tiles,
    of which only the last is masked; the batch rows' starts are their
    own."""
    c, L = 2048, start + 2048
    cls = at.chunk_pair_classes_reference(torch.tensor([start, 0]), c, L,
                                          128, 128)
    for qt in range(c // 128):
        walk = start // 128 + qt + 1
        assert cls[0, qt, :walk - 1].eq(at.UNMASKED).all()
        assert int(cls[0, qt, walk - 1]) == at.MASKED
        assert cls[0, qt, walk:].eq(at.SKIP).all()
        assert int(cls[1, qt, qt]) == at.MASKED
        assert cls[1, qt, qt + 1:].eq(at.SKIP).all()


def _chunk_inputs(b, c, L, h, kvh, d, seed=0, dtype=torch.float32,
                  device="cpu"):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, c, h, d, generator=g)
    k, v = (torch.randn(b, L, kvh, d, generator=g) for _ in range(2))
    return (t.to(device=device, dtype=dtype) for t in (q, k, v))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_library(name):
        raise AssertionError(f"library {name} loaded for CPU tensors")
    monkeypatch.setattr(_build, "load_library", no_library)
    at.reset_launch_counts()
    q, k, v = _chunk_inputs(2, 48, 96, 4, 2, 16)
    start = torch.tensor([32, 48])
    got = at.chunk_attention(q, k, v, start)
    assert torch.equal(got, at.chunk_attention_reference(q, k, v, start))
    assert at.chunk_launches == 0


def test_chunk_attention_refuses_bad_shapes():
    q, k, v = _chunk_inputs(1, 8, 16, 6, 4, 16)
    with pytest.raises(ValueError, match="H_kv dividing H"):
        at.chunk_attention(q, k, v, torch.tensor([8]))
    q, k, v = _chunk_inputs(1, 8, 16, 4, 2, 16)
    with pytest.raises(ValueError, match="H_kv dividing H"):
        at.chunk_attention(q, k[:, :, :1], v, torch.tensor([8]))
    with pytest.raises(ValueError, match="start"):
        at.chunk_attention(q, k, v, torch.tensor([8, 0]))


class _FakeLibrary:
    """Stands in for the built library: the entry point records its
    arguments and returns state["rc"]."""

    def __init__(self, calls, state):
        self.calls, self.state = calls, state

    def __getattr__(self, entry):
        def fn(*args):
            self.calls.append((entry, args))
            return self.state["rc"]
        return fn


@pytest.fixture
def fake_card(monkeypatch):
    calls, state, names = [], {"rc": 0}, []

    def load(name):
        names.append(name)
        return _FakeLibrary(calls, state)
    monkeypatch.setattr(_build, "load_library", load)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(at, "_stream", lambda t: 0)
    yield calls, names, lambda rc: state.__setitem__("rc", rc)


def test_launch_passes_shapes_strides_and_scale(fake_card):
    """One call of visrag_chunk_hopper_fwd: five pointers, (B, C, L, H,
    H_kv, d), the (batch, row, head) strides of q, k, v and o in that
    order (the gathered k / v of a kv-head-major pool are strided views),
    scale * log2(e) and the stream."""
    calls, names, _ = fake_card
    q, k, v = _chunk_inputs(2, 256, 384, 28, 4, 128, dtype=torch.bfloat16)
    kt = torch.empty(2, 4, 384, 128, dtype=torch.bfloat16).transpose(1, 2)
    o = torch.empty_like(q)
    starts = torch.tensor([128, 0], dtype=torch.int32)
    at._launch_chunk(q, kt, v, starts, o, 0.125)
    assert names == ["attention_chunk_hopper"]
    (entry, args), = calls
    assert entry == "visrag_chunk_hopper_fwd"
    assert args[:5] == (q.data_ptr(), kt.data_ptr(), v.data_ptr(),
                        o.data_ptr(), starts.data_ptr())
    assert args[5:11] == (2, 256, 384, 28, 4, 128)
    assert args[11:23] == (*q.stride()[:3], *kt.stride()[:3],
                           *v.stride()[:3], *o.stride()[:3])
    assert args[23] == pytest.approx(0.125 * at.LOG2E)
    assert args[24] == 0 and len(args) == 25


def test_a_refused_launch_raises(fake_card):
    calls, _, set_rc = fake_card
    q, k, v = _chunk_inputs(1, 128, 256, 4, 2, 128, dtype=torch.bfloat16)
    starts = torch.tensor([128], dtype=torch.int32)
    for rc, words in ((-1, "tensor map"), (1, "CUDA error 1")):
        set_rc(rc)
        with pytest.raises(RuntimeError, match=words):
            at._launch_chunk(q, k, v, starts, torch.empty_like(q), 0.1)
    assert len(calls) == 2
    with pytest.raises(TypeError, match="bfloat16"):
        at._launch_chunk(q.float(), k, v, starts, torch.empty_like(q), 0.1)


def test_counter_records_under_a_profiler():
    """`attention.chunk` (heads, kv heads, d, C, L, starts) once a call
    while a profiler runs, the starts copied at the call and read to the
    host by recorded(), so a caller's later write to its start buffer
    does not reach them; nothing without a profiler."""
    profiling.clear()
    q, k, v = _chunk_inputs(2, 16, 40, 4, 2, 8)
    at.chunk_attention(q, k, v, torch.tensor([24, 3]))
    assert profiling.recorded()[1] == []
    buf = torch.tensor([24, 3], dtype=torch.int32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        at.chunk_attention(q, k, v, buf)
        buf.fill_(0)
        at.chunk_attention(q[:1], k[:1], v[:1], torch.tensor(7))
    _, counters, _ = profiling.recorded()
    profiling.clear()
    assert [(c.name, c.value) for c in counters] == [
        ("attention.chunk", (4, 2, 8, 16, 40, [24, 3])),
        ("attention.chunk", (4, 2, 8, 16, 40, [7]))]


def test_engine_chunks_record_one_counter_a_layer():
    """A tiny engine's chunked prefill under a profiler: each chunk's
    `engine.prefill` span holds one `attention.chunk` counter a layer, at
    the chunk's start and the gathered prefix's length."""
    import numpy as np

    from visrag_tpu_torch.driver.common import build_qwen25_vl
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    from visrag_tpu_torch.serving.engine import Engine
    from visrag_tpu_torch.serving.sampling import SamplingParams
    cfg = Qwen25VLConfig.tiny()
    t = cfg.text
    eng = Engine(build_qwen25_vl(cfg, device="cpu"), num_slots=2,
                 max_len=128, prompt_buckets=(16, 64),
                 chunked_prefill_tokens=16, decode_chunk=4)
    ids = np.random.default_rng(3).integers(0, 100, size=(40,))
    eng.add_request(input_ids=ids.astype(np.int32),
                    sampling=SamplingParams(temperature=0.0, max_tokens=2))
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        eng.run()
    spans, counters, _ = profiling.recorded()
    profiling.clear()
    chunks = [s for s in spans if s.name == "engine.prefill"
              and s.attrs["kind"] == "chunk"]
    assert len(chunks) == 3
    for lo, s in zip((0, 16, 32), chunks):
        mine = [c.value for c in counters if c.name == "attention.chunk"
                and s.start_ns <= c.t_ns <= s.end_ns]
        assert mine == [(t.num_attention_heads, t.num_key_value_heads,
                         t.head_dim, 16, lo + 16, [lo])] * \
            t.num_hidden_layers
    assert sum(c.name == "attention.chunk" for c in counters) == \
        3 * t.num_hidden_layers


# ---- on a card: K8 against the plain version ------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _visible_count_check(dev, start, c, L, h, kvh):
    """k = 0 makes every visible score 0, so each row averages V over its
    visible keys with P = 1 exactly; V one-hot in key % 128 then gives,
    per column, the share of the row's visible keys in that residue. One
    key too many or too few moves a column by 1 / n, many bf16 ulps."""
    q = torch.randn(1, c, h, 128, device=dev).bfloat16()
    k = torch.zeros(1, L, kvh, 128, device=dev, dtype=torch.bfloat16)
    v = torch.nn.functional.one_hot(torch.arange(L, device=dev) % 128, 128)
    v = v[None, :, None].expand(1, L, kvh, 128).bfloat16().contiguous()
    st = torch.tensor([start], device=dev)
    got = at.chunk_attention(q, k, v, st).float()
    i = torch.arange(c, device=dev)[:, None]
    j = torch.arange(L, device=dev)[None]
    vis = (j <= start + i).float()                          # (C, L)
    want = (vis @ v[0, :, 0].float()) / vis.sum(1, keepdim=True)
    want = want[:, None].expand_as(got[0])
    err = (got[0] - want).abs() - 2 ** -8 * want
    assert err.max().item() <= 1e-6


SHAPES = {
    # name: (batch starts, C, L - max start - C, heads, kv heads, pad rows)
    "7b_start0": ([0], 2048, 0, 28, 4, 0),
    "7b_start2048": ([2048], 2048, 0, 28, 4, 0),
    "7b_start4096": ([4096], 2048, 0, 28, 4, 0),
    "final_chunk_pad": ([2048], 2048, 0, 28, 4, 700),
    "prefix_start_1280": ([1280], 2048, 0, 28, 4, 0),
    "3b_rollout_16_2": ([2048], 2048, 0, 16, 2, 0),
    "tp2_rank_14_2": ([4096], 2048, 0, 14, 2, 0),
    "tp4_rank_7_1": ([2048], 2048, 0, 7, 1, 0),
    "keys_past_chunk": ([640], 1000, 37, 28, 4, 0),
    "two_rows": ([0, 3072], 1024, 0, 28, 4, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SHAPES))
def test_cuda_k8_matches_plain(name):
    """bf16 on the card within 1e-2 relative (Frobenius) and 2e-2 absolute
    of the plain version on the same bf16 inputs, which rounds P to bf16
    as the kernel does; one launch a call; then each row's visible keys
    exactly."""
    dev = _cuda()
    starts, c, extra, h, kvh, pad = SHAPES[name]
    L = max(starts) + c + extra
    q, k, v = _chunk_inputs(len(starts), c, L, h, kvh, 128, seed=len(name),
                            dtype=torch.bfloat16, device=dev)
    if pad:
        # the engine's final chunk: its last rows are pad tokens, whose K/V
        # it writes at the positions after the prompt
        q[:, c - pad:] = 0
        k[:, max(starts) + c - pad:max(starts) + c] = 0
        v[:, max(starts) + c - pad:max(starts) + c] = 0
    st = torch.tensor(starts, device=dev)
    at.reset_launch_counts()
    got = at.chunk_attention(q, k, v, st)
    assert at.chunk_launches == 1
    want = at.chunk_attention_reference(q, k, v, st)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    diff = (got.float() - want.float())
    rel = (torch.linalg.norm(diff) / torch.linalg.norm(want.float())).item()
    assert rel <= 1e-2, rel
    assert diff.abs().max().item() <= 2e-2
    if len(starts) == 1:
        _visible_count_check(dev, starts[0], c, L, h, kvh)


@pytest.mark.gpu
def test_cuda_k8_on_int8_pool_inputs():
    """The prefix gathered (and dequantized) from int8 pools by
    pool_gather, as QwenTextBlock.prefill_chunk passes it."""
    from visrag_tpu_torch.serving.paged_kv import (KVQuant, pool_gather,
                                                   quantize_kv)
    dev = _cuda()
    bs, kvh, d, start, c = 128, 4, 128, 2048, 2048
    nb = (start + c) // bs
    pools = [KVQuant(*quantize_kv(torch.randn(nb + 3, kvh, bs, d,
                                              device=dev)))
             for _ in range(2)]
    rows = torch.randperm(nb + 3, device=dev)[:nb]
    kg, vg = (pool_gather(p, rows, torch.bfloat16).transpose(1, 2)
              .reshape(1, nb * bs, kvh, d) for p in pools)
    q = torch.randn(1, c, 28, d, device=dev).bfloat16()
    st = torch.tensor([start], device=dev)
    got = at.chunk_attention(q, kg, vg, st).float()
    want = at.chunk_attention_reference(q, kg, vg, st).float()
    rel = (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()
    assert rel <= 1e-2, rel


@pytest.mark.gpu
def test_cuda_7b_chunk_launches_k8_once_a_layer():
    """One Qwen25VL.prefill_chunk of the 7B stack (random weights) at
    start 2048 adds 28 to chunk_launches: no layer takes the plain
    version."""
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VL, Qwen25VLConfig
    dev = _cuda()
    cfg = Qwen25VLConfig.b7()
    with torch.device(dev):
        model = Qwen25VL(cfg).eval()
    t = cfg.text
    bs, c, start = 128, 2048, 2048
    nb = (start + c) // bs
    shape = (t.num_hidden_layers, nb, t.num_key_value_heads, bs, t.head_dim)
    kc = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    ids = torch.randint(1000, (1, c), device=dev)
    pos = (start + torch.arange(c, device=dev)).expand(3, 1, c)
    at.reset_launch_counts()
    with torch.inference_mode():
        logits = model.prefill_chunk(
            ids, pos, kc, vc, torch.arange(start // bs, nb, device=dev),
            torch.arange(nb, device=dev), torch.tensor(start, device=dev),
            last_pos=torch.tensor([c - 1], device=dev))
    torch.cuda.synchronize()
    assert at.chunk_launches == t.num_hidden_layers == 28
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.gpu
def test_cuda_head_dim_64_raises():
    dev = _cuda()
    q, k, v = _chunk_inputs(1, 128, 256, 4, 2, 64, dtype=torch.bfloat16,
                            device=dev)
    at.reset_launch_counts()
    with pytest.raises(ValueError, match="head_dim 64"):
        at.chunk_attention(q, k, v, torch.tensor([128], device=dev))
    assert at.chunk_launches == 0

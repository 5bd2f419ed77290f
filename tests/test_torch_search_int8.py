"""The port's int8 corpus scan, tie order and self_retrieve
(visrag_tpu_torch/retrieval/search.py) against the JAX package's
visrag_tpu/retrieval/search.py, on the CPU.

  * quantize_rows (torch) and quantize_rows_np: codes and scales bit for
    bit the JAX quantize_rows' and quantize_rows_np's, zero rows (scale
    1/127, codes 0) and .5 ties (round half to even) included;
  * topk_single_int8 over the whole corpus (k = C): every score bit for
    bit and every id the JAX function's, duplicate rows tying to the lower
    index (the product through K6's plain version, an exact int sum);
  * topk_single with exact (integer-valued) scores: ties to the lower
    index, also where more rows tie than the k-th place holds;
  * StreamingSearcher(quant="int8") over uneven chunks (one smaller than
    k): the JAX searcher's ids on a one-device mesh, and the eager JAX
    scan's scores bit for bit (the jitted JAX searcher's within 1e-6: XLA
    turns its division by 127 into a multiply by 1/127);
  * self_retrieve on duplicate queries: the JAX run on a one-device
    mesh.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visrag_tpu.mesh import single_device_mesh
from visrag_tpu.retrieval import search as js
from visrag_tpu_torch.retrieval import search as ps


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(seed, n, d):
    """Random rows plus a zero row, a row of .5 ties (amax 127 → scale 1)
    and a negative one."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[0] = 0.0
    x[1] = 0.0
    x[1, :6] = [127.0, 0.5, 1.5, -2.5, 2.5, -0.5]
    x[2] = -np.abs(x[2])
    return x


def test_quantize_rows_bit_equal_jax():
    x = _rows(0, 40, 24)
    jq, js_ = (np.asarray(a) for a in js.quantize_rows(jnp.asarray(x)))
    pq, ps_ = (t.numpy() for t in ps.quantize_rows(torch.from_numpy(x)))
    nq, ns = ps.quantize_rows_np(x)
    jnq, jns = js.quantize_rows_np(x)
    for q, s in ((pq, ps_), (nq, ns), (jnq, jns)):
        assert q.dtype == np.int8 and s.dtype == np.float32
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(s.view(np.uint32), js_.view(np.uint32))
    assert ps_[0] == np.float32(1.0) / np.float32(127.0) and not pq[0].any()
    np.testing.assert_array_equal(pq[1, :6], [127, 0, 2, -2, 2, 0])


def test_topk_int8_scores_and_ids_bit_equal_jax():
    rng = np.random.default_rng(1)
    corpus = _rows(2, 96, 64)
    corpus[50] = corpus[7]          # duplicate rows: exact ties
    corpus[90] = corpus[7]
    corpus[33] = corpus[12]
    q = rng.normal(size=(6, 64)).astype(np.float32)
    q[3] = corpus[7]
    cq, cs = ps.quantize_rows_np(corpus)
    k = len(corpus)
    js_, ji = (np.asarray(a) for a in js.topk_single_int8(
        jnp.asarray(q), jnp.asarray(cq), jnp.asarray(cs), k))
    s, i = ps.topk_single_int8(torch.from_numpy(q), torch.from_numpy(cq),
                               torch.from_numpy(cs), k)
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  js_.view(np.uint32))
    np.testing.assert_array_equal(i.numpy(), ji)
    row = list(i[3].numpy())
    assert row[:3] == [7, 50, 90]
    assert row.index(12) < row.index(33)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_topk_single_ties_to_lower_index(k):
    """Integer-valued rows: every score is exact, so duplicates tie in
    both packages; rows 4, 9, 11 and 17 tie at the top, more than k = 3
    holds."""
    rng = np.random.default_rng(3)
    corpus = rng.integers(-3, 4, size=(24, 16)).astype(np.float32)
    for r in (9, 11, 17):
        corpus[r] = corpus[4]
    q = rng.integers(-3, 4, size=(5, 16)).astype(np.float32)
    q[0] = corpus[4] * 3
    js_, ji = (np.asarray(a) for a in js.topk_single(
        jnp.asarray(q), jnp.asarray(corpus), k))
    s, i = ps.topk_single(torch.from_numpy(q), torch.from_numpy(corpus), k)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(s.numpy(), js_)
    assert list(i[0].numpy()[:4]) == [4, 9, 11, 17][:k]


def test_topk_lower_index_orders_ties_inside():
    scores = torch.tensor([[1.0, 5.0, 5.0, 2.0, 5.0, 7.0, 5.0]])
    vals, idx = ps.topk_lower_index(scores, 4)
    assert idx.tolist() == [[5, 1, 2, 4]]
    assert vals.tolist() == [[7.0, 5.0, 5.0, 5.0]]


def _chunks(corpus, sizes):
    out, base = [], 0
    for n in sizes:
        out.append((corpus[base:base + n], base))
        base += n
    return out


def test_streaming_int8_matches_jax():
    rng = np.random.default_rng(4)
    corpus = rng.normal(size=(70, 32)).astype(np.float32)
    corpus[60] = corpus[5]
    q = rng.normal(size=(4, 32)).astype(np.float32)
    q[1] = corpus[5]
    chunks = _chunks(corpus, (30, 3, 37))
    jsearch = js.StreamingSearcher(single_device_mesh(), k=7, quant="int8")
    js_, ji = jsearch.search(q, chunks)
    s, i = ps.StreamingSearcher(7, device="cpu", quant="int8").search(
        q, chunks)
    whole_s, whole_i = ps.StreamingSearcher(7, device="cpu",
                                            quant="int8").search(
        q, [(corpus, 0)])
    # the jitted JAX searcher quantizes the queries with the division by
    # 127 rewritten by XLA as a multiply by 1/127 (a few ulps in a scale);
    # its eager topk_single_int8 divides, as the port does
    es, ei = (np.asarray(a) for a in js.topk_single_int8(
        jnp.asarray(q), *map(jnp.asarray, js.quantize_rows_np(corpus)), 7))
    np.testing.assert_array_equal(s.view(np.uint32), es.view(np.uint32))
    np.testing.assert_array_equal(i, ei)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js_, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(i, whole_i)
    np.testing.assert_array_equal(s, whole_s)
    assert list(i[1, :2]) == [5, 60]
    with pytest.raises(ValueError):
        ps.StreamingSearcher(3, device="cpu", quant="fp8")


def test_self_retrieve_matches_jax():
    rng = np.random.default_rng(5)
    reps = rng.integers(-4, 5, size=(9, 12)).astype(np.float32)
    reps[6] = reps[2]                      # a duplicate query: exact tie
    qids = [f"q{i}" for i in range(9)]
    jrun = js.self_retrieve(reps, qids, single_device_mesh(), k=3)
    run = ps.self_retrieve(reps, qids, k=3, device="cpu")
    assert {q: list(d.items()) for q, d in run.items()} == \
        {q: list(d.items()) for q, d in jrun.items()}
    assert list(run["q6"])[:2] == ["q2", "q6"]
    assert list(run["q2"])[:2] == ["q2", "q6"]

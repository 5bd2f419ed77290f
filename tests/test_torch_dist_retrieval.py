"""VisRAG-Ret retrieval across gloo ranks on the CPU against the JAX
package's sharded programs on its CPU mesh, and against the port's one
process.

  * The sharded exact top-k (retrieval/search.make_sharded_topk through
    StreamingSearcher(mesh=...)) over 4 ranks, fp32 and int8: a corpus of
    37 rows (not a multiple of 4: pad rows), k = 12 (more than a shard's
    10 rows), normal scores (negative ones among them) and planted ties
    (duplicate rows across shards, a query equal to a row). The ids equal
    JAX make_sharded_topk's on a 4-device mesh, the scores within 1e-6
    (JAX's int8 scan is jitted, and XLA turns the scale's division by 127
    into a multiply: ulps apart). Also the corpus in 3 chunks, merged on
    the host, and self_retrieve.
  * The data-parallel encode (retrieval/encode.make_encode_step) at 2
    ranks: the representations in the global order equal the one-process
    encode's (1e-6) and the JAX encode's on shared weights (1e-4 relative,
    the tolerance of the single-process encode tests: the ViT's GELU and
    the matmul order differ).
  * eval_retriever across 2 ranks, the fp32 and the int8 corpus (the
    int8 run configured through --set): the run rank 0 writes ranks the
    one-process driver's documents in the same order, its scores within
    1e-5 relative (each rank encodes a batch of 1 where one process
    encodes 2: other GEMM shapes), and the metrics are the same.

One job of 4 ranks and one of 2 (tests/torch_dist_workers: spawned
processes that import no jax).
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from visrag_tpu.config import MeshConfig as JMeshConfig
from visrag_tpu.mesh import build_mesh as jbuild_mesh
from visrag_tpu.models.visrag_ret import VisRAGRet as JVisRAGRet
from visrag_tpu.models.visrag_ret import VisRAGRetConfig as JVisRAGRetConfig
from visrag_tpu.preprocess.device import finish_encode_batch as jfinish
from visrag_tpu.retrieval.search import StreamingSearcher as JSearcher
from visrag_tpu.retrieval.search import self_retrieve as jself_retrieve
from visrag_tpu_torch.preprocess import MockTokenizer, build_encode_batch
from visrag_tpu_torch.preprocess.transform import bicubic_table
from torch_dist_workers import (dp_encode_and_eval, encode_batch,
                                sharded_search, spawn, tiny_pcfg,
                                tiny_retriever)

C, D, Q, K, CHUNK = 37, 16, 5, 12, 13


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny models run fastest on one thread, and the suite's workers
    (and this file's spawned ranks) share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def search_inputs():
    rng = np.random.default_rng(11)
    corpus = rng.standard_normal((C, D)).astype(np.float32)
    corpus[25] = corpus[3]          # ties across shards (3 in shard 0,
    corpus[36] = corpus[3]          # 25 in shard 2, 36 in shard 3)
    corpus[12] = corpus[11]         # a tie inside shard 1
    corpus[:, 0] -= 4.0             # most scores negative: a zero pad
    queries = rng.standard_normal((Q, D)).astype(np.float32)
    queries[:, 0] = np.abs(queries[:, 0]) + 1.0    # row would outrank them
    queries[1] = corpus[3]
    queries[2] = corpus[11]
    return queries, corpus


@pytest.fixture(scope="module")
def four(search_inputs):
    ranks = spawn(sharded_search, 4, *search_inputs, K, CHUNK)
    for r in ranks[1:]:             # every rank holds the global result
        for key in ("none", "int8", "none_chunks", "int8_chunks"):
            for a, b in zip(r[key], ranks[0][key]):
                np.testing.assert_array_equal(a, b)
        assert r["self"] == ranks[0]["self"]
    return ranks[0]


def _jax_mesh():
    return jbuild_mesh(JMeshConfig(data=4), devices=jax.devices()[:4])


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_sharded_topk_matches_jax(four, search_inputs, quant):
    queries, corpus = search_inputs
    want_s, want_i = JSearcher(_jax_mesh(), K, quant=quant).search(
        queries, [(corpus, 0)])
    got_s, got_i = four[quant]
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=1e-6)
    assert (got_s < 0).any() and np.isfinite(got_s).all()
    # the planted ties: the lower global id first
    for qi, row in ((1, 3), (2, 11)):
        ids = list(got_i[qi])
        dup = [i for i in ids if np.array_equal(corpus[i], corpus[row])]
        assert dup == sorted(dup) and dup[0] == row


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_chunked_search_matches_jax(four, search_inputs, quant):
    queries, corpus = search_inputs
    chunks = [(corpus[i:i + CHUNK], i) for i in range(0, C, CHUNK)]
    want_s, want_i = JSearcher(_jax_mesh(), K, quant=quant).search(
        queries, chunks)
    got_s, got_i = four[quant + "_chunks"]
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=1e-6)


def test_self_retrieve_matches_jax(four, search_inputs):
    queries, _ = search_inputs
    want = jself_retrieve(queries, [f"q{i}" for i in range(Q)], _jax_mesh(),
                          3)
    got = four["self"]
    assert {q: list(d) for q, d in got.items()} == \
        {q: list(d) for q, d in want.items()}
    for q in want:
        np.testing.assert_allclose(list(got[q].values()),
                                   list(want[q].values()), rtol=1e-6,
                                   atol=1e-6)


# ---- the data-parallel encode and the eval driver ---------------------------


def _png(rng, size):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def eval_data(tmp_path_factory):
    """The corpus / queries / qrels of tests/test_torch_slice.py."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    root = tmp_path_factory.mktemp("dist_eval")
    rng = np.random.default_rng(0)
    pq.write_table(pa.table({
        "corpus-id": [f"d{i}" for i in range(6)],
        "text": ["" for _ in range(6)],
        "image": [{"bytes": _png(rng, (24, 18))} for _ in range(6)]}),
        root / "corpus.parquet")
    pq.write_table(pa.table({
        "query-id": [f"q{i}" for i in range(3)],
        "query": [f"question number {i}" for i in range(3)]}),
        root / "queries.parquet")
    (root / "qrels.tsv").write_text(
        "query-id\tcorpus-id\tscore\n" +
        "\n".join(f"q{i}\td{i}\t1" for i in range(3)) + "\n")
    return root


def _eval_argv(data, out, quant):
    """The int8 run takes its batch size and depth as config overrides."""
    sizes = (["--batch-size", "2", "--depth", "5"] if quant == "none" else
             ["--set", "data.batch_size=2", "--set", "retrieval.depth=5"])
    return ["--corpus", str(data / "corpus.parquet"),
            "--queries", str(data / "queries.parquet"),
            "--qrels", str(data / "qrels.tsv"), "--output-dir", str(out),
            "--tiny", *sizes, "--corpus-quant", quant, "--device", "cpu"]


@pytest.fixture(scope="module")
def shared_retriever():
    """JAX params of the tiny retriever (numpy) and 4 pages."""
    rng = np.random.default_rng(5)
    sizes = [(20, 14), (9, 30), (16, 16), (24, 10)]
    pages = [("", Image.fromarray(rng.integers(0, 255, (*sizes[i], 3),
                                               dtype=np.uint8)))
             for i in range(4)]
    pcfg = tiny_pcfg()
    raw = build_encode_batch(MockTokenizer(), pages, pcfg, device_mode=True)
    jmodel = JVisRAGRet(JVisRAGRetConfig.tiny())
    table = bicubic_table(pcfg.src_grid)
    jraw = jfinish({k: jnp.asarray(v) for k, v in raw.items()}, table)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jraw)
    want = np.asarray(jax.jit(jmodel.apply)(params, jraw))
    return jax.tree.map(np.asarray, params), pages, want


@pytest.fixture(scope="module")
def two(shared_retriever, eval_data):
    params, pages, _ = shared_retriever
    argvs = [_eval_argv(eval_data, eval_data / f"dist_{quant}", quant)
             for quant in ("none", "int8")]
    ranks = spawn(dp_encode_and_eval, 2, params, pages, argvs)
    np.testing.assert_array_equal(ranks[0][0], ranks[1][0])
    assert ranks[0][1] == ranks[1][1] == [0, 0]
    return ranks[0]


def test_dp_encode_matches_one_process_and_jax(two, shared_retriever):
    params, pages, want = shared_retriever
    got = two[0]
    with torch.inference_mode():
        one = tiny_retriever(params).eval()(encode_batch(pages)).numpy()
    assert got.shape == (4, one.shape[1])
    np.testing.assert_allclose(got, one, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _same_run(eval_data, quant):
    from visrag_tpu_torch.driver.eval_retriever import main
    from visrag_tpu_torch.retrieval.trec import load_from_trec
    one = eval_data / f"one_{quant}"
    assert main(_eval_argv(eval_data, one, quant)) == 0
    dist_dir = eval_data / f"dist_{quant}"
    got = load_from_trec(str(dist_dir / "test.trec"))
    want = load_from_trec(str(one / "test.trec"))
    assert len(want) == 3 and all(len(d) == 5 for d in want.values())
    assert {q: list(d) for q, d in got.items()} == \
        {q: list(d) for q, d in want.items()}
    for q in want:
        np.testing.assert_allclose(list(got[q].values()),
                                   list(want[q].values()), rtol=1e-5,
                                   atol=1e-6)
    assert json.loads((dist_dir / "metrics.json").read_text()) == \
        json.loads((one / "metrics.json").read_text())


def test_eval_retriever_across_ranks_writes_the_one_process_run(
        two, eval_data):
    _same_run(eval_data, "none")


def test_eval_retriever_int8_across_ranks_writes_the_one_process_run(
        two, eval_data):
    """--corpus-quant int8: the sharded int8 scan over the ranks."""
    _same_run(eval_data, "int8")

"""The whole VisRAG-Ret slice: visrag_tpu_torch against visrag_tpu.

One shared raw batch (the shared host pipeline, device_mode=True) of
synthetic pages and one of text queries go through JAX
VisRAGRet.apply(params, finish_encode_batch(raw)) and through the port
with the same params (carried over by hf_loader.from_jax_params). fp32,
tiny config with ViT patch size 14 (the exporter's conv patch-embed
layout). Embeddings agree to 1e-4 abs and top-k ranks are identical.
The port's eval_retriever CLI then runs end to end on the CPU.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from visrag_tpu.models.siglip_vit import SiglipViTConfig as JSiglipViTConfig
from visrag_tpu.models.minicpmv import MiniCPMVConfig as JMiniCPMVConfig
from visrag_tpu.models.visrag_ret import VisRAGRet as JVisRAGRet
from visrag_tpu.models.visrag_ret import VisRAGRetConfig as JVisRAGRetConfig
from visrag_tpu.preprocess.device import finish_encode_batch as jfinish
from visrag_tpu.preprocess.pipeline import PipelineConfig, build_encode_batch
from visrag_tpu.preprocess.tokenize import MockTokenizer
from visrag_tpu.preprocess.transform import bicubic_table
from visrag_tpu.retrieval.search import topk_single as jtopk
from visrag_tpu_torch.models.hf_loader import (from_jax_params,
                                              load_visrag_ret_state)
from visrag_tpu_torch.models.minicpmv import MiniCPMVConfig
from visrag_tpu_torch.models.siglip_vit import SiglipViTConfig
from visrag_tpu_torch.models.visrag_ret import VisRAGRet, VisRAGRetConfig
from visrag_tpu_torch.preprocess.device import (finish_encode_batch,
                                                pos_table_tensor)
from visrag_tpu_torch.retrieval.search import topk_single

PCFG = PipelineConfig(seq_len=64, query_num=4, patch_size=14, src_grid=4,
                      scale_resolution=56, max_patches=64)


def _raw_batches():
    rng = np.random.default_rng(7)
    pages = [("", Image.fromarray(rng.integers(0, 255, (h, w, 3),
                                               dtype=np.uint8)))
             for h, w in [(70, 50), (40, 90), (56, 56), (100, 30)]]
    queries = [(f"which page shows item {i}?", None) for i in range(3)]
    tok = MockTokenizer()
    return (build_encode_batch(tok, pages, PCFG, device_mode=True),
            build_encode_batch(tok, queries, PCFG, device_mode=True))


JCFG = JVisRAGRetConfig(backbone=JMiniCPMVConfig.tiny(
    vit=JSiglipViTConfig.tiny(patch_size=14)))


def _port_model():
    return VisRAGRet(VisRAGRetConfig(backbone=MiniCPMVConfig.tiny(
        vit=SiglipViTConfig.tiny(patch_size=14))))


@pytest.fixture(scope="module")
def jax_side():
    """(jax model, params, raw page batch, raw query batch)."""
    pages_raw, queries_raw = _raw_batches()
    jmodel = JVisRAGRet(JCFG)
    table = bicubic_table(PCFG.src_grid)
    params = jax.jit(lambda key: jmodel.init(key, jfinish(
        {k: jnp.asarray(v) for k, v in pages_raw.items()}, table)))(
        jax.random.PRNGKey(0))
    return jmodel, jax.device_get(params), pages_raw, queries_raw


def test_slice_embeddings_and_ranks_match_jax(jax_side):
    jmodel, params, pages_raw, queries_raw = jax_side
    table = bicubic_table(PCFG.src_grid)

    def japply(raw):
        return np.asarray(jmodel.apply(params, jfinish(
            {k: jnp.asarray(v) for k, v in raw.items()}, table)))

    j_pages, j_queries = japply(pages_raw), japply(queries_raw)
    model = _port_model()
    from_jax_params(model, params)
    ptable = pos_table_tensor(PCFG.src_grid, "cpu")
    with torch.inference_mode():
        t_pages = model(finish_encode_batch(pages_raw, ptable))
        t_queries = model(finish_encode_batch(queries_raw, ptable))

    np.testing.assert_allclose(t_pages.numpy(), j_pages, atol=1e-4, rtol=0)
    np.testing.assert_allclose(t_queries.numpy(), j_queries, atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(np.linalg.norm(t_pages.numpy(), axis=1), 1.0,
                               rtol=1e-5)
    for q_t, q_j in ((t_queries, j_queries), (t_pages, j_pages)):
        _, idx = topk_single(q_t, t_pages, 4)
        _, jidx = jtopk(jnp.asarray(q_j), jnp.asarray(j_pages), 4)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _, idx = topk_single(t_pages, t_pages, 1)
    assert (idx.numpy()[:, 0] == np.arange(4)).all()


def test_loader_matches_exporter_and_rejects_strays(jax_side):
    """from_jax_params equals loading the exporter's state by name (with
    the token embedding renamed); an unknown or a missing name raises."""
    from visrag_tpu.models.hf_export import export_visrag_ret
    state = export_visrag_ret(jax_side[1]["params"])
    state["llm.embed_tokens.weight"] = state.pop("llm.embed_tokens.embedding")
    a, b = _port_model(), _port_model()
    load_visrag_ret_state(a, state)
    from_jax_params(b, jax_side[1])
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(x, y), name
    with pytest.raises(KeyError, match="unexpected"):
        load_visrag_ret_state(a, dict(state, **{"llm.lm_head.weight":
                                                np.zeros(1)}))
    with pytest.raises(KeyError, match="unexpected"):
        load_visrag_ret_state(a, export_visrag_ret(jax_side[1]["params"]))
    with pytest.raises(KeyError, match="missing"):
        load_visrag_ret_state(a, {k: v for k, v in state.items()
                                  if k != "vpm.norm.weight"})


def _img_bytes(rng):
    img = Image.fromarray(rng.integers(0, 255, (24, 18, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture()
def synth_data(tmp_path):
    """The corpus/queries/qrels of tests/test_drivers.py."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(0)
    corpus = pa.table({
        "corpus-id": [f"d{i}" for i in range(6)],
        "text": ["" for _ in range(6)],
        "image": [{"bytes": _img_bytes(rng)} for _ in range(6)],
    })
    pq.write_table(corpus, tmp_path / "corpus.parquet")
    queries = pa.table({
        "query-id": [f"q{i}" for i in range(3)],
        "query": [f"question number {i}" for i in range(3)],
    })
    pq.write_table(queries, tmp_path / "queries.parquet")
    (tmp_path / "qrels.tsv").write_text(
        "query-id\tcorpus-id\tscore\n" +
        "\n".join(f"q{i}\td{i}\t1" for i in range(3)) + "\n")
    return tmp_path


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_eval_retriever_driver_cpu(synth_data, tmp_path, quant):
    from visrag_tpu.retrieval.trec import load_from_trec
    from visrag_tpu_torch.driver.eval_retriever import main
    out = tmp_path / "out"
    rc = main(["--corpus", str(synth_data / "corpus.parquet"),
               "--queries", str(synth_data / "queries.parquet"),
               "--qrels", str(synth_data / "qrels.tsv"),
               "--output-dir", str(out), "--tiny", "--batch-size", "2",
               "--depth", "5", "--corpus-quant", quant, "--device", "cpu"])
    assert rc == 0
    assert (out / "test.trec").exists()
    metrics = json.loads((out / "metrics.json").read_text())
    assert set(metrics) == {"ndcg_cut_5", "recall_5", "mrr_5"}
    assert "recall_5" in (out / "test_result.log").read_text()
    run = load_from_trec(str(out / "test.trec"))
    assert len(run) == 3 and all(len(v) == 5 for v in run.values())

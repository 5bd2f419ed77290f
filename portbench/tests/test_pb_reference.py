"""The plain references against the port, at tiny sizes on the CPU, on
the benchmark's own weights (fp32 presets: they agree to rounding)."""

import numpy as np
import pytest
import torch
from PIL import Image

from portbench import harness, models
from portbench.reference import qwen25_vl as ref_qwen
from portbench.reference import scan as ref_scan
from portbench.reference import visrag_ret as ref_ret
from portbench.standin import StandInTokenizer


def _pages(rng, sizes):
    return [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            for w, h in sizes]


def test_retriever_reference_matches_the_encode_step():
    from visrag_tpu_torch.preprocess import (MockTokenizer,
                                             build_encode_batch)
    from visrag_tpu_torch.preprocess.device import (finish_encode_batch,
                                                    pos_table_tensor)
    cell = harness.load_cell("ret-embed")
    model, rcfg, pcfg = models.retriever(cell.config, 11, "cpu", tiny=True)
    rng = np.random.default_rng(0)
    pages = _pages(rng, [(12, 17), (24, 34), (19, 11), (13, 13)])
    tok = MockTokenizer()
    raw = build_encode_batch(tok, [("", p) for p in pages] + [
        ("a query about page two", None)], pcfg, n_slice_slots=40,
        device_mode=True)
    with torch.no_grad():
        got = model(finish_encode_batch(raw, pos_table_tensor(
            pcfg.src_grid, "cpu")))
    n = raw["attention_mask"].sum(1)
    items = [(im, raw["input_ids"][i, :n[i]].tolist())
             for i, im in enumerate(pages + [None])]
    want = ref_ret.embed(dict(model.named_parameters()), rcfg, items,
                         {"im_start_id": tok.im_start_id,
                          "im_end_id": tok.im_end_id}, "cpu")
    assert len(ref_ret.slice_page(pages[1], 8, 2, 9)) > 1   # sliced pages
    assert float((got - want).norm(dim=1).max()) < 1e-5


def test_scan_reference_matches_topk_single():
    from visrag_tpu_torch.retrieval.search import topk_single
    g = torch.Generator().manual_seed(0)
    corpus = torch.randn(3000, 64, generator=g)
    corpus /= corpus.norm(dim=1, keepdim=True)
    q = torch.randn(5, 64, generator=g)
    q /= q.norm(dim=1, keepdim=True)
    s, i = topk_single(q, corpus, 10)
    rs, ri = ref_scan.topk64(q, corpus, 10, block=700)
    assert torch.equal(i, ri)
    assert float((s.double() - rs).abs().max()) < 1e-6
    assert float((ref_scan.scores_of(q, corpus, i) - rs).abs().max()) < 1e-12


def _qwen_requests(tiny_model, tok, rng):
    from visrag_tpu_torch.driver.evisrag_predict import assemble_request
    cfg = tiny_model.cfg
    out = []
    for sizes in ([(56, 84), (112, 56)], [(84, 84)], []):
        imgs = [Image.fromarray(rng.integers(0, 256, (h, w, 3),
                                             dtype=np.uint8))
                for h, w in sizes]
        text = "what is the revenue " + " ".join(f"w{j}" for j in range(40))
        out.append((imgs, assemble_request(tok, tok, cfg, imgs, text)))
    return out


def test_qwen_reference_logits_match_the_forward():
    cell = harness.load_cell("evisrag-answer")
    model, rcfg, ids, vocab = models.qwen(cell.config, 5, "cpu", tiny=True)
    tok = StandInTokenizer(ids, vocab)
    for imgs, r in _qwen_requests(model, tok, np.random.default_rng(1)):
        ids_t = torch.as_tensor(r["input_ids"], dtype=torch.long)[None]
        kw = {}
        if imgs:
            kw = dict(positions=torch.as_tensor(r["positions"])[:, None],
                      vision_batch={k: torch.as_tensor(v) for k, v in
                                    r["vision_batch"].items()},
                      slot_map=torch.as_tensor(r["slot_map"])[None])
        with torch.no_grad():
            got, _ = model(ids_t, **kw)
        W = ref_qwen.Weights(dict(model.named_parameters()), "cpu")
        rows, grids = ref_qwen.tower(W, rcfg, imgs, 56 * 56, 1568000)
        pos = ref_qwen.mrope_positions(r["input_ids"].tolist(), grids,
                                       rcfg["image_token_id"], 2)
        if imgs:
            assert np.array_equal(pos.numpy(), r["positions"])
        want = ref_qwen.text_logits(W, rcfg, r["input_ids"].tolist(), rows,
                                    pos, 0)
        assert float((got[0] - want).abs().max()) < 1e-4


def test_qwen_served_tokens_sit_at_the_reference_best():
    from visrag_tpu_torch.driver.evisrag_predict import sampling_params
    from visrag_tpu_torch.serving.engine import Engine
    cell = harness.load_cell("evisrag-answer")
    model, rcfg, ids, vocab = models.qwen(cell.config, 6, "cpu", tiny=True)
    tok = StandInTokenizer(ids, vocab)
    reqs = _qwen_requests(model, tok, np.random.default_rng(2))
    eng = Engine(model, num_slots=4, max_len=512,
                 prompt_buckets=(128, 256, 512), chunked_prefill_tokens=128,
                 prefix_cache=True, eos_token_ids=[ids["eos_token_id"]])
    sp = sampling_params(tok, tok, 0.0, 20)
    outs = eng.generate([r for _, r in reqs], sampling=sp)
    state = dict(model.named_parameters())
    for (imgs, r), out in zip(reqs, outs):
        req = dict(images=imgs, input_ids=r["input_ids"].tolist(),
                   min_pixels=56 * 56, max_pixels=1568000, penalty=1.05,
                   bias=dict(sp.logit_bias))
        ref = ref_qwen.served_logits(state, rcfg, req, out, "cpu")
        assert ref.shape[0] == len(out)
        assert float(ref_qwen.token_gaps(ref, out).max()) < 1e-3


def test_processed_logits_penalise_seen_tokens_and_add_the_bias():
    logits = torch.tensor([[2.0, -1.0, 0.5, 3.0], [2.0, -1.0, 0.5, 3.0]])
    # prompt [1], then served [3, ...]: row 0 sees {1}, row 1 sees {1, 3}
    out = ref_qwen.processed(logits, [1, 3, 0], 1, 2.0, {2: -10.0})
    assert out[0].tolist() == [2.0, -2.0, -9.5, 3.0]
    assert out[1].tolist() == [2.0, -2.0, -9.5, 1.5]


@pytest.mark.gpu
def test_low_precision_reference_departs_from_fp32(cuda):
    """The controls' arithmetic on the card: int8 and fp8 w8a8 products
    differ from the float32 ones by far more than rounding."""
    for low in ("int8", "fp8"):
        W = ref_qwen.Weights({"l.weight": torch.randn(64, 64, device=cuda)},
                             cuda, low=low)
        x = torch.randn(8, 64, device=cuda)
        exact = x @ W("l.weight").T
        assert float((W.linear(x, "l") - exact).abs().max()) > 1e-3

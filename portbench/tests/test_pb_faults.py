"""A run with the timed path broken underneath comes out not correct: the
harness is driven at tiny sizes on the CPU (its look for a card skipped)
with a fault planted in the program after set-up."""

import pytest
import torch

from portbench import harness


def _run(cell, patch, monkeypatch=None):
    c = harness.load_cell(cell)
    return harness.run_cell(c, 5, 0.3, False, device="cpu", tiny=True,
                            patch=patch)


def _wrap_apply(run, change):
    apply = run.apply

    def broken(**raw):
        return change(apply(**raw))
    run.apply = broken


def _row_altered(reps):
    reps = reps.clone()
    reps[0] = reps[1]
    return reps


def _half_left_out(reps):
    reps = reps.clone()
    half = reps.shape[0] // 2
    reps[half:2 * half] = reps[:half]
    return reps


def _weights_touched(run):
    leaf = run.model.backbone.llm.norm.weight

    def hook(*a):
        with torch.no_grad():
            leaf.mul_(1.0001)
    run.model.backbone.llm.register_forward_pre_hook(hook)


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out",
                                   "weights_touched"])
def test_ret_embed_faults(fault):
    patch = {"answer_altered": lambda r: _wrap_apply(r, _row_altered),
             "half_left_out": lambda r: _wrap_apply(r, _half_left_out),
             "weights_touched": _weights_touched}[fault]
    out = _run("ret-embed", patch)
    assert not out.correct, out.compared


def _scan_id_altered(run):
    from visrag_tpu_torch.retrieval import search
    topk = search.topk_single

    def broken(q, corpus, k):
        s, i = topk(q, corpus, k)
        i = i.clone()
        i[:, 0] = (i[:, 0] + 1) % corpus.shape[0]
        return s, i
    return broken


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out"])
def test_ret_search_faults(fault, monkeypatch):
    from visrag_tpu_torch.retrieval import search
    if fault == "answer_altered":
        monkeypatch.setattr(search, "topk_single",
                            _scan_id_altered(None))
        patch = None
    else:
        def patch(r):
            _wrap_apply(r, _half_left_out)
    out = _run("ret-search", patch)
    assert not out.correct, out.compared


@pytest.mark.parametrize("fault", ["token_altered", "state_unchanged"])
def test_evisrag_answer_faults(fault, monkeypatch):
    from visrag_tpu_torch.serving import engine as engine_mod
    from visrag_tpu_torch.serving import paged_kv
    if fault == "token_altered":
        sample = engine_mod.sample_vec

        def broken(logits, *a, **kw):
            tok, logp = sample(logits, *a, **kw)
            return (tok + 1) % logits.shape[1], logp
        monkeypatch.setattr(engine_mod, "sample_vec", broken)
    else:
        # a decode step leaves the KV pools as they were: the new token's
        # K and V are never written
        monkeypatch.setattr(paged_kv, "write_token", lambda *a, **k: None)
    out = _run("evisrag-answer", None)
    assert not out.correct, out.compared

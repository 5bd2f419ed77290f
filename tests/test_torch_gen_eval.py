"""VisRAG-Gen's generation layer, drivers and HF-name loaders in
visrag_tpu_torch against the JAX package.

  * generation/strategies.py and generation/gen_eval.py (the port's
    copies): byte-equal concatenated images and equal outputs to the JAX
    functions on tests/test_generation.py's cases that need no reference
    checkout;
  * driver/generate_eval.run_generate_eval with stub generate_fns: the
    same accuracy and records as the JAX driver's for the four task types,
    on a TREC run and on oracle positives;
  * loaders: a tiny HF-named checkpoint (safetensors written here from a
    seeded port model, a `tokenizers` WordLevel tokenizer.json and
    tokenizer_config.json, config.json) loads into each generation model
    through generate_eval's loaders, every weight equal to the JAX
    package's own convert_* of the same files as the port carries JAX
    trees (whose logits tests/test_torch_gen_models.py holds to the JAX
    model's);
    config.json's rope scaling reaches driver/common.build_visrag_ret;
  * generate_eval.main (all three local backends, the four task types) and
    demo build-index / answer (retrieval, then MiniCPM-V 2.6 from a tiny
    checkpoint) end to end with --device cpu.
"""

import json
import random

import numpy as np
import pytest
import torch
from PIL import Image

from visrag_tpu.driver.generate_eval import \
    run_generate_eval as jrun_generate_eval
from visrag_tpu.generation import gen_eval as jg
from visrag_tpu.generation import strategies as js
from visrag_tpu_torch.driver import generate_eval as ge
from visrag_tpu_torch.generation import gen_eval as pg
from visrag_tpu_torch.generation import strategies as ps



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny models run fastest on one thread, and the suite's workers
    share the machine's cores: many threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(rng, w, h):
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


# ---- generation layer -------------------------------------------------------


def test_concat_images_byte_equal():
    rng = np.random.default_rng(0)
    sets = [[Image.new("RGB", (100, 200), (255, 0, 0)),
             Image.new("RGB", (50, 100), (0, 255, 0))],
            [_img(rng, 37, 81), _img(rng, 120, 45), _img(rng, 64, 64)],
            [_img(rng, 300, 90), _img(rng, 280, 100)]]
    for pages in sets:
        for name in ("horizontal_concat", "vertical_concat", "concat_pages"):
            a = getattr(js, name)(pages)
            b = getattr(ps, name)(pages)
            assert a.size == b.size and a.tobytes() == b.tobytes(), name


def test_strategies_match_jax():
    pages = [Image.new("RGB", (8, 8), (c, 0, 0)) for c in (10, 20, 30)]
    lps = {10: -5.0, 20: -0.1, 30: -4.0}
    for mod in (js, ps):
        assert mod.weighted_selection(["a", "b", "c"], [-5.0, -0.1, -4.0],
                                      [2.0, 1.5, 0.1]) == ("b", 1)
    assert ps.softmax([1.0, 2.0, 3.0]) == js.softmax([1.0, 2.0, 3.0])

    def run(mod, task, batched):
        calls = []

        def fn(prompt, images):
            calls.append((prompt, len(images)))
            c = images[0].getpixel((0, 0))[0] if images else 0
            return f"ans{c}", lps.get(c, -1.0)
        if batched:
            fn.batched = lambda items: [fn(p, im) for p, im in items]
        out = mod.generate_with_strategy(
            task, "q", pages, [2.0, 1.5, 0.1], generate_fn=fn,
            prompt_builder=lambda q, n: f"{q}/{n}", score_fn=fn)
        return out, calls
    for task in ("text", "page_concatenation", "multi_image",
                 "weighted_selection"):
        for batched in (False, True):
            assert run(ps, task, batched) == run(js, task, batched)
    with pytest.raises(ValueError):
        ps.generate_with_strategy("nope", "q", pages, [1.0], None, None)


def test_gen_eval_matches_jax(tmp_path):
    import pandas as pd
    r = random.Random(0)
    frags = ["42", "42.5%", "1,234", "the cat", "a", "isnt", "dont", "Im",
             "o'clock", "zero", "ten", "A. option", "x-y", "p/q", "(note)",
             "7.5", "End.", "3.14", "what's", "TAB\tsep", "new\nline", ";x",
             "x ;", "50%", "yall", "none"]
    for _ in range(300):
        s = " ".join(r.choices(frags, k=r.randint(1, 8)))
        assert pg.preprocess_text(s) == jg.preprocess_text(s), s
    for v in ("42", "4.5", "x", "", "1e3", "nan"):
        assert pg.is_numeric_data(v) == jg.is_numeric_data(v)
    for a, b in ((100.0, 104.9), (100.0, 105.1), (2, 2), (-10, -10.4)):
        assert pg.is_within_5_percent(a, b) == jg.is_within_5_percent(a, b)
    cases = [("ChartQA", "42%", "42"), ("ChartQA", "104", "100"),
             ("ChartQA", "106", "100"), ("ChartQA", "blue bar", "Blue Bar."),
             ("ChartQA", "0", "0"), ("ArxivQA", "b) because", "B"),
             ("ArxivQA", "c", "B"), ("PlotQA", "3.9", 4.0),
             ("PlotQA", "3.9", "4.0"), ("PlotQA", "four", "4"),
             ("MP-DocVQA", "Paris", ["paris", "PARIS city"]),
             ("MP-DocVQA", "nope", ["paris"]), ("InfoVQA", "12%", ["12"]),
             ("SlideVQA", "two", "2"), ("SlideVQA", "7", "seven")]
    for dataset, pred, answer in cases:
        want = jg.check_response(dataset, pred, answer)
        assert pg.check_response(dataset, pred, answer) == want
    docs = ["table one text", "table two text"]
    for ds in pg.DATASETS:
        ex = {"options": ["first", "second", "third"]}
        assert pg.build_text_prompt(ds, "what?", docs, ex) == \
            jg.build_text_prompt(ds, "what?", docs, ex)
        assert pg.build_image_prompt(ds, "what?", ex) == \
            jg.build_image_prompt(ds, "what?", ex)
    ex = {"options": ["A. first", "B. second"]}
    assert pg.build_image_prompt("ArxivQA", "q", ex) == \
        jg.build_image_prompt("ArxivQA", "q", ex)
    for qid, ds in (("doc-12-3", "InfoVQA"),
                    ("d1tcy6d2query_number7", "SlideVQA")):
        assert pg.oracle_docids(qid, ds) == jg.oracle_docids(qid, ds)
    run = {"a": 0.3, "b": 0.9, "c": 0.5}
    assert pg.topk_docids(run, 2) == jg.topk_docids(run, 2)
    with pytest.raises(ValueError):
        pg.topk_docids(run, 4)
    p = tmp_path / "t.csv"
    pd.DataFrame({"Year": [2019, 2020], "Sales": [1.5, 2.5],
                  "Region": ["EU", "US"]}).to_csv(p, index=False)
    assert pg.get_flatten_table(str(p)) == jg.get_flatten_table(str(p))


def _stub(seed):
    """A deterministic generate_fn(prompt, images) → (text, logprob) with
    a beam scorer `score_fn` and its `batched` form."""
    words = ["blue", "42", "B", "red", "12%", "two"]

    def pick(prompt, images):
        h = sum(map(ord, prompt)) + seed
        for im in images:
            h += sum(im.getpixel((0, 0)))
        return words[h % len(words)], -(h % 7) / 3.0

    def score_fn(prompt, images):
        text, lp = pick(prompt + "#", images)
        return text, lp
    score_fn.batched = lambda items: [score_fn(p, im) for p, im in items]
    gen = lambda prompt, images: pick(prompt, images)  # noqa: E731
    gen.score_fn = score_fn
    return gen


@pytest.mark.parametrize("positive", [False, True], ids=["trec", "oracle"])
@pytest.mark.parametrize("task", ["text", "page_concatenation",
                                  "weighted_selection", "multi_image"])
def test_run_generate_eval_matches_jax(task, positive):
    rng = np.random.default_rng(1)
    docids = [f"doc{i}" for i in range(6)]
    corpus = ({d: f"text of {d} with 42 and blue" for d in docids}
              if task == "text" else
              {d: _img(rng, 12 + i, 9) for i, d in enumerate(docids)})
    examples = [dict(qid=f"doc{i}-{i}", query=f"question {i}?",
                     answer=["blue", "42", ["B", "two"]][i % 3])
                for i in range(5)]
    run = {ex["qid"]: {d: float(rng.random()) for d in docids}
           for ex in examples}
    for dataset in ("InfoVQA", "ChartQA" if task != "text" else "MP-DocVQA"):
        kw = dict(task_type=task, topk=3, run=run,
                  use_positive_sample=positive, corpus=corpus)
        exs = examples if dataset == "InfoVQA" else \
            [dict(ex, answer="blue") for ex in examples]
        want = jrun_generate_eval(dataset, exs, _stub(0), **kw)
        got = ge.run_generate_eval(dataset, exs, _stub(0), **kw)
        assert got == want


# ---- tiny HF-named checkpoints --------------------------------------------

SPECIALS = ["<unk>", "<s>", "</s>", "<image>", "</image>", "<slice>",
            "</slice>", "<|im_start|>", "<|im_end|>"]
WORDS = ["what", "is", "the", "answer", "question", "a", "single", "word",
         "or", "phrase", "using", "Answer", "Question", "revenue", "chart",
         ":", ".", "?", "user", "assistant", "blue", "42"]


def _write_tokenizer(d):
    from tokenizers import Tokenizer, models, pre_tokenizers
    vocab = {t: i for i, t in enumerate(SPECIALS + WORDS)}
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tk.add_special_tokens(SPECIALS)
    tk.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "<unk>",
        "bos_token": "<s>", "eos_token": "</s>",
        "model_max_length": 8192}))


def _hf_names(kind, model):
    """A port generation model's state → the released checkpoint's names
    (with one ViT block past the depth and a rotary buffer, which loading
    drops), numpy."""
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    if kind == "minicpm":
        return dict(sd, **{"model.layers.0.self_attn.rotary_emb.inv_freq":
                           np.ones((8,), np.float32)})
    out = {}
    if kind == "minicpmv":
        vit = model.cfg.backbone.vit
        for k, v in sd.items():
            if k == "lm_head.weight":
                out["llm.lm_head.weight"] = v
            elif k.startswith("backbone.llm."):
                out["llm.model." + k[len("backbone.llm."):]] = v
            elif k == "backbone.vpm.patch_embed.proj.weight":
                out["vpm.patch_embed.proj.weight"] = v.reshape(
                    v.shape[0], 3, vit.patch_size, vit.patch_size)
            elif k == "backbone.vpm.pos_embed":
                out["vpm.pos_embed"] = v[None]
            else:
                out[k[len("backbone."):]] = v
        for k, v in list(out.items()):
            if k.startswith("vpm.blocks.0."):
                out[k.replace("blocks.0.", f"blocks.{vit.depth}.")] = v
        return out
    vit = model.cfg.vit
    e = vit.embed_dim
    for k, v in sd.items():
        if k.startswith("model.") or k == "lm_head.weight":
            out["llm." + k] = v
        elif k.startswith("resampler."):
            out[k] = v
        elif k == "vpm.patch_embed.proj.weight":
            out["vpm.embeddings.patch_embedding.weight"] = v.reshape(
                v.shape[0], 3, vit.patch_size, vit.patch_size)
        elif k == "vpm.patch_embed.proj.bias":
            out["vpm.embeddings.patch_embedding.bias"] = v
        elif k == "vpm.pos_embed":
            out["vpm.embeddings.position_embedding.weight"] = v
        elif k.startswith("vpm.norm."):
            out["vpm.post_layernorm." + k.split(".")[-1]] = v
        else:
            i, sub = k[len("vpm.blocks."):].split(".", 1)
            base = f"vpm.encoder.layers.{i}."
            mod, _, leaf = sub.rpartition(".")
            if mod == "attn.qkv":
                for j, n in enumerate("qkv"):
                    out[f"{base}self_attn.{n}_proj.{leaf}"] = v[j * e:
                                                               (j + 1) * e]
            else:
                out[base + {"norm1": "layer_norm1", "norm2": "layer_norm2",
                            "attn.proj": "self_attn.out_proj",
                            "mlp.fc1": "mlp.fc1",
                            "mlp.fc2": "mlp.fc2"}[mod] + "." + leaf] = v
    return out


def write_checkpoint(d, kind, seed=0, config=None):
    """A tiny checkpoint dir of a generation backend on random weights from
    `seed`. → the port model those weights came from."""
    from safetensors.numpy import save_file
    d.mkdir(parents=True, exist_ok=True)
    model = ge.random_generation_model(kind, tiny=True, device="cpu",
                                       seed=seed)
    save_file(_hf_names(kind, model), str(d / "model.safetensors"))
    _write_tokenizer(d)
    (d / "config.json").write_text(json.dumps(config or {}))
    return model


def _jax_model(kind, state):
    """The JAX generation model and its params from the JAX package's own
    converters on a released-name state dict."""
    from visrag_tpu.models import hf_loader as jl
    from visrag_tpu.models.minicpm import (MiniCPMForGeneration,
                                           MiniCPMGenConfig)
    from visrag_tpu.models.minicpmv import (MiniCPMVForGeneration,
                                            MiniCPMVGenConfig)
    from visrag_tpu.models.minicpmv26 import (MiniCPMV26Config,
                                              MiniCPMV26ForGeneration)
    if kind == "minicpm":
        return (MiniCPMForGeneration(MiniCPMGenConfig.tiny()),
                jl.convert_minicpm_lm(state))
    if kind == "minicpmv":
        cfg = MiniCPMVGenConfig.tiny()
        return (MiniCPMVForGeneration(cfg),
                {"backbone": jl.convert_minicpmv(
                    state, vit_depth=cfg.backbone.vit.depth),
                 "lm_head": {"weight": state["llm.lm_head.weight"]}})
    return (MiniCPMV26ForGeneration(MiniCPMV26Config.tiny()),
            jl.convert_minicpmv26(state))


@pytest.mark.parametrize("kind", ["minicpm", "minicpmv", "minicpmv26"])
def test_hf_checkpoint_loads_like_jax_convert(tmp_path, kind):
    """The loader's model holds the checkpoint's weights bit for bit, and
    every one equals the JAX package's convert_* tree of the same files,
    carried by generation_jax_params_to_state: the carrier under which
    tests/test_torch_gen_models.py holds the port's logits to the JAX
    model's (1e-4), so the loaded model gives the JAX convert_*'s
    logits."""
    from visrag_tpu.models.hf_loader import load_safetensors_dir
    from visrag_tpu_torch.models.hf_loader import \
        generation_jax_params_to_state
    src = write_checkpoint(tmp_path / kind, kind, seed=3)
    cfg = ge._model_class(kind, True)[1]
    model, tok = getattr(ge, f"load_{kind}")(str(tmp_path / kind), "cpu",
                                             cfg)
    state = model.state_dict()
    for name, t in src.state_dict().items():
        assert torch.equal(state[name], t), name
    assert tok.im_start_id == 3
    assert tok.eos_ids == [2, 8]        # </s> and <|im_end|>
    assert tok.decode([2, 9, 30]) == "what 42"
    _, jparams = _jax_model(kind, load_safetensors_dir(str(tmp_path / kind)))
    carried = generation_jax_params_to_state(jparams, model)
    # the JAX tree also keeps the LM's rotary buffer, which its model
    # never reads; the port drops it
    assert set(state) <= set(carried)
    assert all("rotary_emb" in k for k in set(carried) - set(state))
    for name, t in state.items():
        np.testing.assert_array_equal(
            np.asarray(carried[name]).reshape(t.shape), t.numpy(),
            err_msg=name)


def test_rope_scaling_and_weights_reach_build_visrag_ret(tmp_path):
    from visrag_tpu_torch.config import ModelConfig
    from visrag_tpu_torch.driver.common import (build_tokenizer,
                                                build_visrag_ret)
    from visrag_tpu_torch.preprocess.tokenize import HFTokenizerAdapter
    src = write_checkpoint(tmp_path / "ret", "minicpmv", config={
        "rope_scaling": {"type": "dynamic", "factor": 2.0}})
    model, _ = build_visrag_ret(ModelConfig(checkpoint=str(tmp_path / "ret")),
                                tiny=True, device="cpu")
    llm = model.cfg.backbone.llm
    assert (llm.rope_scaling_type, llm.rope_scaling_factor) == ("dynamic",
                                                                2.0)
    want = src.backbone.state_dict()
    for name, t in model.backbone.state_dict().items():
        assert torch.equal(t, want[name]), name
    tok = build_tokenizer(str(tmp_path / "ret"))
    assert isinstance(tok, HFTokenizerAdapter) and tok.im_start_id == 3
    (tmp_path / "ret" / "config.json").write_text(json.dumps(
        {"rope_scaling": {"type": "yarn", "factor": 2.0}}))
    with pytest.raises(ValueError, match="yarn"):
        build_visrag_ret(ModelConfig(checkpoint=str(tmp_path / "ret")),
                         tiny=True, device="cpu")


# ---- drivers end to end on the CPU ------------------------------------------


def _eval_inputs(tmp_path, rng):
    pages = tmp_path / "pages"
    pages.mkdir()
    for i in range(4):
        _img(rng, 20 + 3 * i, 16).save(pages / f"doc{i}.png")
    (tmp_path / "q.jsonl").write_text("".join(json.dumps(dict(
        qid=f"q{i}-0", query=f"what is the revenue {i}?", answer="42")) + "\n"
        for i in range(2)))
    (tmp_path / "run.trec").write_text("".join(
        f"q{i}-0\tQ0\tdoc{j}\t{j + 1}\t{1.0 - 0.1 * j - 0.01 * i}\tr\n"
        for i in range(2) for j in range(4)))
    (tmp_path / "text.jsonl").write_text("".join(json.dumps(dict(
        docid=f"doc{j}", text=f"the revenue was {j}")) + "\n"
        for j in range(4)))


@pytest.mark.parametrize("backend,task,ckpt", [
    ("minicpmv", "page_concatenation", False),
    ("minicpmv", "weighted_selection", True),
    ("minicpmv26", "multi_image", False),
    ("minicpm", "text", True)])
def test_generate_eval_main_cpu(tmp_path, backend, task, ckpt):
    _eval_inputs(tmp_path, np.random.default_rng(2))
    argv = ["--dataset-name", "InfoVQA", "--queries",
            str(tmp_path / "q.jsonl"), "--trec", str(tmp_path / "run.trec"),
            "--task-type", task, "--topk", "2", "--backend", backend,
            "--max-new-tokens", "4", "--output-dir", str(tmp_path / "out"),
            "--device", "cpu", "--tiny", "--corpus-dir",
            str(tmp_path / ("text.jsonl" if task == "text" else "pages"))]
    if ckpt:
        write_checkpoint(tmp_path / "ckpt", backend)
        argv += ["--checkpoint", str(tmp_path / "ckpt")]
    assert ge.main(argv) == 0
    result = json.loads((tmp_path / "out" / "result.json").read_text())
    assert result["n"] == 2 and 0.0 <= result["accuracy"] <= 1.0
    lines = (tmp_path / "out" / f"InfoVQA_{task}.jsonl").read_text()
    assert len(lines.splitlines()) == 2


def test_demo_build_index_and_answer_cpu(tmp_path):
    from visrag_tpu_torch.driver import demo
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "note.txt").write_text("the revenue in 2020 was 42 million\n"
                                   * 30)
    _img(np.random.default_rng(5), 30, 40).save(docs / "page.png")
    idx = tmp_path / "idx"
    assert demo.main(["build-index", "--input", str(docs), "--output",
                      str(idx), "--tiny", "--device", "cpu"]) == 0
    assert np.load(idx / "reps.npy").shape[0] == 2
    write_checkpoint(tmp_path / "gen", "minicpmv26")
    assert demo.main(["answer", "--index", str(idx), "--query",
                      "what was the 2020 revenue", "--topk", "2", "--tiny",
                      "--device", "cpu", "--gen-checkpoint",
                      str(tmp_path / "gen"), "--max-new-tokens", "3"]) == 0
    ans = json.loads((idx / "answer.json").read_text())
    assert len(ans["retrieved"]) == 2 and isinstance(ans["answer"], str)

"""VisRAG-Gen evaluation driver: generation over retrieved pages, scored
with the reference's per-dataset protocol.

Counterpart of visrag_tpu/driver/generate_eval.py, with its CLI plus
--device (default cuda; the CPU only when asked) and --tiny. Task types
text / page_concatenation / weighted_selection / multi_image; top-k pages
from TREC runs or oracle positives; per-dataset prompts and answer
checking (generation/gen_eval.py). Backends:

  * minicpmv: MiniCPM-V 2.0 on the serving engine (greedy), with the
    weighted-selection strategy's beam scoring (num_beams=3,
    repetition_penalty=1.2) through Engine.beam_search_batched;
  * minicpmv26: MiniCPM-V 2.6 (SigLIP + Qwen2-7B), multi-image prompts in
    ChatML, uint8 device-mode pixels;
  * minicpm: the MiniCPM-2B LM alone (the OCR-text baseline, task text);
  * gpt4o: the reference's GPT-4o call (network; `openai` imported only
    when chosen).

Each local backend is a loader (checkpoint → model + tokenizer:
`load_minicpmv`, `load_minicpmv26`, `load_minicpm`) and a builder (model,
tokenizer → generate_fn(prompt, images) → (text, cum_logprob):
`build_minicpmv`, `build_minicpmv26`, `build_minicpm`). --tiny takes the
tiny configs: a tiny checkpoint's weights, or without --checkpoint random
ones with the MockTokenizer.

    python -m visrag_tpu_torch.driver.generate_eval --dataset-name ChartQA \
        --queries queries.jsonl --corpus-dir pages/ --trec runs/ChartQA \
        --task-type multi_image --topk 3 --backend minicpmv26 \
        --checkpoint minicpmv26_dir --output-dir out/
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

GEN_SEQ_LEN = 2048        # MiniCPM-V 2.0 page prompt cap
TEXT_SEQ_LEN = 4096       # MiniCPM-2B text prompt cap
GEN26_SEQ_LEN = 8192      # MiniCPM-V 2.6 (several pages in one prompt)
TINY_SCALE_RESOLUTION = 8
TINY_MAX_PATCHES = 64


def run_generate_eval(dataset: str, examples: Sequence[dict],
                      generate_fn: Callable, *, task_type: str, topk: int = 3,
                      run: Optional[Dict[str, Dict[str, float]]] = None,
                      use_positive_sample: bool = False,
                      corpus: Optional[dict] = None,
                      table_dir: Optional[str] = None
                      ) -> Tuple[float, List[dict]]:
    """The protocol core, backend-agnostic.

    examples: [{qid, query, answer, options?}]; corpus: docid → PIL image
    (image tasks) or text (text task); generate_fn(prompt, images) →
    (text, seq_logprob), with an optional `score_fn` attribute (the
    weighted-selection beam scorer). → (accuracy, per-query records)."""
    from ..generation.gen_eval import (build_image_prompt, build_text_prompt,
                                       check_response, get_flatten_table,
                                       oracle_docids, topk_docids)
    from ..generation.strategies import generate_with_strategy

    n_correct = 0
    records: List[dict] = []
    for ex in examples:
        qid, query, answer = ex["qid"], ex["query"], ex["answer"]
        if use_positive_sample:
            docids = oracle_docids(qid, dataset)
            scores = [1.0 / len(docids)] * len(docids)
        else:
            docids, scores = topk_docids(run[qid], topk)
        if task_type == "text":
            if dataset == "ChartQA":
                if table_dir is None:
                    raise ValueError("ChartQA text task needs --table-dir")
                docs = [get_flatten_table(os.path.join(
                    table_dir, d.split(".")[0] + ".csv")) for d in docids]
            else:
                docs = [corpus[d] for d in docids]
            prompt = build_text_prompt(dataset, query, docs, ex)
            pred, _ = generate_fn(prompt, [])
        else:
            pages = [corpus[d] for d in docids]
            pred = generate_with_strategy(
                task_type, query, pages, scores, generate_fn,
                lambda q, n: build_image_prompt(dataset, q, ex),
                score_fn=getattr(generate_fn, "score_fn", None))
        pred = pred if pred is not None else ""
        correct, npred, nans = check_response(dataset, pred, answer)
        n_correct += correct
        records.append({"qid": qid, "pred": npred, "answer": nans,
                        "correct": correct})
    return n_correct / max(len(examples), 1), records


# --- models: loaders and random weights -------------------------------------


def _on_device(model_cls, cfg, device):
    with torch.device("meta"):
        model = model_cls(cfg)
    return model.to_empty(device=torch.device(device))


def random_generation_model(backend: str, *, tiny: bool = False,
                            device="cuda", seed: int = 0):
    """A backend's model on random weights from `seed` (the JAX package's
    initialiser families, driver/common.init_weights_), eval mode."""
    from .common import init_weights_
    cls, cfg = _model_class(backend, tiny)
    model = _on_device(cls, cfg, device)
    init_weights_(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval()


def _model_class(backend: str, tiny: bool):
    if backend == "minicpmv":
        from ..models.minicpmv import MiniCPMVForGeneration, MiniCPMVGenConfig
        return MiniCPMVForGeneration, (MiniCPMVGenConfig.tiny() if tiny
                                       else MiniCPMVGenConfig())
    if backend == "minicpmv26":
        from ..models.minicpmv26 import (MiniCPMV26Config,
                                         MiniCPMV26ForGeneration)
        return MiniCPMV26ForGeneration, (MiniCPMV26Config.tiny() if tiny
                                         else MiniCPMV26Config())
    if backend == "minicpm":
        from ..models.minicpm import MiniCPMForGeneration, MiniCPMGenConfig
        return MiniCPMForGeneration, (MiniCPMGenConfig.tiny() if tiny
                                      else MiniCPMGenConfig())
    raise ValueError(f"no local model for backend {backend!r}")


def _load(backend: str, checkpoint: str, device, cfg=None):
    """(model with the checkpoint's weights by HF name, eval mode, the
    checkpoint's tokenizer behind HFTokenizerAdapter). cfg: the model
    config (default: the released geometry, the MiniCPM LM's rope scaling
    from config.json)."""
    import dataclasses

    from ..models.hf_loader import (load_generation_hf_state,
                                    load_safetensors_dir)
    from ..preprocess.tokenize import HFTokenizerAdapter
    from .common import get_tokenizer, rope_scaled
    cls, default = _model_class(backend, False)
    cfg = cfg or default
    if backend == "minicpmv":
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, llm=rope_scaled(cfg.backbone.llm, checkpoint)))
    elif backend == "minicpm":
        cfg = dataclasses.replace(cfg, llm=rope_scaled(cfg.llm, checkpoint))
    model = _on_device(cls, cfg, device)
    load_generation_hf_state(model, load_safetensors_dir(checkpoint))
    return model.eval(), HFTokenizerAdapter(
        get_tokenizer(checkpoint, trust_remote_code=True))


def load_minicpmv(checkpoint: str, device="cuda", cfg=None):
    """MiniCPM-V 2.0 from a checkpoint dir → (model, tokenizer)."""
    return _load("minicpmv", checkpoint, device, cfg)


def load_minicpmv26(checkpoint: str, device="cuda", cfg=None):
    """MiniCPM-V 2.6 from a checkpoint dir → (model, tokenizer)."""
    return _load("minicpmv26", checkpoint, device, cfg)


def load_minicpm(checkpoint: str, device="cuda", cfg=None):
    """MiniCPM-2B (the LM alone) from a checkpoint dir → (model,
    tokenizer)."""
    return _load("minicpm", checkpoint, device, cfg)


# --- builders: model + tokenizer → generate_fn ------------------------------
# tok: the pipeline's tokenizer (HFTokenizerAdapter or MockTokenizer), whose
# decode(ids) gives the answer text and eos_ids end a generation


def pipeline_config(model, *, tiny: bool = False, max_slice_nums: int = 9):
    """The page pipeline's config for a MiniCPM-V 2.0 / 2.6 generation
    model: its query count, patch size and pos grid; 448 px slices of at
    most 1152 patches, or (tiny) 8 px slices of at most 64."""
    from ..models.minicpmv26 import MiniCPMV26Config
    from ..preprocess.pipeline import PipelineConfig
    cfg = model.cfg
    v26 = isinstance(cfg, MiniCPMV26Config)
    if not v26:
        cfg = cfg.backbone
    return PipelineConfig(
        seq_len=GEN26_SEQ_LEN if v26 else GEN_SEQ_LEN,
        query_num=cfg.query_num, patch_size=cfg.vit.patch_size,
        src_grid=cfg.vit.pos_grid,
        scale_resolution=TINY_SCALE_RESOLUTION if tiny
        else cfg.scale_resolution,
        max_slice_nums=max_slice_nums,
        max_patches=TINY_MAX_PATCHES if tiny else 1152)


def build_minicpmv(model, tok, *, max_new_tokens: int = 20, pcfg=None):
    """MiniCPM-V 2.0 on the serving engine. → generate_fn(prompt, images)
    → (text, cum_logprob) of greedy decoding, with `score_fn` (one page's
    beam-scored answer: num_beams=3, repetition_penalty=1.2, the reference's
    sampling=False config) and `score_fn.batched` (all of a query's pages
    in one (pages x beams)-batched decode loop). pcfg: the page pipeline
    (default pipeline_config(model))."""
    from ..preprocess.pipeline import build_encode_batch
    from ..serving.engine import Engine
    from ..serving.sampling import SamplingParams
    pcfg = pcfg or pipeline_config(model)
    engine = Engine(model, num_slots=4, max_len=4096,
                    prompt_buckets=(1024, 2048, 4096),
                    eos_token_ids=tok.eos_ids)
    sampling = SamplingParams(temperature=0.0, max_tokens=max_new_tokens)

    def request(prompt, images):
        # MiniCPM-V 2.0 takes one image (page_concatenation folds pages
        # first; multi_image runs on 2.6)
        if len(images) > 1:
            raise ValueError("the minicpmv backend takes at most one image")
        arrs = build_encode_batch(tok, [(prompt, images[0] if images
                                          else None)], pcfg)
        s = int(arrs["attention_mask"][0].sum())
        if not images:
            return dict(input_ids=arrs["input_ids"][0, :s])
        return dict(input_ids=arrs["input_ids"][0, :s],
                    vision_batch={k: arrs[k] for k in (
                        "patches", "patch_mask", "pos_matrix", "grid_h",
                        "grid_w")},
                    slot_map=arrs["slot_map"][0, :s])

    def generate_fn(prompt, images):
        req = engine.generate_detailed([request(prompt, images)],
                                       sampling=sampling)[0]
        return tok.decode(req.output_ids), req.cum_logprob

    def score_fn(prompt, images):
        ids, score = engine.beam_search(
            request(prompt, images), num_beams=3,
            max_new_tokens=max_new_tokens, repetition_penalty=1.2)
        return tok.decode(ids), score

    def score_batch_fn(items):
        results = engine.beam_search_batched(
            [request(p, imgs) for p, imgs in items], num_beams=3,
            max_new_tokens=max_new_tokens, repetition_penalty=1.2)
        return [(tok.decode(ids), score) for ids, score in results]

    score_fn.batched = score_batch_fn
    generate_fn.score_fn = score_fn
    generate_fn.engine, generate_fn.request = engine, request
    return generate_fn


def chatml(body: str) -> str:
    return ("<|im_start|>user\n" + body +
            "<|im_end|>\n<|im_start|>assistant\n")


def build_minicpmv26(model, tok, *, max_new_tokens: int = 20, pcfg=None):
    """MiniCPM-V 2.6 on the serving engine, greedy; every page of a call in
    one ChatML prompt (multi_image), shipped as uint8 device-mode pixels
    that the model finishes on its device. → generate_fn(prompt, images)
    → (text, cum_logprob). pcfg: as build_minicpmv's."""
    from ..preprocess.pipeline import build_multi_image_batch
    from ..preprocess.tokenize import tokenize_prompt
    from ..serving.engine import Engine
    from ..serving.sampling import SamplingParams
    pcfg = pcfg or pipeline_config(model)
    engine = Engine(model, num_slots=4, max_len=8192,
                    prompt_buckets=(2048, 4096, 8192),
                    eos_token_ids=tok.eos_ids)
    sampling = SamplingParams(temperature=0.0, max_tokens=max_new_tokens)

    def request(prompt, images):
        if not images:
            return dict(input_ids=tokenize_prompt(
                tok, chatml(prompt), pcfg.seq_len, add_bos=False))
        b = build_multi_image_batch(
            tok, images, lambda phs: chatml("\n".join(phs) + "\n" + prompt),
            pcfg, device_mode=True)
        s = int(b["attention_mask"][0].sum())
        return dict(input_ids=b["input_ids"][0, :s],
                    vision_batch={k: b[k] for k in (
                        "pixels", "patch_mask", "grid_h", "grid_w")},
                    slot_map=b["slot_map"][0, :s])

    def generate_fn(prompt, images):
        out = engine.generate_detailed([request(prompt, images)],
                                       sampling=sampling)[0]
        return tok.decode(out.output_ids), out.cum_logprob

    generate_fn.engine, generate_fn.request = engine, request
    return generate_fn


def build_minicpm(model, tok, *, max_new_tokens: int = 20):
    """The MiniCPM-2B LM alone on the serving engine, greedy (task text).
    → generate_fn(prompt, []) → (text, cum_logprob)."""
    from ..preprocess.tokenize import tokenize_prompt
    from ..serving.engine import Engine
    from ..serving.sampling import SamplingParams
    engine = Engine(model, num_slots=4, max_len=4096,
                    prompt_buckets=(1024, 2048, 4096),
                    eos_token_ids=tok.eos_ids)
    sampling = SamplingParams(temperature=0.0, max_tokens=max_new_tokens)

    def request(prompt, images):
        if images:
            raise ValueError("the minicpm backend is text only (task text)")
        # the prompt's head, leaving the answer room in the 4096 positions
        return dict(input_ids=tokenize_prompt(
            tok, prompt, TEXT_SEQ_LEN - max_new_tokens))

    def generate_fn(prompt, images):
        out = engine.generate_detailed([request(prompt, images)],
                                       sampling=sampling)[0]
        return tok.decode(out.output_ids), out.cum_logprob

    generate_fn.engine, generate_fn.request = engine, request
    return generate_fn


def build_backend(backend: str, model, tok, *, max_new_tokens: int,
                  max_slice_nums: int = 9, tiny: bool = False):
    if backend == "minicpm":
        return build_minicpm(model, tok, max_new_tokens=max_new_tokens)
    build = build_minicpmv if backend == "minicpmv" else build_minicpmv26
    return build(model, tok, max_new_tokens=max_new_tokens,
                 pcfg=pipeline_config(model, tiny=tiny,
                                      max_slice_nums=max_slice_nums))


# --- CLI --------------------------------------------------------------------


def _load_run(trec: str) -> Dict[str, Dict[str, float]]:
    import glob

    from ..retrieval.trec import load_from_trec
    run = {}
    paths = [trec] if os.path.isfile(trec) else \
        sorted(glob.glob(os.path.join(trec, "*.trec")))
    for p in paths:
        run.update(load_from_trec(p))
    return run


class _LazyCorpus(dict):
    """docid → RGB page image from <dir>/<docid>[.png|.jpg|.jpeg], read on
    first use."""

    def __init__(self, root: str):
        super().__init__()
        self.root = root

    def __missing__(self, docid):
        from PIL import Image
        for ext in (".png", ".jpg", ".jpeg", ""):
            p = os.path.join(self.root, docid + ext)
            if os.path.exists(p):
                img = Image.open(p).convert("RGB")
                self[docid] = img
                return img
        raise KeyError(docid)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset-name", required=True)
    ap.add_argument("--queries", required=True,
                    help="jsonl rows {qid, query, answer, options?}")
    ap.add_argument("--corpus-dir", default=None,
                    help="directory of <docid>.png page images, or a jsonl "
                         "of {docid, text} for --task-type text")
    ap.add_argument("--trec", default=None, help="TREC run file/dir")
    ap.add_argument("--use-positive-sample", action="store_true")
    ap.add_argument("--task-type", default="multi_image",
                    choices=["text", "page_concatenation",
                             "weighted_selection", "multi_image"])
    ap.add_argument("--topk", type=int, default=3)
    ap.add_argument("--table-dir", default=None)
    ap.add_argument("--backend", default="minicpmv",
                    choices=["minicpmv", "minicpmv26", "minicpm", "gpt4o"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--openai-api-key", default=None)
    ap.add_argument("--max-new-tokens", type=int, default=20)
    ap.add_argument("--max-slice-nums", type=int, default=9)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the local backends (the CPU only "
                         "when asked: --device cpu)")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny model config: a tiny checkpoint's, or "
                         "random weights with the MockTokenizer without "
                         "--checkpoint")
    args = ap.parse_args(argv)

    examples = [json.loads(line) for line in open(args.queries)]
    run = None if args.use_positive_sample else _load_run(args.trec)
    corpus = None
    if args.task_type == "text" and args.dataset_name != "ChartQA":
        corpus = {}
        for line in open(args.corpus_dir):
            row = json.loads(line)
            corpus[row["docid"]] = row["text"]
    elif args.task_type != "text":
        corpus = _LazyCorpus(args.corpus_dir)

    if args.backend == "gpt4o":
        from ..generation.gen_eval import gpt4o_backend
        call = gpt4o_backend(api_key=args.openai_api_key)

        def generate_fn(prompt, images):
            if images:
                raise ValueError("the gpt4o backend here is text only "
                                 "(task text)")
            return call(prompt, args.max_new_tokens), 0.0
    else:
        if args.checkpoint:
            model, tok = _load(args.backend, args.checkpoint, args.device,
                               _model_class(args.backend, True)[1]
                               if args.tiny else None)
        elif args.tiny:
            from ..preprocess.tokenize import MockTokenizer
            model = random_generation_model(args.backend, tiny=True,
                                            device=args.device)
            tok = MockTokenizer()
        else:
            raise SystemExit("--checkpoint (or --tiny) is required for the "
                             f"{args.backend} backend")
        generate_fn = build_backend(args.backend, model, tok,
                                    max_new_tokens=args.max_new_tokens,
                                    max_slice_nums=args.max_slice_nums,
                                    tiny=args.tiny)

    acc, records = run_generate_eval(
        args.dataset_name, examples, generate_fn, task_type=args.task_type,
        topk=args.topk, run=run, use_positive_sample=args.use_positive_sample,
        corpus=corpus, table_dir=args.table_dir)

    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir,
                           f"{args.dataset_name}_{args.task_type}.jsonl"),
              "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    result = {"dataset": args.dataset_name, "task_type": args.task_type,
              "topk": args.topk, "n": len(records), "accuracy": acc}
    with open(os.path.join(args.output_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

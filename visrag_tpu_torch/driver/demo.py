"""Interactive RAG demo: build-index + answer.

Counterpart of visrag_tpu/driver/demo.py (the reference demo's
build_index.py and answer.py), with its CLI plus --device (default cuda;
the CPU only when asked). build-index rasterizes documents into page
images (preprocess/rasterize.py: images and plain text here; PDFs need
PyMuPDF or pdf2image), encodes each page with VisRAG-Ret and writes
reps.npy + index2img_filename.txt; answer encodes the query, ranks the
pages by inner product and, given --gen-checkpoint, answers over the top-k
page images with MiniCPM-V 2.6 (driver/generate_eval.build_minicpmv26).

    python -m visrag_tpu_torch.driver.demo build-index --input docs/ \
        --output idx/
    python -m visrag_tpu_torch.driver.demo answer --index idx/ \
        --query "..." [--topk 3] [--gen-checkpoint minicpmv26_dir]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

QUERY_INSTRUCTION = "Represent this query for retrieving relevant documents: "


def _encoder(args):
    """items [(text, image or None)] → (n, dim) float32 embeddings."""
    from ..config import ModelConfig
    from ..preprocess.device import finish_encode_batch, pos_table_tensor
    from ..preprocess.pipeline import build_encode_batch
    from .common import build_tokenizer, build_visrag_ret

    device = torch.device(args.device)
    model, pcfg = build_visrag_ret(ModelConfig(checkpoint=args.checkpoint),
                                   tiny=args.tiny, device=device)
    tok = build_tokenizer(args.checkpoint)
    table = pos_table_tensor(pcfg.src_grid, device)

    @torch.inference_mode()
    def encode(items):
        slots = max(1, len(items)) * pcfg.max_slices_per_page
        raw = build_encode_batch(tok, items, pcfg, n_slice_slots=slots,
                                 device_mode=True)
        return model(finish_encode_batch(raw, table)).float().cpu().numpy()

    return encode


def build_index(args):
    from ..preprocess.rasterize import file_to_images

    encode = _encoder(args)
    img_dir = os.path.join(args.output, "pages")
    os.makedirs(img_dir, exist_ok=True)
    names, reps = [], []
    inputs = ([os.path.join(args.input, f)
               for f in sorted(os.listdir(args.input))]
              if os.path.isdir(args.input) else [args.input])
    for path in inputs:
        for pi, img in enumerate(file_to_images(path, dpi=args.dpi)):
            name = f"{os.path.basename(path)}.page{pi}.png"
            img.save(os.path.join(img_dir, name))
            reps.append(encode([("", img)])[0])
            names.append(name)
            print(f"indexed {name}", file=sys.stderr)
    np.save(os.path.join(args.output, "reps.npy"),
            np.stack(reps) if reps else np.zeros((0, 1), np.float32))
    with open(os.path.join(args.output, "index2img_filename.txt"), "w") as f:
        f.write("\n".join(names))
    print(f"index: {len(names)} pages -> {args.output}", file=sys.stderr)
    return 0


def answer(args):
    encode = _encoder(args)
    reps = np.load(os.path.join(args.index, "reps.npy"))
    with open(os.path.join(args.index, "index2img_filename.txt")) as f:
        names = f.read().splitlines()
    q = encode([(QUERY_INSTRUCTION + args.query, None)])[0]
    scores = reps @ q
    top = np.argsort(-scores)[:args.topk]
    result = {"query": args.query,
              "retrieved": [{"page": names[i], "score": float(scores[i])}
                            for i in top]}
    if args.gen_checkpoint:
        from PIL import Image

        from ..models.minicpmv26 import MiniCPMV26Config
        from .generate_eval import (build_minicpmv26, load_minicpmv26,
                                    pipeline_config)
        model, tok = load_minicpmv26(
            args.gen_checkpoint, args.device,
            MiniCPMV26Config.tiny() if args.tiny else None)
        gen = build_minicpmv26(model, tok,
                               max_new_tokens=args.max_new_tokens,
                               pcfg=pipeline_config(model, tiny=args.tiny))
        pages = [Image.open(names[i] if os.path.isabs(names[i]) else
                            os.path.join(args.index, "pages", names[i]))
                 .convert("RGB") for i in top]
        result["answer"], _ = gen(args.query, pages)
    print(json.dumps(result, indent=1))
    with open(os.path.join(args.index, "answer.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build-index")
    b.add_argument("--input", required=True)
    b.add_argument("--output", required=True)
    b.add_argument("--dpi", type=int, default=200)
    a = sub.add_parser("answer")
    a.add_argument("--index", required=True)
    a.add_argument("--query", required=True)
    a.add_argument("--topk", type=int, default=3)
    a.add_argument("--gen-checkpoint", default="",
                   help="MiniCPM-V 2.6 dir: answer over the top-k page "
                        "images; retrieval only if empty")
    a.add_argument("--max-new-tokens", type=int, default=256)
    for p in (b, a):
        p.add_argument("--checkpoint", default="",
                       help="VisRAG-Ret dir (random weights if empty)")
        p.add_argument("--tiny", action="store_true",
                       help="the tiny model configs")
        p.add_argument("--device", default="cuda",
                       help="torch device (the CPU only when asked)")
    args = ap.parse_args(argv)
    return build_index(args) if args.cmd == "build-index" else answer(args)


if __name__ == "__main__":
    sys.exit(main())

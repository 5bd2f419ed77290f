"""Pseudo query-answer synthesis from page images.

Counterpart of tools/synthesize_queries.py (the data-synthesis role of the
reference's batch_api.py: up to 6 question-answer pairs a page, JSON
output) with the same CLI and the same JSONL records, {"page", "query",
"answer"}, appended to --output. The local generator is the port's
Qwen2.5-VL on the serving engine (4 slots, 8192 tokens, prompt buckets
2048/4096/8192, temperature 0.2 drawn from the engine's generator, seeded
at 0); an OpenAI-compatible endpoint can be used instead with
--api-base (it needs the network).

    python -m visrag_tpu_torch.driver.synthesize_queries --pages pages/ \
        --checkpoint qwen25vl_dir --output pairs.jsonl [--device cuda]

The request is evisrag_predict.assemble_request's (chat template, one
image pad per merged vision token, mrope positions, slot map, uint8
pixels) at the JAX tool's max_pixels, 14·14·4·1280 = 1,003,520 (the
default of its prepare_vision_batch), so the token counts are the JAX
tool's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

SYNTH_PROMPT = (
    "You are given an image of a document page. Write up to 6 question-answer "
    "pairs that can be answered from this page alone. Questions must be "
    "specific and self-contained; answers short and factual. Output strict "
    "JSON: [{\"question\": ..., \"answer\": ...}, ...] and nothing else.")
MAX_PIXELS = 14 * 14 * 4 * 1280
ENGINE_SETTINGS = dict(num_slots=4, max_len=8192,
                       prompt_buckets=(2048, 4096, 8192))
TEMPERATURE = 0.2
IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".webp")


def build_request(processor, tok, cfg, img) -> dict:
    """One page's request: kwargs of Engine.add_request (numpy arrays)."""
    from .evisrag_predict import assemble_request
    return assemble_request(processor, tok, cfg, [img], SYNTH_PROMPT,
                            max_pixels=MAX_PIXELS)


def build_engine(model, eos_token_id: int, seed: int = 0):
    """The serving engine with the tool's settings; its generator draws
    the temperature-0.2 samples from `seed`."""
    from ..serving.engine import Engine
    return Engine(model, eos_token_ids=[eos_token_id], seed=seed,
                  **ENGINE_SETTINGS)


def make_local_generator(processor, tok, model, max_tokens: int,
                         seed: int = 0):
    """→ generate(img) → the model's text for one page."""
    from ..serving.sampling import SamplingParams
    engine = build_engine(model, tok.eos_token_id, seed)
    sampling = SamplingParams(temperature=TEMPERATURE, max_tokens=max_tokens)

    def generate(img):
        req = build_request(processor, tok, model.cfg, img)
        outs = engine.generate([req], sampling=sampling)
        return tok.decode(outs[0], skip_special_tokens=True)

    return generate


def parse_pairs(text: str):
    """The JSON list in a generation (from its first '[' to its last
    ']'), or None when it does not parse."""
    try:
        return json.loads(text[text.find("["):text.rfind("]") + 1])
    except (ValueError, json.JSONDecodeError):
        return None


def write_pairs(out, page: str, pairs) -> int:
    """Append one record per pair that has a question and an answer. →
    the number written."""
    n = 0
    for p in pairs:
        if isinstance(p, dict) and "question" in p and "answer" in p:
            out.write(json.dumps({"page": page, "query": p["question"],
                                  "answer": p["answer"]}) + "\n")
            n += 1
    out.flush()
    return n


def _api_generator(args):
    import base64
    import io
    import urllib.request

    def generate(img):
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        b64 = base64.b64encode(buf.getvalue()).decode()
        payload = json.dumps({
            "model": args.model,
            "messages": [{"role": "user", "content": [
                {"type": "text", "text": SYNTH_PROMPT},
                {"type": "image_url",
                 "image_url": {"url": f"data:image/png;base64,{b64}"}}]}],
            "max_tokens": args.max_tokens,
        }).encode()
        req = urllib.request.Request(
            args.api_base.rstrip("/") + "/chat/completions", data=payload,
            headers={"Content-Type": "application/json",
                     "Authorization": "Bearer " +
                     os.environ.get("OPENAI_API_KEY", "")})
        with urllib.request.urlopen(req, timeout=120) as r:
            data = json.load(r)
        return data["choices"][0]["message"]["content"]

    return generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pages", required=True, help="dir of page images")
    ap.add_argument("--output", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="local Qwen2.5-VL checkpoint dir")
    ap.add_argument("--api-base", default=None,
                    help="OpenAI-compatible endpoint (needs network)")
    ap.add_argument("--model", default="gpt-4o")
    ap.add_argument("--max-tokens", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from PIL import Image

    paths = [os.path.join(args.pages, f) for f in sorted(os.listdir(args.pages))
             if f.lower().endswith(IMAGE_SUFFIXES)]
    if args.api_base:
        generate = _api_generator(args)
    elif args.checkpoint:
        from .common import load_qwen25_vl_checkpoint
        generate = make_local_generator(
            *load_qwen25_vl_checkpoint(args.checkpoint, args.device),
            args.max_tokens)
    else:
        ap.error("need --checkpoint (local VLM) or --api-base")

    with open(args.output, "a") as out:
        for path in paths:
            text = generate(Image.open(path).convert("RGB"))
            pairs = parse_pairs(text)
            if pairs is None:
                print(f"unparseable output for {path}", file=sys.stderr)
                continue
            write_pairs(out, os.path.basename(path), pairs)
            print(f"synthesized {len(pairs)} pairs for {path}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

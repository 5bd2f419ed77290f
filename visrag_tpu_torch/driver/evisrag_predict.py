"""EVisRAG batch prediction driver.

Counterpart of visrag_tpu/driver/evisrag_predict.py: reads top-k jsonl rows
{qid, image: [paths], query}, builds the method's prompt, generates with
the serving engine (Qwen2.5-VL, paged KV, chunked prefill, prefix cache,
greedy by default with repetition penalty 1.05 and the image token banned)
and appends {qid, imgs, pred} jsonl rows.

    python -m visrag_tpu_torch.driver.evisrag_predict --input top3.jsonl \
        --checkpoint qwen25vl_dir --output preds.jsonl \
        --method evidence_prompt_grpo [--device cuda]

`--checkpoint` is an HF Qwen2.5-VL directory (safetensors, config.json, the
tokenizer and, for a released model, its processor). `assemble_request`
and `build_engine` are what `main` runs per row and once, so that a caller
with its own tokenizer and weights can drive exactly the same path.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

# the engine settings of the JAX driver (and of the reference's vLLM call)
ENGINE_SETTINGS = dict(num_slots=4, max_len=16384,
                       prompt_buckets=(4096, 8192, 16384),
                       chunked_prefill_tokens=2048, prefix_cache=True)
VISION_KEYS = ("patches", "rot_cos", "rot_sin", "seg_window", "seg_full",
               "reverse_index")


def build_engine(model, eos_token_id: int, cache_dtype="bfloat16"):
    """The serving engine with the driver's settings: 4 slots, 16k tokens,
    buckets 4k/8k/16k, 2048-token chunked prefill, the prefix cache; bf16
    KV pools unless cache_dtype="int8"."""
    from ..serving.engine import Engine
    return Engine(model, eos_token_ids=[eos_token_id], cache_dtype=cache_dtype,
                  **ENGINE_SETTINGS)


def sampling_params(processor, tok, temperature: float, max_tokens: int):
    """Repetition penalty 1.05 and, when the processor names an image
    token, that token banned (logit bias -100)."""
    from ..serving.sampling import SamplingParams, banned_ids_bias
    bias = ()
    image_token = getattr(processor, "image_token", None)
    if image_token is not None:
        bias = banned_ids_bias([tok.convert_tokens_to_ids(image_token)])
    return SamplingParams(temperature=temperature, repetition_penalty=1.05,
                          max_tokens=max_tokens, logit_bias=bias)


def assemble_request(processor, tok, cfg, images, prompt: str,
                     max_pixels: int = 1568000) -> dict:
    """One request: chat template (images first, then the prompt text) →
    one <|image_pad|> per merged vision token of each image → ids → mrope
    positions → slot map → the uint8 vision batch. Without images: the ids
    alone. → kwargs of Engine.add_request (numpy arrays)."""
    from ..models.mrope import get_rope_index
    from ..preprocess.qwen_vision import prepare_vision_batch
    content = [{"type": "image"}] * len(images) + [
        {"type": "text", "text": prompt}]
    text = processor.apply_chat_template(
        [{"role": "user", "content": content}], tokenize=False,
        add_generation_prompt=True)
    if not images:
        return dict(input_ids=np.asarray(tok.encode(text), np.int32))
    vb = prepare_vision_batch(images, head_dim=cfg.vision.head_dim,
                              max_pixels=max_pixels, device_mode=True)
    mu = cfg.vision.spatial_merge_size ** 2
    for (t, h, w) in vb.grid_thw:
        text = text.replace("<|image_pad|>", "<|graft_img|>" * (t * h * w // mu),
                            1)
    text = text.replace("<|graft_img|>", "<|image_pad|>")
    ids = np.asarray(tok.encode(text), np.int32)
    slot = np.full(ids.shape, -1, np.int32)
    slot[ids == cfg.image_token_id] = np.arange(vb.n_tokens)
    return dict(input_ids=ids,
                positions=get_rope_index(ids, vb.grid_thw, cfg.image_token_id),
                vision_batch={k: getattr(vb, k) for k in VISION_KEYS},
                slot_map=slot)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--checkpoint", required=True,
                    help="HF Qwen2.5-VL checkpoint dir")
    ap.add_argument("--method", default="evidence_prompt_grpo")
    ap.add_argument("--topk", type=int, default=3)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-tokens", type=int, default=2048)
    ap.add_argument("--limit-images", type=int, default=5)
    ap.add_argument("--max-pixels", type=int, default=1568000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from PIL import Image

    from ..generation.prompts import build_prompt
    from .common import load_qwen25_vl_checkpoint

    processor, tok, model = load_qwen25_vl_checkpoint(args.checkpoint,
                                                      args.device)
    cfg = model.cfg
    engine = build_engine(model, tok.eos_token_id)
    sampling = sampling_params(processor, tok, args.temperature,
                               args.max_tokens)
    with open(args.input) as f, open(args.output, "a") as out:
        for line in f:
            row = json.loads(line)
            qid, query = row["qid"], row["query"]
            img_paths = row["image"][:min(args.topk, args.limit_images)]
            images = [Image.open(p).convert("RGB") for p in img_paths]
            req = assemble_request(processor, tok, cfg, images,
                                   build_prompt(args.method, query),
                                   args.max_pixels)
            outs = engine.generate([req], sampling=sampling)
            pred = tok.decode(outs[0], skip_special_tokens=True)
            out.write(json.dumps({"qid": qid, "imgs": img_paths,
                                  "pred": pred}) + "\n")
            out.flush()
            print(f"{qid}: {pred[:80]!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""EVisRAG stage-1 SFT driver.

Counterpart of visrag_tpu/driver/sft_main.py (the reference's LLaMA-Factory
full fine-tune of Qwen2.5-VL-7B: freeze_vision_tower, lr 5e-7): data rows
are chat conversations {prompt|problem, response|answer}; the loss covers
response tokens only; the vision tower is frozen.

    python -m visrag_tpu_torch.driver.sft_main --data sft.jsonl \
        --checkpoint <qwen2.5-vl-dir> --output-dir sft_run/ \
        --set lr=5e-7 --set total_steps=2000 [--device cuda]

The CLI is the JAX driver's plus `--device`. The text model recomputes
whole blocks in the backward: at the default batch of 4 x 4096 tokens the
3B model's activations do not fit one 80 GB card otherwise. `build_sft` and
`run_sft` are what `main` runs, so that a caller with its own tokenizer
and weights drives exactly the same path. The final weights are saved as
`global_step_N/model.pt` under --output-dir.

Across GPUs, one process each (torchrun, or --coordinator with
--process-id / --num-processes):

    torchrun --nproc_per_node 8 -m visrag_tpu_torch.driver.sft_main \
        --data sft.jsonl --checkpoint <dir> --output-dir out/ \
        --set ulysses_size=4

the mesh is data x seq with seq = ulysses_size (the JAX driver's sizing:
the data axis takes the rest), --batch-size is the global batch, every
rank reads the same rows and trains on its own (training/sft.py:
FSDP2 over all ranks, Ulysses over the seq axis), and rank 0 saves the
full weights.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np


def encode_sft_row(row, processor, tok, max_len: int):
    """A row {prompt|problem, response|answer} → (ids, response mask), both
    int32 and cut at max_len: the chat template's user turn with the
    generation prompt, then the response and the EOS token."""
    prompt = row.get("prompt") or row.get("problem")
    response = row.get("response") or row.get("answer") or ""
    text = processor.apply_chat_template(
        [{"role": "user", "content": [{"type": "text", "text": prompt}]}],
        tokenize=False, add_generation_prompt=True)
    pids = tok.encode(text)
    rids = tok.encode(response, add_special_tokens=False) + \
        [tok.eos_token_id]
    ids = (pids + rids)[:max_len]
    rmask = [0] * len(pids) + [1] * len(rids)
    return np.asarray(ids, np.int32), np.asarray(rmask[:len(ids)], np.int32)


def make_sft_batch(pairs):
    """(ids, response mask) pairs → a batch right-padded to a multiple of
    128, with 3 x arange positions (text rows: the three mrope streams
    agree)."""
    S = -(-max(len(i) for i, _ in pairs) // 128) * 128
    bs = len(pairs)
    ids = np.zeros((bs, S), np.int32)
    att = np.zeros((bs, S), np.int32)
    rm = np.zeros((bs, S), np.int32)
    for j, (i, m) in enumerate(pairs):
        ids[j, :len(i)] = i
        att[j, :len(i)] = 1
        rm[j, :len(i)] = m
    pos = np.broadcast_to(np.arange(S), (3, bs, S)).astype(np.int32)
    return {"input_ids": ids, "attention_mask": att, "response_mask": rm,
            "positions": pos}


def build_sft(model, cfg, mesh=None):
    """The SFT step as the driver wires it (training.sft.make_sft_step: the
    tower frozen, AdamW over the rest; with a mesh, FSDP2 and the seq
    axis). → (optimizer, step)."""
    from ..training.sft import make_sft_step
    return make_sft_step(model, cfg, mesh)


def run_sft(model, step, cfg, data, encode_row, *, batch_size: int,
            output_dir: str, tracker=None):
    """Rows of `data` (a jsonl or parquet path) in batches of batch_size
    (a short last batch is dropped), one step each up to cfg.total_steps,
    metrics logged every 10 steps; then the weights are saved under
    output_dir (under a process group: gathered from their shards, and
    written by rank 0). → the per-step metrics as floats."""
    import torch.distributed as dist
    from ..data.datasets import batched, iter_rows
    from ..training.checkpoint import full_tensors, save_checkpoint
    history = []
    for rows in batched(iter_rows(data), batch_size):
        if len(rows) < batch_size:
            continue
        metrics = step(make_sft_batch([encode_row(r) for r in rows]))
        history.append({k: float(v) for k, v in metrics.items()})
        if tracker is not None and len(history) % 10 == 0:
            tracker.log(history[-1], len(history))
        if len(history) >= cfg.total_steps:
            break
    state = model.state_dict()
    if dist.is_initialized():
        state = full_tensors(state)
        if dist.get_rank() == 0:
            save_checkpoint(output_dir, len(history), {"model": state})
        dist.barrier()
    else:
        save_checkpoint(output_dir, len(history), {"model": state})
    return history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True,
                    help="jsonl rows {prompt|problem, response|answer}")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=4096)
    ap.add_argument("--set", action="append", default=[],
                    help="SFTConfig overrides, e.g. --set lr=1e-6")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (multi-process runs)")
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    args = ap.parse_args(argv)
    from ..mesh import distributed
    with distributed(args.coordinator, args.process_id, args.num_processes,
                     args.device):
        return _run(ap, args)


def _run(ap, args):
    import torch.distributed as dist
    from ..config import MeshConfig, merge_dotlist
    from ..training.sft import SFTConfig
    from ..utils.tracker import Tracker
    from .common import (build_qwen25_vl, get_processor, get_tokenizer,
                         load_safetensors_dir, qwen_config_from_checkpoint)

    try:
        cfg = merge_dotlist(SFTConfig(), list(args.set))
    except (KeyError, ValueError) as e:
        ap.error(str(e))
    from ..mesh import build_mesh, local_device
    mesh = build_mesh(MeshConfig(seq=cfg.ulysses_size)) \
        if dist.is_initialized() else None
    rank0 = mesh is None or dist.get_rank() == 0
    os.makedirs(args.output_dir, exist_ok=True)
    processor = get_processor(args.checkpoint)
    # text-only checkpoints have no processor (get_processor → None);
    # tokenizers also implement apply_chat_template, so fall back to it
    tok = processor.tokenizer if processor is not None \
        else get_tokenizer(args.checkpoint)
    if processor is None:
        processor = tok
    state = load_safetensors_dir(args.checkpoint)
    mcfg = qwen_config_from_checkpoint(args.checkpoint, state)
    mcfg = dataclasses.replace(
        mcfg, text=dataclasses.replace(mcfg.text, remat=True))
    model = build_qwen25_vl(mcfg, device=local_device(args.device),
                            state=state)
    del state

    _, step = build_sft(model, cfg, mesh)
    tracker = Tracker(args.output_dir if rank0 else None)
    history = run_sft(
        model, step, cfg, args.data,
        lambda row: encode_sft_row(row, processor, tok, args.max_len),
        batch_size=args.batch_size, output_dir=args.output_dir,
        tracker=tracker)
    tracker.close()
    print(f"done: {len(history)} sft steps -> {args.output_dir}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

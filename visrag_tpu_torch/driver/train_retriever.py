"""Retriever contrastive-training driver.

Counterpart of visrag_tpu/driver/train_retriever.py with the same CLI plus
--device (paper config: per-device batch 16, τ = 0.02, wmean pooling, one
epoch, GradCache optional):

    python -m visrag_tpu_torch.driver.train_retriever \\
        --train-data pairs.parquet --output-dir out/ [--config run.yaml] \\
        [--set train.lr=5e-6 ...] [--device cuda]

Rows flow MMDRTrainDataset → qp_collate → build_encode_batch (host, uint8
pixels) → finish_encode_batch (on the device) → RetrieverTrainer. Page
batches keep the JAX driver's fixed slice buffer (batch × 10 slots of
PipelineConfig.max_patches patches); query batches carry their one dummy
slice, and every token batch is cut to its longest prompt (64-multiple).
With train.grad_cache each micro-batch of grad_cache_micro_batch_size pairs
is built as its own batch.

One GPU: cross-device negatives over torch.distributed are not ported, so
a multi-device mesh or a multi-process launch raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch


def _single_device(args, mesh) -> None:
    if (args.num_processes or 1) > 1 or args.coordinator:
        raise NotImplementedError(
            "multi-process training is not ported to visrag_tpu_torch: "
            "cross-device negatives over torch.distributed come with the "
            "multi-GPU slice; run one process on one GPU")
    sizes = {"data": mesh.data, "model": mesh.model, "seq": mesh.seq,
             "replica": mesh.replica}
    if any(v not in (-1, 1) for v in sizes.values()):
        raise NotImplementedError(
            f"mesh {sizes}: visrag_tpu_torch trains on one GPU (cross-device "
            "negatives over torch.distributed are not ported yet)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-data", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--config", default=None, help="YAML config")
    ap.add_argument("--set", action="append", default=[],
                    help="dotlist overrides, e.g. train.lr=1e-5")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--coordinator", default=None,
                    help="multi-process runs are not ported (raises)")
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device for the model and the step")
    args = ap.parse_args(argv)

    from ..config import RetrieverTrainConfig, dump_config, load_config
    from ..data.datasets import MMDRTrainDataset, StatefulIterator, qp_collate
    from ..preprocess import build_encode_batch
    from ..preprocess.device import finish_encode_batch, pos_table_tensor
    from ..training.checkpoint import save_checkpoint
    from ..training.trainer import RetrieverTrainer
    from ..utils.tracker import Tracker
    from .common import build_tokenizer, build_visrag_ret

    cfg = load_config(RetrieverTrainConfig, yaml_path=args.config,
                      dotlist=args.set)
    _single_device(args, cfg.mesh)
    tcfg = cfg.train
    tcfg.output_dir = args.output_dir
    os.makedirs(args.output_dir, exist_ok=True)
    dump_config(cfg, os.path.join(args.output_dir, "run_config.json"))
    device = torch.device(args.device)

    model, pcfg = build_visrag_ret(cfg.model, tiny=args.tiny, device=device)
    pcfg = dataclasses.replace(pcfg, seq_auto=True)
    tok = build_tokenizer(cfg.model.checkpoint)
    tracker = Tracker(args.output_dir)
    table = pos_table_tensor(pcfg.src_grid, device)

    bs = cfg.data.batch_size
    micro = tcfg.grad_cache_micro_batch_size if tcfg.grad_cache else bs
    if micro <= 0 or bs % micro:
        raise ValueError(f"data.batch_size {bs} is not a multiple of "
                         f"train.grad_cache_micro_batch_size {micro}")

    params = None
    if tcfg.lora_rank > 0:
        # freeze the base, train rank-r adapters on q_proj/v_proj
        from ..training.lora import lora_init
        params = lora_init(model, rank=tcfg.lora_rank, alpha=tcfg.lora_alpha,
                           generator=torch.Generator(device=device)
                           .manual_seed(0))

    dataset = MMDRTrainDataset(args.train_data,
                               query_template=cfg.data.query_template)
    try:
        total = len(dataset) // bs * tcfg.epochs
    except TypeError:
        total = max(tcfg.max_steps, 1000)

    # checkpointable row cursor: resume continues at the exact dataset row
    row_iter = StatefulIterator(lambda: iter(dataset), cycle=True)

    def encode_batch(items, slots=None):
        raw = build_encode_batch(tok, items, pcfg, n_slice_slots=slots,
                                 device_mode=True)
        return finish_encode_batch(raw, table)

    def batches():
        buf = []
        for item in row_iter:
            if row_iter.epoch >= tcfg.epochs:
                break
            if row_iter.row == 1 and buf:
                buf = []          # new epoch started: drop the ragged tail
            buf.append(item)
            if len(buf) < bs:
                continue
            coll = qp_collate(buf)
            buf = []
            yield [(encode_batch(coll["queries"][i:i + micro]),
                    encode_batch(coll["passages"][i:i + micro],
                                 micro * pcfg.max_slices_per_page))
                   for i in range(0, bs, micro)]

    trainer = RetrieverTrainer(model, tcfg, total_steps=total,
                               logger=lambda s, m: tracker.log(m, s),
                               params=params)
    trainer.data_iter = row_iter
    done_steps = trainer.maybe_resume(args.output_dir)
    if done_steps:
        print(f"resumed from step {done_steps} "
              f"(data cursor {row_iter.state()})", file=sys.stderr)
    trainer.train(batches(), checkpoint_dir=args.output_dir)
    if trainer.step > done_steps and trainer.step % tcfg.save_every:
        trainer.save(args.output_dir)      # the last step, resumable
    if params is not None and trainer.step:
        from ..training.lora import lora_merge
        save_checkpoint(args.output_dir, trainer.step,
                        {"merged_model": lora_merge(model).state_dict()})
    tracker.close()
    print(f"done: {trainer.step} steps -> {args.output_dir}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

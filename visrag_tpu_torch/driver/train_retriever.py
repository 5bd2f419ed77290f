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

Across GPUs, one process each:

    torchrun --nproc_per_node 8 -m visrag_tpu_torch.driver.train_retriever \
        --train-data pairs.parquet --output-dir out/

(or --coordinator host:port --process-id i --num-processes n, the JAX
driver's flags, in each process; `--device cpu` runs gloo ranks). The
mesh is `mesh` of the config (replica spanning nodes, data the rest),
data.batch_size is the global batch: every rank reads the same rows, and
builds and trains on its block of each batch (mesh.local_slice), so the
data cursor in a checkpoint is global and a resume lands on the same row
at any rank count. Negatives are shared across ranks and the weights are
FSDP2-sharded (training/trainer.py); rank 0 logs and writes. With
train.lora_rank > 0 only the adapters train, sharded with their frozen
base; every rank gathers the full weights at the end, and rank 0 merges
the adapters and writes `merged_model`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-data", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--config", default=None, help="YAML config")
    ap.add_argument("--set", action="append", default=[],
                    help="dotlist overrides, e.g. train.lr=1e-5")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (multi-process runs)")
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device for the model and the step")
    args = ap.parse_args(argv)
    from ..mesh import distributed
    with distributed(args.coordinator, args.process_id, args.num_processes,
                     args.device) as (pid, nproc):
        return _run(args, pid, nproc)


def _run(args, pid, nproc):
    import torch.distributed as dist
    from ..config import RetrieverTrainConfig, dump_config, load_config
    from ..data.datasets import MMDRTrainDataset, StatefulIterator, qp_collate
    from ..preprocess import build_encode_batch
    from ..preprocess.device import finish_encode_batch, pos_table_tensor
    from ..training.checkpoint import save_checkpoint
    from ..training.trainer import RetrieverTrainer
    from ..utils.tracker import Tracker
    from .common import build_tokenizer, build_visrag_ret
    from ..mesh import (build_mesh, local_batch_size, local_device,
                        local_slice, mesh_shape, multihost_mesh_config,
                        num_nodes_of_job)

    cfg = load_config(RetrieverTrainConfig, yaml_path=args.config,
                      dotlist=args.set)
    mesh_cfg = multihost_mesh_config(cfg.mesh, num_nodes_of_job())
    mesh_shape(mesh_cfg, nproc)                  # the layout, or ValueError
    tcfg = cfg.train
    tcfg.output_dir = args.output_dir
    if pid == 0:
        os.makedirs(args.output_dir, exist_ok=True)
        dump_config(cfg, os.path.join(args.output_dir, "run_config.json"))
    device = local_device(args.device)
    mesh = build_mesh(mesh_cfg) if dist.is_initialized() else None

    model, pcfg = build_visrag_ret(cfg.model, tiny=args.tiny, device=device)
    pcfg = dataclasses.replace(pcfg, seq_auto=True)
    tok = build_tokenizer(cfg.model.checkpoint)
    tracker = Tracker(args.output_dir if pid == 0 else None)
    table = pos_table_tensor(pcfg.src_grid, device)

    bs = cfg.data.batch_size
    local_bs = local_batch_size(bs, mesh)
    micro = tcfg.grad_cache_micro_batch_size if tcfg.grad_cache else local_bs
    if micro <= 0 or local_bs % micro:
        raise ValueError(f"data.batch_size {bs} over {nproc} ranks is not a "
                         f"multiple of train.grad_cache_micro_batch_size "
                         f"{micro} on each")

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
            queries = local_slice(coll["queries"], mesh)
            passages = local_slice(coll["passages"], mesh)
            yield [(encode_batch(queries[i:i + micro]),
                    encode_batch(passages[i:i + micro],
                                 micro * pcfg.max_slices_per_page))
                   for i in range(0, local_bs, micro)]

    trainer = RetrieverTrainer(model, tcfg, total_steps=total,
                               logger=lambda s, m: tracker.log(m, s),
                               params=params, mesh=mesh)
    trainer.data_iter = row_iter
    done_steps = trainer.maybe_resume(args.output_dir)
    if done_steps:
        print(f"resumed from step {done_steps} "
              f"(data cursor {row_iter.state()})", file=sys.stderr)
    trainer.train(batches(), checkpoint_dir=args.output_dir)
    if trainer.step > done_steps and trainer.step % tcfg.save_every:
        trainer.save(args.output_dir)      # the last step, resumable
    if params is not None and trainer.step:
        # every rank joins the gather; rank 0 merges and writes
        from ..training.checkpoint import full_tensors
        from ..training.lora import lora_merged_state
        state = model.state_dict()
        if mesh is not None:
            state = full_tensors(state)
        if pid == 0:
            save_checkpoint(args.output_dir, trainer.step,
                            {"merged_model": lora_merged_state(model, state)})
        if mesh is not None:
            dist.barrier()
    tracker.close()
    print(f"done: {trainer.step} steps -> {args.output_dir}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

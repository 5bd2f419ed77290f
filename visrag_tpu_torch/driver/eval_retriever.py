"""Retrieval evaluation driver: encode corpus and queries → retrieve → metrics.

Counterpart of visrag_tpu/driver/eval_retriever.py with the same CLI plus
--device: phases encode / retrieve / eval, a TREC run file,
test_result.log and metrics.json (ndcg_cut_k / recall_k / mrr_k).

    python -m visrag_tpu_torch.driver.eval_retriever \
        --corpus corpus.parquet --queries queries.parquet \
        --qrels qrels.tsv --output-dir out/ [--depth 10] \
        [--corpus-quant int8] [--device cuda]

`--corpus-quant int8` scans a per-row int8 corpus (retrieval/search.py:
half the resident bytes of bf16, the product on K6 on the card).

Across GPUs, one process each (torchrun, or --coordinator with
--process-id / --num-processes as train_retriever takes them):

    torchrun --nproc_per_node 8 -m visrag_tpu_torch.driver.eval_retriever \
        --corpus ... --queries ... --output-dir out/

each rank encodes its block of every batch (data.batch_size must divide
by the rank count), the corpus is searched sharded over the ranks
(retrieval/search.make_sharded_topk, fp32 or int8), and rank 0 writes
the embeddings, the TREC run and the metrics.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default=None)
    ap.add_argument("--queries", default=None)
    ap.add_argument("--qrels", default=None)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--config", default=None, help="YAML EvalConfig")
    ap.add_argument("--set", action="append", default=[],
                    help="dotlist overrides, e.g. retrieval.depth=10")
    ap.add_argument("--phase", default=None,
                    choices=["all", "encode", "retrieve", "eval"])
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--corpus-quant", default="none", choices=["none", "int8"],
                    help="int8: per-row-quantized corpus scan (half the "
                         "device bytes of bf16, a quarter of fp32)")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny random model (smoke runs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the model and the search")
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

    from ..config import EvalConfig, load_config
    from ..mesh import build_mesh, local_batch_size, local_device, \
        local_slice
    from ..data.datasets import InferenceDataset, batched
    from ..preprocess import build_encode_batch, pick_patch_bucket
    from ..preprocess.device import finish_encode_batch, pos_table_tensor
    from ..retrieval import evaluate_run
    from ..retrieval.encode import (EmbeddingWriter, encode_dataset,
                                    make_encode_step)
    from ..retrieval.search import StreamingSearcher, build_run
    from ..retrieval.trec import load_beir_qrels, load_from_trec, save_as_trec
    from .common import build_tokenizer, build_visrag_ret

    cfg = load_config(EvalConfig, yaml_path=args.config, dotlist=args.set)
    if args.corpus:
        cfg.data.corpus_path = args.corpus
    if args.queries:
        cfg.data.query_path = args.queries
    if args.qrels:
        cfg.data.qrels_path = args.qrels
    if args.checkpoint is not None:
        cfg.model.checkpoint = args.checkpoint
    if args.phase is not None:
        cfg.phase = args.phase
    if args.depth is not None:
        cfg.retrieval.depth = args.depth
    if args.batch_size is not None:
        cfg.data.batch_size = args.batch_size
    if not cfg.data.corpus_path or not cfg.data.query_path:
        ap.error("--corpus/--queries (or data.corpus_path/query_path) "
                 "required")
    batch_size = cfg.data.batch_size
    mesh = build_mesh(cfg.mesh) if dist.is_initialized() else None
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    device = local_device(args.device)
    local_batch_size(batch_size, mesh)          # divisible, or ValueError

    os.makedirs(args.output_dir, exist_ok=True)
    model, pcfg = build_visrag_ret(cfg.model, tiny=args.tiny, device=device)
    tok = build_tokenizer(cfg.model.checkpoint)
    pos_table = pos_table_tensor(pcfg.src_grid, device)

    @torch.inference_mode()
    def apply(**raw):
        return model(finish_encode_batch(raw, pos_table))

    def encode_file(path, template, out_prefix, max_len):
        """max_len: per-type token cap (queries 512, pages 2048 by
        default)."""
        ds = InferenceDataset(path, template=template)
        writer = EmbeddingWriter(args.output_dir if rank0 else None,
                                 prefix=out_prefix,
                                 max_inmem_docs=cfg.retrieval.max_inmem_docs)

        def build(items):
            bcfg = dataclasses.replace(
                pcfg, seq_len=min(max_len, pcfg.seq_len),
                max_patches=min(pcfg.max_patches,
                                pick_patch_bucket(items, pcfg)))
            return build_encode_batch(
                tok, items, bcfg,
                n_slice_slots=len(items) * pcfg.max_slices_per_page,
                device_mode=True)

        def batches():
            for batch in batched(iter(ds), batch_size):
                ids = [b[0] for b in batch]
                items = [(text, img) for _, text, img in batch]
                items += [("", None)] * (batch_size - len(items))
                yield ids, build(local_slice(items, mesh))

        return encode_dataset(make_encode_step(apply, mesh), batches(),
                              writer=writer)

    trec_path = cfg.retrieval.trec_save_path or \
        os.path.join(args.output_dir, "test.trec")

    if cfg.phase in ("all", "encode", "retrieve"):
        # pyarrow imported first in encode_dataset's prefetch thread
        # crashes opening the second parquet file (a segfault in
        # ParquetFile); imported here, in the main thread, it does not
        import pyarrow.parquet  # noqa: F401
        print("encoding corpus...", file=sys.stderr)
        doc_ids, doc_reps = encode_file(cfg.data.corpus_path,
                                        cfg.data.doc_template,
                                        "embeddings.corpus",
                                        cfg.data.p_max_len)
        print("encoding queries...", file=sys.stderr)
        q_ids, q_reps = encode_file(cfg.data.query_path,
                                    cfg.data.query_template,
                                    "embeddings.query", cfg.data.q_max_len)
        print("retrieving...", file=sys.stderr)
        searcher = StreamingSearcher(
            k=min(cfg.retrieval.depth, len(doc_ids)), device=device,
            quant=args.corpus_quant, mesh=mesh)
        scores, idx = searcher.search(q_reps, [(doc_reps, 0)])
        if rank0:
            save_as_trec(build_run(scores, idx, q_ids, doc_ids), trec_path)
            print(f"run saved to {trec_path}", file=sys.stderr)

    if not rank0:
        return 0
    if cfg.phase in ("all", "eval") and cfg.data.qrels_path:
        run = load_from_trec(trec_path)
        qrels = load_beir_qrels(cfg.data.qrels_path)
        metrics = evaluate_run(run, qrels, k=cfg.retrieval.depth)
        with open(os.path.join(args.output_dir, "test_result.log"), "w") as f:
            for k, v in metrics.items():
                line = "{:25s}{:8s}{:.4f}".format(k, "all", v)
                print(line)
                f.write(line + "\n")
        with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

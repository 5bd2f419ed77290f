"""Where the time of one full-width VisRAG-Ret training step goes on the GPU
(the PyTorch/CUDA port, visrag_tpu_torch).

    python3 tools/torch_profile_train.py [--pairs 16] [--micro 4]

Builds the full-width model on random weights (seed 0, whole-block remat),
a RetrieverTrainer with bf16 AdamW states, and one batch of synthetic page
images in bench.py's size mix with query texts, built as the training
driver builds them (GradCache micro-batches of --micro pairs). After one
warm-up step it times one step's parts by CUDA events (pass 1, the loss,
pass 2, clipping, the optimizer) and then profiles one more step with
torch.profiler: device time by kernel family, the device's idle share over
the step's window, and the top kernels. Prints one line per part and
writes chiprun_out/profile_train.json. Needs one GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PAGE_SIZES = [(826, 1169), (1654, 2339), (1280, 720), (900, 900)]


def family(name: str) -> str:
    n = name.lower()
    if "lengths_attention" in n:
        return "attention kernels (K1, K2)"
    if "row_norm_kernel" in n:
        return "K7 row norms"
    if any(k in n for k in ("gemm", "nvjet", "cutlass", "sm90_xmma",
                            "cublas", "ampere_", "splitk")):
        return "GEMMs (cuBLAS)"
    if any(k in n for k in ("reduce", "norm")):
        return "reductions and norms"
    if "copy" in n or "memcpy" in n or "memset" in n or "cat" in n:
        return "copies, casts, memset"
    return "other elementwise"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=16)
    ap.add_argument("--micro", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from PIL import Image

    from visrag_tpu_torch.config import ModelConfig, TrainConfig
    from visrag_tpu_torch.driver.common import build_visrag_ret
    from visrag_tpu_torch.ops import _build
    from visrag_tpu_torch.preprocess import MockTokenizer, build_encode_batch
    from visrag_tpu_torch.preprocess.device import (finish_encode_batch,
                                                    pos_table_tensor)
    from visrag_tpu_torch.training.contrastive import contrastive_loss
    from visrag_tpu_torch.training.trainer import (RetrieverTrainer,
                                                   clip_by_global_norm_)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _build.build_all()
    model, pcfg = build_visrag_ret(ModelConfig(remat=True), device="cuda",
                                   seed=0)
    pcfg = dataclasses.replace(pcfg, seq_auto=True)
    trainer = RetrieverTrainer(model, TrainConfig(
        lr=5e-6, grad_cache=True, grad_cache_micro_batch_size=args.micro,
        optimizer_state_dtype="bfloat16"), total_steps=1000)
    rng = np.random.default_rng(0)
    pages = [("", Image.fromarray(rng.integers(
        0, 255, (PAGE_SIZES[i % 4][1], PAGE_SIZES[i % 4][0], 3),
        dtype=np.uint8))) for i in range(args.pairs)]
    queries = [(f"Represent this query for retrieving relevant documents: "
                f"what does page {i} report?", None)
               for i in range(args.pairs)]
    tok, table = MockTokenizer(), pos_table_tensor(pcfg.src_grid, "cuda")
    t0 = time.perf_counter()
    raws = [(build_encode_batch(tok, queries[i:i + args.micro], pcfg,
                                device_mode=True),
             build_encode_batch(tok, pages[i:i + args.micro], pcfg,
                                n_slice_slots=args.micro *
                                pcfg.max_slices_per_page, device_mode=True))
            for i in range(0, args.pairs, args.micro)]
    host_s = time.perf_counter() - t0
    micro = [(finish_encode_batch(q, table), finish_encode_batch(p, table))
             for q, p in raws]

    trainer.train_step(micro)                 # warm-up
    torch.cuda.synchronize()

    # the step's parts by CUDA events (the GradCache pass split as in
    # training.contrastive.gradcache_backward)
    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    params = trainer.params
    for p in params:
        p.grad = None
    model.train()
    marks = [("start", event())]
    with torch.no_grad():
        reps = [(model(q), model(p)) for q, p in micro]
    marks.append(("pass 1 (no grad)", event()))
    q_reps = torch.cat([r[0] for r in reps]).requires_grad_(True)
    p_reps = torch.cat([r[1] for r in reps]).requires_grad_(True)
    loss, _ = contrastive_loss(q_reps, p_reps, trainer.ccfg)
    loss.backward()
    marks.append(("loss and rep-grads", event()))
    sizes = [r[0].shape[0] for r in reps]
    for (q, p), gq, gp in zip(micro, q_reps.grad.split(sizes),
                              p_reps.grad.split(sizes)):
        torch.autograd.backward([model(q), model(p)], [gq, gp])
    marks.append(("pass 2 (forward, recompute, backward)", event()))
    clip_by_global_norm_(params, 1.0)
    marks.append(("grad norm and clip", event()))
    trainer.optimizer.step()
    marks.append(("optimizer (bf16 AdamW + Kahan)", event()))
    torch.cuda.synchronize()
    parts = {name: marks[i - 1][1].elapsed_time(e)
             for i, (name, e) in enumerate(marks) if i}
    step_ms = marks[0][1].elapsed_time(marks[-1][1])

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        trainer.train_step(micro)
        torch.cuda.synchronize()
    # device-side events, without the profiler's own annotation ranges
    # ("Optimizer.step#AnyPrecisionAdamW.step" spans kernels, runs none)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    starts = [e.time_range.start for e in kernels]
    ends = [e.time_range.end for e in kernels]
    window_us = max(ends) - min(starts) if kernels else 0.0
    by_family, by_name = {}, {}
    for e in kernels:
        by_family[family(e.name)] = by_family.get(family(e.name), 0.0) \
            + e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]

    result = {
        "device": torch.cuda.get_device_name(0), "smi": smi,
        "pairs": args.pairs, "micro": args.micro,
        "host_preprocess_s": host_s, "step_ms_events": step_ms,
        "parts_ms": parts,
        "profiled_device_busy_ms": busy_us / 1e3,
        "profiled_window_ms": window_us / 1e3,
        "idle_share": 1.0 - busy_us / window_us if window_us else None,
        # the profiler slows the host; the unprofiled step's idle share,
        # from the same kernels' time over the event-timed step
        "idle_share_unprofiled": 1.0 - busy_us / 1e3 / step_ms,
        "device_ms_by_family": {k: v / 1e3 for k, v in sorted(
            by_family.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": [(n[:120], v / 1e3) for n, v in top],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"[profile] {smi} | {args.pairs} pairs, GradCache micro-batch "
          f"{args.micro}, host preprocess {host_s:.2f} s (not in the step "
          f"below)")
    print(f"[profile] step {step_ms:.1f} ms by CUDA events: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    print(f"[profile] torch.profiler step: device busy "
          f"{busy_us / 1e3:.1f} ms over a {window_us / 1e3:.1f} ms window, "
          f"idle share {result['idle_share']:.4f} (unprofiled step: "
          f"{result['idle_share_unprofiled']:.4f})")
    for k, v in result["device_ms_by_family"].items():
        print(f"[profile]   {k}: {v:.1f} ms ({v / (busy_us / 1e3):.1%})")
    for n, v in result["top_kernels_ms"]:
        print(f"[profile]   {v:9.1f} ms  {n}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_train.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"step_ms": step_ms, "idle_share":
                      result["idle_share"]}))


if __name__ == "__main__":
    main()

"""Where the time of EVisRAG serving goes on the GPU (the PyTorch/CUDA port,
visrag_tpu_torch): Qwen2.5-VL-7B at full width on random weights.

    python3 tools/torch_profile_serve.py [--max-tokens 64]

Builds the model (seed 0) and the engine with evisrag_predict's own
build_engine, assembles chip_smoke.py's six requests (three 3-page prompts
for chunked prefill, one small page for whole prefill as an n = 2 group,
two text prompts for a batched prefill) with chip_smoke's stand-in
tokenizer, and runs them once. Four windows of that run go through
torch.profiler: the batched text prefill, the first vision prefill's chunk
start (the vision tower and the prompt embedding), one middle prefill
chunk, and the decode chunk at which the three 3-page requests decode
together. For each window: wall time bracketed by device syncs, device
busy time, the idle share, device time by kernel family and the top
kernels. Prints one line per window and writes
chiprun_out/profile_serve.json. Needs one GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def family(name: str) -> str:
    n = name.lower()
    if "kvgrid" in n:
        return "K3 banded segment attention"
    if "paged" in n:
        return "K5 paged decode"
    if "lengths_attention" in n:
        return "K1 lengths attention"
    if "row_norm_kernel" in n:
        return "K7 row norms"
    if any(k in n for k in ("gemm", "nvjet", "cutlass", "sm90_xmma",
                            "cublas", "ampere_", "splitk", "gemv")):
        return "GEMMs (cuBLAS)"
    if any(k in n for k in ("reduce", "norm", "softmax", "argmax", "scan",
                            "sort")):
        return "reductions, softmax, sampling"
    if any(k in n for k in ("copy", "memcpy", "memset", "cat", "index",
                            "gather", "scatter")):
        return "copies, indexing, casts"
    return "other elementwise"


class Window:
    """Profiles the `which`-th call of an engine method."""

    def __init__(self, engine, name, which, label):
        self.label, self.which, self.calls, self.result = label, which, 0, None
        fn = getattr(engine, name)

        def wrapped(*a, **kw):
            self.calls += 1
            if self.calls != self.which:
                return fn(*a, **kw)
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         acc_events=True) as prof:
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            self.result = summarize(prof, wall)
            return out
        setattr(engine, name, wrapped)


def summarize(prof, wall_s):
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_family, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_family[family(e.name)] = by_family.get(family(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (wall_s * 1e3),
            "kernels": len(kernels),
            "device_ms_by_family": {k: v / 1e3 for k, v in sorted(
                by_family.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms": [(n[:100], v / 1e3) for n, v in top]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-tokens", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import chip_smoke
    from visrag_tpu_torch.driver.common import build_qwen25_vl
    from visrag_tpu_torch.driver.evisrag_predict import (build_engine,
                                                         sampling_params)
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    from visrag_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _build.build_all()
    cfg = Qwen25VLConfig.b7()
    tok = chip_smoke.StandInTokenizer()
    reqs = chip_smoke._serving_requests(tok, cfg)
    model = build_qwen25_vl(cfg, device="cuda", seed=0)
    engine = build_engine(model, tok.eos_token_id)
    engine.record_schedule = True
    windows = [Window(engine, "_prefill_many", 1, "batched text prefill"),
               Window(engine, "_start_chunked", 1,
                      "vision tower + prompt embedding (3 pages)"),
               Window(engine, "_advance_chunk", 2, "one 2048-token chunk"),
               Window(engine, "_decode_chunk", 6,
                      "decode chunk, 3 long requests live")]
    sp = sampling_params(tok, tok, 0.0, args.max_tokens)
    for _, req, n in reqs:
        engine.add_request(sampling=sp, n=n, **req)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    result = {"device": torch.cuda.get_device_name(0), "smi": smi,
              "prompt_tokens": [len(r["input_ids"]) for _, r, _ in reqs],
              "schedule": "".join(engine.sched_log), "run_s": run_s,
              "windows": {w.label: w.result for w in windows}}
    print(f"[profile] {smi} | Qwen2.5-VL-7B, 7 requests, prompt tokens "
          f"{result['prompt_tokens']}, schedule {result['schedule']}, run "
          f"{run_s:.2f} s (with the profiled windows)")
    for w in windows:
        r = w.result
        if r is None:
            print(f"[profile] {w.label}: not reached")
            continue
        print(f"[profile] {w.label}: wall {r['wall_ms']:.1f} ms, device "
              f"busy {r['device_busy_ms']:.1f} ms, idle share "
              f"{r['idle_share']:.4f}, {r['kernels']} kernels")
        for k, v in r["device_ms_by_family"].items():
            print(f"[profile]   {k}: {v:.2f} ms "
                  f"({v / max(r['device_busy_ms'], 1e-9):.1%})")
        for name, v in r["top_kernels_ms"][:5]:
            print(f"[profile]     {v:8.2f} ms  {name}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_serve.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({w.label: None if w.result is None else
                      round(w.result["idle_share"], 4) for w in windows}))


if __name__ == "__main__":
    main()

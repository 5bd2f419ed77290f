"""Drive the PyTorch/CUDA port's VisRAG-Ret main path once on one GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and the exit code is
non-zero):

  0. environment: torch/CUDA versions, the card, nvcc, Pillow and pyarrow;
  1. build the attention kernel from visrag_tpu_torch/csrc with nvcc;
  2. the kernel against its plain PyTorch version on the card (bf16
     unit-normal inputs, 2e-2 max abs on valid rows) at the shapes and
     lengths phase 3's page and query batches give it (ViT flat 116
     slices x S=1088 and the query batch's empty slice, LM causal 16 x 704
     and 8 x 128), and at two edge-case shapes (ragged lengths including
     0); then one full-width ViT block and one full-width LM layer at the
     page batch's sequence lengths against the same block in fp32 on the
     CPU (2e-2 relative Frobenius error);
  3. the full-width slice on random weights from seed 0: 16 synthetic pages
     (bench.py's size mix) and 8 text queries through encode_dataset, then
     StreamingSearcher top-10, build_run and evaluate_run; checks finite
     unit-norm embeddings, self-retrieval at rank 1, and that every encode
     batch launched the kernel 26 (ViT) + 40 (LM) times.

The last lines are the card's name and power limit (nvidia-smi), one JSON
line describing the kernels (ms, plain_ms and max_abs_err at the page
batch's shape; every checked shape under "checks"), and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import shutil
import statistics
import subprocess
import sys
import time

import torch

ATOL_KERNEL = 2e-2      # bf16 kernel vs plain, unit-normal inputs
RTOL_BLOCK = 2e-2       # bf16 block on the card vs fp32 block on the CPU
PAGE_SIZES = [(826, 1169), (1654, 2339), (1280, 720), (900, 900)]
N_PAGES, N_QUERIES = 16, 8


def log(msg):
    print(msg, flush=True)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def cuda_ms(fn, reps=10):
    """Median ms of fn() over reps launches, each timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase0_environment():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this script runs only on the GPU")
    import importlib.util
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("PIL", "pyarrow")}
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} | {smi()} "
        f"| nvcc {shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc?'} | "
        f"PIL {have['PIL']} pyarrow {have['pyarrow']}")
    if not have["PIL"]:
        raise RuntimeError("Pillow is required for the synthetic pages")


def phase1_build():
    from visrag_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build("attention_lengths")
    dt = time.perf_counter() - t0
    report = (_build.BUILD_DIR / "attention_lengths.log").read_text()
    lines = report.splitlines()
    regs = sorted({line.split("Used ")[1].split(",")[0]
                   for line in lines if "Used " in line})
    spills = all("0 bytes spill stores, 0 bytes spill loads" in line
                 for line in lines if "spill stores" in line)
    log(f"[1] built {path.name} in {dt:.2f} s (registers per kernel: "
        f"{', '.join(regs)}; spill-free: {spills})")
    return dt


def _lengths(mask):
    return [int(x) for x in mask.sum(axis=1)]


def phase2_kernel(gen, setup):
    """K1 against the plain version at every shape the main path gives it,
    plus two edge-case shapes. → {form: [check, ...]}, page batch first."""
    from visrag_tpu_torch.ops import attention_lengths as al
    dev = "cuda"
    batches = setup["batches"]
    vit = setup["model"].cfg.backbone.vit
    lm = setup["model"].cfg.backbone.llm
    vit_h, vit_d = vit.num_heads, vit.head_dim
    lm_h, lm_d = lm.num_attention_heads, lm.head_dim
    flat = [(name, *raw["patch_mask"].shape, _lengths(raw["patch_mask"]))
            for name, raw in batches.items()]
    flat.append(("edge", 8, 1088, [1088, 1032, 600, 0, 1, 64, 65, 1000]))
    stacked = [(name, *raw["attention_mask"].shape,
                _lengths(raw["attention_mask"]))
               for name, raw in batches.items()]
    stacked.append(("edge", 16, 576, [576, 500, 129, 64, 63, 1, 300, 576,
                                      200, 100, 50, 400, 450, 320, 10, 575]))
    results = {"flat": [], "stacked": []}
    for name, n, s, lens in flat:
        h, d = vit_h, vit_d
        qkv = torch.randn(n * s, 3 * h * d, generator=gen,
                          device=dev).bfloat16()
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        kern = lambda: al.flash_fwd_lengths_flat(qkv, lens, n, s, h, d,
                                                 False, d ** -0.5)
        plain = lambda: al.lengths_attention_reference(
            *qkv.view(n, s, 3, h, d).unbind(2), lens, False,
            d ** -0.5).reshape(n * s, h * d)
        valid = (torch.arange(s, device=dev)[None] < lens[:, None]) \
            .reshape(-1)
        results["flat"].append(_compare(
            f"ViT flat {name} n={n} S={s} H={h} d={d} lengths "
            f"{int(lens.min())}-{int(lens.max())}", kern, plain, valid))
        del qkv, kern, plain
    for name, b, s, lens in stacked:
        h, d = lm_h, lm_d
        q, k, v = (torch.randn(b, s, h, d, generator=gen,
                               device=dev).bfloat16() for _ in range(3))
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        kern = lambda: al.flash_fwd_lengths(q, k, v, lens, True, d ** -0.5)
        plain = lambda: al.lengths_attention_reference(q, k, v, lens, True,
                                                       d ** -0.5)
        valid = torch.arange(s, device=dev)[None] < lens[:, None]
        results["stacked"].append(_compare(
            f"LM causal {name} B={b} S={s} H={h} d={d} lengths "
            f"{int(lens.min())}-{int(lens.max())}", kern, plain, valid))
        del q, k, v, kern, plain
    torch.cuda.empty_cache()
    _full_width_blocks(gen, batches["pages"])
    return results


def _compare(label, kern, plain, valid):
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise RuntimeError(f"{label}: kernel output not finite")
    diff = (out.float() - ref.float()).abs()[valid]
    err = diff.max().item() if diff.numel() else 0.0
    del out, ref, diff
    ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
    log(f"[2] K1 {label}: max_abs_err {err:.6g} (bound {ATOL_KERNEL}) | "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 10, CUDA "
        f"events) | {smi()}")
    if err > ATOL_KERNEL:
        raise RuntimeError(f"{label}: kernel disagrees with plain ({err})")
    return {"shape": label, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms}


def _rel_err(out, ref, valid):
    a, b = out.float().cpu()[valid], ref[valid]
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


def _full_width_blocks(gen, raw_pages):
    """One ViT block at the page batch's patch bucket and one LM layer at
    its token batch, each on the batch's longest and shortest row."""
    from visrag_tpu_torch.driver.common import init_weights_
    from visrag_tpu_torch.models.minicpm import (MiniCPMConfig,
                                                 MiniCPMDecoderLayer,
                                                 rope_inv_freq)
    from visrag_tpu_torch.models.siglip_vit import SiglipViTConfig, ViTBlock

    def ends(mask):
        lens = _lengths(mask)
        return torch.tensor([max(lens), min(lens)], dtype=torch.int32)

    vcfg = SiglipViTConfig()
    with torch.device("cuda"):
        block = ViTBlock(vcfg)
    init_weights_(block, gen)
    s = raw_pages["patch_mask"].shape[1]
    lens = ends(raw_pages["patch_mask"])
    x = torch.randn(2, s, vcfg.embed_dim, generator=gen, device="cuda")
    with torch.inference_mode():
        out = block(x.bfloat16(), lens.cuda())
        ref = copy.deepcopy(block).float().cpu()(x.cpu(), lens)
    e_vit = _rel_err(out, ref, torch.arange(s)[None] < lens[:, None])
    vit_label = f"S={s} lengths {lens.tolist()}"

    lcfg = MiniCPMConfig()
    with torch.device("cuda"):
        layer = MiniCPMDecoderLayer(lcfg)
    init_weights_(layer, gen)
    s = raw_pages["attention_mask"].shape[1]
    lens = ends(raw_pages["attention_mask"])
    x = torch.randn(2, s, lcfg.hidden_size, generator=gen, device="cuda")
    pos = torch.arange(s).expand(2, s)
    with torch.inference_mode():
        out = layer(x.bfloat16(), pos.cuda(), lens.cuda(),
                    rope_inv_freq(lcfg, s, lens, "cuda"))
        ref = copy.deepcopy(layer).float().cpu()(
            x.cpu(), pos, lens, rope_inv_freq(lcfg, s, lens, "cpu"))
    e_lm = _rel_err(out, ref, torch.arange(s)[None] < lens[:, None])
    log(f"[2] full-width blocks, bf16 kernel on the card vs fp32 plain on "
        f"the CPU: ViT block ({vit_label}) rel_err {e_vit:.3g}, LM layer "
        f"(S={s} lengths {lens.tolist()}) rel_err {e_lm:.3g} (bound "
        f"{RTOL_BLOCK})")
    if max(e_vit, e_lm) > RTOL_BLOCK:
        raise RuntimeError("full-width block disagrees with its fp32 plain "
                           "version")


def _pages(seed):
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(seed)
    pages = []
    for i in range(N_PAGES):
        w, h = PAGE_SIZES[i % len(PAGE_SIZES)]
        pages.append(("", Image.fromarray(
            rng.integers(0, 255, (h, w, 3), dtype=np.uint8))))
    return pages


def phase3_setup():
    """The full-width model and the raw page and query batches (host work
    only, before phase 2 takes the batches' shapes)."""
    import dataclasses

    from visrag_tpu_torch.config import ModelConfig
    from visrag_tpu_torch.driver.common import build_visrag_ret
    from visrag_tpu_torch.preprocess import (MockTokenizer,
                                             build_encode_batch,
                                             pick_patch_bucket)

    t0 = time.perf_counter()
    model, pcfg = build_visrag_ret(ModelConfig(), device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tok = MockTokenizer()
    pages = _pages(0)
    # bench.py's batch shape: the patch bucket this mix needs, and the token
    # batch cut from the 768 cap to the longest prompt (64-multiple)
    page_cfg = dataclasses.replace(pcfg, seq_len=768, seq_auto=True,
                                   max_patches=pick_patch_bucket(pages, pcfg))
    query_cfg = dataclasses.replace(pcfg, seq_len=512, seq_auto=True,
                                    max_patches=pick_patch_bucket([], pcfg))
    queries = [(f"Represent this query for retrieving relevant documents: "
                f"what does page {i} report for quarter {i % 4 + 1}?", None)
               for i in range(N_QUERIES)]
    t0 = time.perf_counter()
    raw_pages = build_encode_batch(tok, pages, page_cfg, device_mode=True)
    host_s = time.perf_counter() - t0
    raw_queries = build_encode_batch(tok, queries, query_cfg,
                                     device_mode=True)
    return {"model": model, "pcfg": pcfg, "init_s": init_s,
            "host_s": host_s, "batches": {"pages": raw_pages,
                                          "queries": raw_queries}}


def phase3_slice(setup):
    import numpy as np

    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.preprocess.device import (finish_encode_batch,
                                                    pos_table_tensor)
    from visrag_tpu_torch.retrieval import evaluate_run
    from visrag_tpu_torch.retrieval.encode import encode_dataset
    from visrag_tpu_torch.retrieval.search import StreamingSearcher, build_run

    model = setup["model"]
    raw_pages = setup["batches"]["pages"]
    raw_queries = setup["batches"]["queries"]
    n_params = sum(p.numel() for p in model.parameters())
    table = pos_table_tensor(setup["pcfg"].src_grid, "cuda")
    n_slices = int(raw_pages["patch_mask"].any(axis=1).sum())

    @torch.inference_mode()
    def step(**raw):
        return model(finish_encode_batch(raw, table))

    step(**raw_pages)                     # warm-up batch (not counted)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    al.flat_launches = al.stacked_launches = 0
    page_ids = [f"p{i}" for i in range(N_PAGES)]
    query_ids = [f"q{i}" for i in range(N_QUERIES)]
    t0 = time.perf_counter()
    _, page_reps = encode_dataset(step, [(page_ids, raw_pages)])
    _, query_reps = encode_dataset(step, [(query_ids, raw_queries)])
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = {"flat": al.flat_launches, "stacked": al.stacked_launches}
    n_batches = 2
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    vit_depth = model.cfg.backbone.vit.depth
    lm_depth = model.cfg.backbone.llm.num_hidden_layers
    if launches != {"flat": vit_depth * n_batches,
                    "stacked": lm_depth * n_batches}:
        raise RuntimeError(f"kernel launches {launches} != "
                           f"{vit_depth}+{lm_depth} per encode batch")
    for name, reps, n in (("pages", page_reps, N_PAGES),
                          ("queries", query_reps, N_QUERIES)):
        if reps.shape != (n, model.cfg.backbone.llm.hidden_size):
            raise RuntimeError(f"{name}: embeddings shape {reps.shape}")
        if not np.isfinite(reps).all():
            raise RuntimeError(f"{name}: non-finite embeddings")
        norms = np.linalg.norm(reps, axis=1)
        if not np.allclose(norms, 1.0, atol=1e-3):
            raise RuntimeError(f"{name}: not unit norm ({norms})")

    searcher = StreamingSearcher(k=10, device="cuda")
    s_self, i_self = searcher.search(page_reps, [(page_reps[:8], 0),
                                                 (page_reps[8:], 8)])
    if not (i_self[:, 0] == np.arange(N_PAGES)).all():
        raise RuntimeError(f"self-retrieval failed: top-1 {i_self[:, 0]}")
    t0 = time.perf_counter()
    scores, idx = searcher.search(query_reps, [(page_reps, 0)])
    search_ms = (time.perf_counter() - t0) * 1e3
    run = build_run(scores, idx, query_ids, page_ids)
    qrels = {q: {f"p{i}": 1} for i, q in enumerate(query_ids)}
    metrics = evaluate_run(run, qrels, k=10)
    if len(run) != N_QUERIES or any(len(v) != 10 for v in run.values()):
        raise RuntimeError("retrieval run is incomplete")

    # steady-state device time of one page batch (finish + encode), after
    # the warm-up above
    reps_ms = cuda_ms(lambda: step(**raw_pages), reps=3)
    pages_s = N_PAGES / (reps_ms / 1e3)
    log(f"[3] VisRAG-Ret full width bf16, {n_params / 1e9:.3f}B params "
        f"(init {setup['init_s']:.1f} s): {N_PAGES} pages = {n_slices} "
        f"slices at patch bucket {raw_pages['patch_mask'].shape[1]}, token "
        f"batch "
        f"{raw_pages['input_ids'].shape[1]}; {N_QUERIES} queries at "
        f"{raw_queries['input_ids'].shape[1]} tokens | host preprocess "
        f"{setup['host_s']:.2f} s/page batch | encode_dataset pages+queries "
        f"{e2e_s:.2f} s | kernel launches {launches} over {n_batches} "
        f"batches | self-retrieval top-1 ok | query top-10 search "
        f"{search_ms:.2f} ms | metrics (random weights) "
        f"{json.dumps(metrics)}")
    log(f"[3] steady state: {reps_ms:.1f} ms per {N_PAGES}-page batch = "
        f"{pages_s:.2f} pages/s | peak memory {peak_gb:.2f} GB | {smi()}")
    return launches


def main():
    # full fp32 wherever fp32 is asked for (pos embed, the fp32 references)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase0_environment()
    phase1_build()
    setup = phase3_setup()
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = phase2_kernel(gen, setup)
    launches = phase3_slice(setup)
    from visrag_tpu_torch.ops import attention_lengths as al
    kernels = []
    for form, name in (("flat", "flash_fwd_lengths_flat"),
                       ("stacked", "flash_fwd_lengths")):
        page = results[form][0]
        kernels.append({"name": name, "route": "cuda", "source": al.SOURCE,
                        "replaces": "visrag_tpu/ops/attention_lengths.py:47",
                        "launches": launches[form],
                        "max_abs_err": page["max_abs_err"], "ms": page["ms"],
                        "plain_ms": page["plain_ms"],
                        "checks": results[form]})
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

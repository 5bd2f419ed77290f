"""Where K3's time goes: the persistent banded-attention kernel timed with
parts switched off, in turns.

    python3 tools/torch_probe_kvgrid.py

Copies csrc/attention_kvgrid_hopper.cu into visrag_tpu_torch/build/ and
builds it once per variant (nvcc, all at once) with PROBE_MODE bits that
switch off the consumers' products and softmax (1: the loads and the
stores alone), the producer's K/V loads (2: the products on whatever shared
memory holds) and the epilogue's stores (4; the compiler may then drop the
products too, whose results nothing reads: 5 and 4 read alike when it
does), the epilogue's 16-byte stores (8: the body's 4-byte stores
instead), and with PROBE_STAGES, the K/V ring's depth. Each variant runs at
chip_smoke.py phase 6's shapes (the first 3-page request of the 7B
serving run: its window and image ids, 16 heads, d 80, on views of one
fused qkv tensor), timed by chip_smoke.cuda_ms in turns (the variants in
order, then in reverse), the full kernel first held against the plain
version. Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig  # noqa: E402
from visrag_tpu_torch.ops import _build  # noqa: E402
from visrag_tpu_torch.ops import attention_kvgrid as kg  # noqa: E402

NAME = "attention_kvgrid_hopper"
PATCHES = (
    ("  static constexpr int STAGES = 4;\n",
     "  static constexpr int STAGES = PROBE_STAGES ? PROBE_STAGES : 4;\n"),
    ("            mbar_arrive_expect_tx(&full[ring.stage], 2 * S::KV);\n",
     "            if (PROBE_MODE & 2) {\n"
     "              mbar_arrive(&full[ring.stage]);\n"
     "            } else {\n"
     "            mbar_arrive_expect_tx(&full[ring.stage], 2 * S::KV);\n"),
    ("                         it.b);\n          }\n          ring.advance();",
     "                         it.b);\n            }\n          }\n"
     "          ring.advance();"),
    ("      if (cls != SKIP && half == WHOLE) {\n",
     "      if (cls != SKIP && half == WHOLE && !(PROBE_MODE & 1)) {\n"),
    ("      } else if (cls != SKIP) {\n",
     "      } else if (cls != SKIP && !(PROBE_MODE & 1)) {\n"),
    ("    fwd_store<D, LSE, true>(",
     "    if (!(PROBE_MODE & 4)) fwd_store<D, LSE, !(PROBE_MODE & 8)>("),
)
VARIANTS = (("full", 0, 0), ("no products", 1, 0), ("no K/V loads", 2, 0),
            ("no stores", 4, 0), ("loads alone", 5, 0),
            ("4-byte stores", 8, 0), ("3 stages", 0, 3))


def build_variants():
    """→ {label: loaded library}, one nvcc each, all at once."""
    src = os.path.join(ROOT, "visrag_tpu_torch", "csrc", f"{NAME}.cu")
    text = open(src).read()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise RuntimeError(f"probe patch does not apply: {old!r}")
        text = text.replace(old, new)
    out_dir = _build.BUILD_DIR / "probe_kvgrid"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in (_build.CSRC_DIR).glob("*.cuh"):
        shutil.copy(header, out_dir)
    probe_src = out_dir / f"{NAME}.cu"
    probe_src.write_text(text)

    def build(variant):
        label, mode, stages = variant
        out = out_dir / f"lib_{mode}_{stages}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS,
               f"-DPROBE_MODE={mode}", f"-DPROBE_STAGES={stages}", "-o",
               str(out), str(probe_src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{proc.stdout}"
                               f"{proc.stderr}")
        return label, ctypes.CDLL(str(out))

    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as ex:
        return dict(ex.map(build, VARIANTS))


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    libs = build_variants()
    reqs = cs._serving_requests(cs.StandInTokenizer(), Qwen25VLConfig.b7())
    vb = {n: r for n, r, _ in reqs}["pages3_0"]["vision_batch"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    load = _build.load_library
    for name in ("seg_window", "seg_full"):
        ids = torch.as_tensor(np.asarray(vb[name], np.int32)[None],
                              device="cuda")
        qkv = torch.randn(1, ids.shape[1], 3, 16, 80, generator=gen,
                          device="cuda").bfloat16()
        q, k, v = qkv.unbind(2)

        def run(label):
            _build.load_library = \
                lambda n: libs[label] if n == NAME else load(n)
            try:
                return kg._launch(q, k, v, ids, 80 ** -0.5)
            finally:
                _build.load_library = load

        ref = kg.flash_attention_kvgrid_reference(q, k, v, ids)
        err = (run("full").float() - ref.float()).abs().max().item()
        times = {label: [] for label, _, _ in VARIANTS}
        for label in list(times) + list(times)[::-1]:
            times[label].append(cs.cuda_ms(lambda: run(label)))
        print(f"[probe] K3 {name} (S {ids.shape[1]}, 16 heads, d 80; full "
              f"kernel max_abs_err {err:.4g} against the plain version): "
              + ", ".join(f"{label} {statistics.mean(t):.4f} ms"
                          for label, t in times.items())
              + f" (turns {times}) | {cs.smi()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

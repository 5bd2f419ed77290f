"""Where K5's time goes: the paged decode kernel timed with parts switched
off, at other ring depths and at other split counts.

    python3 tools/torch_probe_paged.py [--shape 7b|7b8|3b|minicpm|all]
        [--other FILE]

Copies csrc/paged_decode_hopper.cu into visrag_tpu_torch/build/ and builds
it once per variant (nvcc, all at once) with PROBE_MODE bits that switch
off the products and the softmax (1: the cp.async ring alone), the
cp.async gathers (2: the products on whatever shared memory holds), the
cluster's merge of the splits (4: each block stops after the cluster
barrier that follows the stores of its partial into the other blocks),
everything after the ring (8: no partials,
no merge, no output; 9: the ring alone), everything after the block
barrier that follows the ring (16), or from that barrier on (128: the
warps' sums of l are the last work), the stores into the other blocks,
the cluster's barrier and merge (32: each block stops at its warps'
merge weights) and the whole kernel (64: the launch
alone; 320: the launch alone, without the cluster attribute), and with
PROBE_STAGES, the ring's depth. --cold also times the kernel as the
wrapper runs it and the first kernel (legacy=True, where it takes the
shape) with the L2 cache flushed before each call. --other
builds another version of the source with the same entry point (e.g. a
parent's, unpacked under the git-ignored chip_checkout/) and times it in
the same call. Each variant runs on bf16 and int8 pools at the chosen shapes (the
7B decode shape of chip_smoke.py phase 6 by default), at the split count
the wrapper's plan gives and at others passed to the entry point directly,
timed by CUDA events (the median interval of a burst of 10 queued behind a
device spin). Variant 0 (mode 0, the default depth) is first held against
the plain version. Where a mode leaves the accumulators unread (8, 9, 16,
128), the compiler may drop the P.V products and the V conversions, so
those modes can under-count the products' cost. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch

from torch_check_paged import (DECODE_7B, bound_ms, burst_ms,  # noqa: E402
                               cold_ms, make_case)
from visrag_tpu_torch.ops import _build  # noqa: E402
from visrag_tpu_torch.serving import paged_kv as pk  # noqa: E402

PATCHES = (
    ("  static constexpr int STAGES = QUANT ? 3 : 2;\n",
     "  static constexpr int STAGES = PROBE_STAGES ? PROBE_STAGES\n"
     "                                             : (QUANT ? 3 : 2);\n"),
    ("  using C = Cfg<D, QUANT>;\n  constexpr int RPI = 32 / C::CPR;\n",
     "  using C = Cfg<D, QUANT>;\n  constexpr int RPI = 32 / C::CPR;\n"
     "  if (PROBE_MODE & 2) return;\n"),
    ("    const int tok0 = first + k * TILE;\n",
     "    const int tok0 = first + k * TILE;\n"
     "    if (PROBE_MODE & 1) continue;\n"),
    ("  cp_wait<0>();\n", "  cp_wait<0>();\n  if (PROBE_MODE & 8) return;\n"),
    ("  extern __shared__ __align__(128) unsigned char smem[];\n",
     "  extern __shared__ __align__(128) unsigned char smem[];\n"
     "  if (PROBE_MODE & 64) return;\n"),
    ("  __syncthreads();   // every warp is done with its ring: reuse it\n",
     "  if (PROBE_MODE & 128) return;\n"
     "  __syncthreads();   // every warp is done with its ring: reuse it\n"
     "  if (PROBE_MODE & 16) return;\n"),
    ("  err = cudaLaunchKernelEx(&cfg, paged_decode_kernel<D, QUANT>, p);\n",
     "  if (PROBE_MODE & 256)\n"
     "    paged_decode_kernel<D, QUANT><<<cfg.gridDim, THREADS,\n"
     "        Cfg<D, QUANT>::SMEM, st>>>(p);\n"
     "  else\n"
     "    err = cudaLaunchKernelEx(&cfg, paged_decode_kernel<D, QUANT>, p);\n"),
    ("  if (p.splits > 1) cluster_wait();   // every block of the cluster runs\n",
     "  if (PROBE_MODE & 32) return;\n"
     "  if (p.splits > 1) cluster_wait();   // every block of the cluster runs\n"),
    ("  cluster_sync();   // every block's slices and (m, l) are in place\n",
     "  cluster_sync();   // every block's slices and (m, l) are in place\n"
     "  if (PROBE_MODE & 4) return;\n"),
)
# (mode, stages): 0 = the kernel as it is
VARIANTS = ((0, 0), (1, 0), (2, 0), (4, 0), (8, 0), (9, 0), (16, 0),
            (32, 0), (64, 0), (128, 0), (320, 0), (0, 2), (0, 3), (0, 4))
SHAPES = {"7b": ("7B decode", DECODE_7B, 28, 4, 128, 128),
          "7b8": ("7B decode bs 8", DECODE_7B, 28, 4, 128, 8),
          "3b": ("3B rollout bs 8", [16536, 15064, 11925, 1888, 4110, 13537,
                                     5876, 15748], 16, 2, 128, 8),
          "minicpm": ("MiniCPM-2B", [4096, 1, 1732, 3432], 36, 36, 64, 128)}


def build_variant(mode: int, stages: int, path=None, tag=None):
    if path is None:
        src = (_build.CSRC_DIR / "paged_decode_hopper.cu").read_text()
        for old, new in PATCHES:
            if src.count(old) != 1:
                raise RuntimeError(f"probe patch does not apply: {old!r}")
            src = src.replace(old, new)
    else:
        src = open(path).read()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = tag or f"m{mode}s{stages}"
    cu = _build.BUILD_DIR / f"paged_probe_{tag}.cu"
    so = _build.BUILD_DIR / f"libpaged_probe_{tag}.so"
    cu.write_text(f"#define PROBE_MODE {mode}\n#define PROBE_STAGES {stages}"
                  f"\n{src}")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = lib.visrag_paged_decode_hopper
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    return (mode, stages), (fn, lib)


def _ptrs(pools):
    kp, vp = pools
    if isinstance(kp, pk.KVQuant):
        return (kp.data.data_ptr(), vp.data.data_ptr(), kp.scale.data_ptr(),
                vp.scale.data_ptr())
    return kp.data_ptr(), vp.data_ptr(), None, None


def caller(fn, q, pools, table, lens, splits):
    """The wrapper's launch with an explicit split count."""
    s, h, d = q.shape
    _, kvh, bs, _ = pools[0].shape
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = _ptrs(pools)

    def run():
        rc = fn(q.data_ptr(), *ptrs, table.data_ptr(), lens.data_ptr(),
                o.data_ptr(), s, h, kvh, d, bs, table.shape[1], splits,
                float(d ** -0.5), stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")
        return o
    return run


def _plan(lib, lens, kvh, table, bs, d, quantized):
    clusters = tuple(lib.visrag_paged_decode_hopper_clusters(
        d, int(quantized), c) for c in range(1, pk.MAX_SPLITS + 1))
    return pk.split_plan(len(lens), kvh, table.shape[1], bs, clusters)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="7b",
                    choices=("7b", "7b8", "3b", "minicpm", "all"))
    ap.add_argument("--other", help="another version of the source")
    ap.add_argument("--cold", action="store_true",
                    help="also time with the L2 cache flushed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    with ThreadPoolExecutor(len(VARIANTS) + 1) as ex:
        jobs = [ex.submit(build_variant, *v) for v in VARIANTS]
        other = ex.submit(build_variant, 0, 0, args.other, "other") \
            if args.other else None
        libs = dict(j.result() for j in jobs)
        other = other.result()[1] if other else None
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip(), flush=True)
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    for key in shapes:
        name, lens, h, kvh, d, bs = SHAPES[key]
        for quantized in (False, True):
            q, pools, table, lens_t = make_case(lens, h, kvh, d, bs,
                                                quantized, 1)
            plan = _plan(libs[(0, 0)][1], lens, kvh, table, bs, d, quantized)
            ref = pk.paged_decode_reference(q, *pools, table, lens_t,
                                            d ** -0.5)
            for n in sorted({plan, 1, 4, 8, 16}):
                base = caller(libs[(0, 0)][0], q, pools, table, lens_t, n)()
                rel = (torch.linalg.norm((base - ref).float())
                       / torch.linalg.norm(ref.float())).item()
                if not rel < (3.5e-3 if quantized else 2e-2):
                    raise RuntimeError(f"{name}: splits {n} rel {rel}")
            print(f"{name} {'int8' if quantized else 'bf16'}: plan {plan} "
                  f"splits, all split counts right; bound "
                  f"{bound_ms(lens, h, kvh, d, quantized, table):.4f} ms",
                  flush=True)
            rows = []
            if other:
                fn, lib = other
                n = _plan(lib, lens, kvh, table, bs, d, quantized)
                run = caller(fn, q, pools, table, lens_t, n)
                rel = (torch.linalg.norm((run() - ref).float())
                       / torch.linalg.norm(ref.float())).item()
                rows.append(("other", run, f"splits {n}, rel {rel:.3g}"))
            for (mode, stages), (fn, lib) in libs.items():
                if (mode, stages) == (0, 0):
                    for n in sorted({plan, 4, 8, 16}):
                        rows.append((f"mode 0 stages default splits {n}",
                                     caller(fn, q, pools, table, lens_t, n),
                                     ""))
                    continue
                n = _plan(lib, lens, kvh, table, bs, d, quantized)
                rows.append((f"mode {mode} stages {stages or 'default'} "
                             f"splits {n}",
                             caller(fn, q, pools, table, lens_t, n), ""))
            # in turns: every row, then every row again in reverse
            times = {label: [] for label, _, _ in rows}
            for label, run, _ in rows + rows[::-1]:
                times[label].append(burst_ms(run))
            for label, _, note in rows:
                t = times[label]
                print(f"  {label}: {t[0]:.4f} / {t[1]:.4f} ms {note}",
                      flush=True)
            if args.cold:
                new = lambda: pk.paged_decode_attention(  # noqa: E731
                    q, *pools, table, lens_t)
                turns = [("kernel", new)]
                if d == bs == 128:
                    turns.append(("first kernel (legacy=True)",
                                  lambda: pk.paged_decode_attention(
                                      q, *pools, table, lens_t, legacy=True)))
                cold = {label: [] for label, _ in turns}
                for label, fn in turns + turns[::-1]:
                    cold[label].append(cold_ms(fn))
                for label, t in cold.items():
                    print(f"  L2 flushed, {label}: {t[0]:.4f} / {t[1]:.4f} "
                          f"ms", flush=True)
            del q, pools, table
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

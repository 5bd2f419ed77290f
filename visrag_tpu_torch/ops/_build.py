"""Build the package's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by nvcc
for Hopper (sm_90a) into `visrag_tpu_torch/build/` at first use, then loaded
with ctypes. The library's file name carries a hash of the source, the
shared headers (`csrc/*.cuh`) and the flags, so an edited source is rebuilt
and a stale build is never loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("attention_lengths_hopper", "attention_lengths_bwd_hopper",
           "attention_segment_hopper", "attention_kvgrid_hopper",
           "attention_chunk_hopper",
           "attention_lengths", "attention_lengths_bwd", "attention_kvgrid",
           "paged_decode_hopper", "paged_decode", "attention_segment",
           "matmul_int8_hopper", "matmul_int8", "norms")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc from PATH, else the CUDA toolkit's default location."""
    path = shutil.which("nvcc")
    if path:
        return path
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                       "kernels of visrag_tpu_torch cannot be built")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a build of this exact source exists.
    Raises RuntimeError with the compiler's output if nvcc fails. The
    compiler's report (registers, shared memory, spills) is kept in
    build/<name>.log."""
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}.cu:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    (BUILD_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def ptxas_report(name: str):
    """→ (registers per kernel, sorted; the kernels that spill; the kernels
    with a stack frame) from build/<name>.log, the compiler's report of the
    last build."""
    lines = (BUILD_DIR / f"{name}.log").read_text().splitlines()
    regs = sorted({int(line.split("Used ")[1].split()[0])
                   for line in lines if "Used " in line})
    pairs = [(prev.split("for ")[-1].strip(), line)
             for prev, line in zip(lines, lines[1:])
             if "spill stores" in line]
    spilled = [k for k, line in pairs
               if "0 bytes spill stores, 0 bytes spill loads" not in line]
    stacked = [k for k, line in pairs
               if not line.strip().startswith("0 bytes stack frame")]
    return regs, spilled, stacked


def build_all(names=SOURCES) -> list:
    """Build every source at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        return list(ex.map(build, names))


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu once per process."""
    return ctypes.CDLL(str(build(name)))

"""Where K6's time goes: the Hopper int8 GEMM timed with parts switched off.

    python3 tools/torch_probe_int8.py

Copies csrc/matmul_int8_hopper.cu into visrag_tpu_torch/build/ with a MODE
template argument whose bits switch off the global stores of the epilogue
(1), the wgmma products (2) and the TMA loads (4; the producer then arrives
on the stage's barrier without a load), builds it with nvcc, checks that
MODE 0 is bit-equal to the plain version, and times every mode at the int8
encode's GEMM shapes (CUDA events, median of 10 after a spin) beside
torch._int_mm alone. A mode's time is then the time of what is left on:
mode 1 the products and loads, mode 3 the loads alone, mode 5 the products
alone, mode 6 the epilogue alone. Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from visrag_tpu_torch.ops import _build
from visrag_tpu_torch.ops import matmul_int8 as mi
from visrag_tpu_torch.ops import quant

SHAPES = ((126208, 1152, 3456), (126208, 1152, 4304), (11264, 2304, 2304),
          (11264, 2304, 5760))
PATCHES = (
    ("template <bool F32>\n__global__", "template <bool F32, int MODE>\n"
     "__global__"),
    ("      mbar_arrive_expect_tx(&full[ring.stage], SA + SB);\n",
     "      if (MODE & 4) { mbar_arrive(&full[ring.stage]); ring.advance();"
     " continue; }\n      mbar_arrive_expect_tx(&full[ring.stage], SA + "
     "SB);\n"),
    ("    for (int kk = 0; kk < BK / 32; ++kk)\n",
     "    for (int kk = 0; kk < BK / 32; ++kk)\n      if (!(MODE & 2))\n"),
    ("      if (row >= M || col >= N) continue;\n",
     "      if (row >= M || col >= N || (MODE & 1)) continue;\n"),
    ("template <bool F32>\nint launch(", "template <bool F32, int MODE>\n"
     "int launch("),
    ("auto kernel = int8_gemm_wgmma_kernel<F32>;",
     "auto kernel = int8_gemm_wgmma_kernel<F32, MODE>;"),
)
ENTRY = '''
extern "C" int k6_probe(const void* xq, const void* wq, const void* xs,
                        const void* ws, const void* bias, void* out, int M,
                        int N, int K, int mode, void* stream) {
  const float* x = static_cast<const float*>(xs);
  const float* w = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
#define VISRAG_PROBE(m) case m: return launch<false, m>(xq, wq, x, w, b, \\
    out, M, N, K, s);
    VISRAG_PROBE(0) VISRAG_PROBE(1) VISRAG_PROBE(2) VISRAG_PROBE(3)
    VISRAG_PROBE(4) VISRAG_PROBE(5) VISRAG_PROBE(6)
  }
  return -2;
}
'''


def build_probe() -> ctypes.CDLL:
    src = (_build.CSRC_DIR / "matmul_int8_hopper.cu").read_text()
    src = src[:src.index('extern "C"')]
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"probe patch does not apply: {old!r}")
        src = src.replace(old, new)
    src = src.replace('#include "hopper.cuh"',
                      f'#include "{_build.CSRC_DIR / "hopper.cuh"}"')
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "matmul_int8_probe.cu"
    so = _build.BUILD_DIR / "libmatmul_int8_probe.so"
    cu.write_text(src + ENTRY)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.k6_probe.restype = ctypes.c_int
    lib.k6_probe.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    return lib


def median_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(4_000_000)
    fn()
    ev[0].record()
    for e in ev[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(ev, ev[1:]))


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    lib = build_probe()
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for m, k, n in SHAPES:
        x = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        w = (torch.randn(n, k, generator=g, device="cuda") * 0.03).bfloat16()
        xq, xs = quant.quant_rowwise(x)
        wq, ws = quant.quant_weight_colwise(w.t())
        wq, xs = wq.t().contiguous(), xs[:, 0].contiguous()
        b = torch.randn(n, generator=g, device="cuda")
        out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        line = f"{m} x {k} -> {n}:"
        for mode in range(7):
            def fn():
                rc = lib.k6_probe(xq.data_ptr(), wq.data_ptr(), xs.data_ptr(),
                                  ws.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  m, n, k, mode, stream)
                if rc:
                    raise RuntimeError(f"probe launch failed: {rc}")
            fn()
            torch.cuda.synchronize()
            if mode == 0 and not torch.equal(
                    out, mi.int8_matmul_reference(xq, xs, wq, ws, b)):
                raise RuntimeError("probe mode 0 differs from the plain "
                                   "version")
            t = median_ms(fn)
            line += (f" mode {mode} {t:.4f} ms "
                     f"({2 * m * k * n / t / 1e9:.0f} TOP/s);")
        line += (f" torch._int_mm alone "
                 f"{median_ms(lambda: torch._int_mm(xq, wq.t())):.4f} ms")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

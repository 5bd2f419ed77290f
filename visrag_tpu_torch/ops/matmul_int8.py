"""w8a8 GEMM with the dequantizing epilogue fused (K6).

Counterpart of visrag_tpu/ops/matmul_int8.py. The kernel is CUDA C++ for
sm_90a bound with ctypes; it replaces the TPU kernel `_kernel` (launched by
`int8_matmul_fused`):

    out[m, n] = (sum_k xq[m, k] * wq[n, k]) * xs[m] * ws[n] + bias[n]

as bf16 or fp32, the int32 sum exact and the epilogue in fp32 in that
order, for any M and N. Every CUDA call runs csrc/matmul_int8_hopper.cu
(wgmma s8 x s8 -> s32 fed by TMA, one producer and two consumer
warpgroups on 128 x 256 output tiles, stored through shared memory). The first,
mma.sync kernel, csrc/matmul_int8.cu, stays compiled and is reached only
with `legacy=True`, to time one against the other; it writes bf16 at an
even N only and raises for anything else. The weight stays in torch's
(out, in) = (N, K) layout, the K-major operand the tensor cores want. K is
zero-padded on the host to the kernel's K unit (16 bytes, TMA's row pitch;
64 for the legacy kernel), as the JAX wrapper pads its blocks; zero codes
add nothing, so the padding is exact.

A CPU tensor takes `int8_matmul_reference`, the plain version; a CUDA
tensor launches the kernel or raises. `launches` counts kernel launches
and `route_counts()` splits them by kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

SOURCE = "visrag_tpu_torch/csrc/matmul_int8_hopper.cu"
K_UNIT = 16            # K bytes the Hopper kernel's rows are padded to
LEGACY_K_TILE = 64     # bytes of K per pipeline stage, mma.sync kernel
OUT_DTYPES = (torch.bfloat16, torch.float32)

launches = 0
_routes = {"hopper": 0, "legacy": 0}


def reset_launch_counts() -> None:
    global launches
    launches = 0
    for key in _routes:
        _routes[key] = 0


def route_counts() -> dict:
    """K6 launches by kernel: "hopper" (csrc/matmul_int8_hopper.cu) and
    "legacy" (the mma.sync csrc/matmul_int8.cu)."""
    return dict(_routes)


def _device_kind(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def int8_product(xq, wq):
    """Exact int32 product xq (M, K) s8 · wq (N, K)^T s8 → (M, N) int64 on
    the CPU or float64 on the card: |acc| <= 127² K < 2^53, so float64 is
    exact, while fp32 is not past 2^24."""
    if xq.device.type == "cpu":
        return xq.long() @ wq.long().t()
    return xq.double() @ wq.double().t()


def int8_matmul_reference(xq, xs, wq, ws, bias=None,
                          out_dtype=torch.bfloat16):
    """Plain version of K6: xq (M, K) int8, xs (M,) fp32, wq (N, K) int8,
    ws (N,) fp32, bias (N,) or None → (M, N) out_dtype, computed as
    float(acc) * xs * ws + bias in fp32."""
    y = int8_product(xq, wq).float() * xs.float()[:, None] \
        * ws.float()[None, :]
    if bias is not None:
        y = y + bias.float()[None, :]
    return y.to(out_dtype)


def _route(legacy=False):
    """→ (library, entry point, K unit) of K6: the Hopper kernel, or the
    mma.sync one with `legacy` (to time one against the other)."""
    if legacy:
        return "matmul_int8", "visrag_int8_gemm", LEGACY_K_TILE
    return "matmul_int8_hopper", "visrag_int8_gemm_hopper", K_UNIT


def _aligned(t):
    """t contiguous with a 16-byte-aligned base (TMA reads it)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(xq, xs, wq, ws, bias, out, legacy=False):
    """One K6 launch into `out` (M, N) bf16 or fp32 on CUDA tensors that
    int8_matmul_fused has checked; counts nothing. Raises unless the kernel
    launched."""
    library, entry, unit = _route(legacy)
    m, n = out.shape
    if legacy and (out.dtype != torch.bfloat16 or n % 2):
        raise ValueError(f"the mma.sync int8 GEMM kernel writes bfloat16 "
                         f"at an even N only, asked for {out.dtype} at N "
                         f"{n}")
    k = xq.shape[1]
    if k % unit:
        xq = F.pad(xq, (0, unit - k % unit))
        wq = F.pad(wq, (0, unit - k % unit))
    xq, wq = _aligned(xq), _aligned(wq)
    from ._build import load_library
    fn = getattr(load_library(library), entry)
    fn.restype = ctypes.c_int
    head = [xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), m, n,
            xq.shape[1]]
    if legacy:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        args = head
    else:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        args = head + [int(out.dtype == torch.float32)]
    with torch.cuda.device(xq.device):
        rc = fn(*args, torch.cuda.current_stream(xq.device).cuda_stream)
    if rc == -1:
        raise RuntimeError(f"{library} ({entry}): cuTensorMapEncodeTiled "
                           f"refused a TMA tensor map for xq "
                           f"{tuple(xq.shape)}, wq {tuple(wq.shape)}")
    if rc != 0:
        raise RuntimeError(f"int8 GEMM kernel {entry} launch failed: CUDA "
                           f"error {rc}")


def int8_matmul_fused(xq, xs, wq, ws, bias=None, out_dtype=torch.bfloat16,
                      *, legacy=False):
    """xq (M, K) int8, xs (M,) fp32, wq (N, K) int8 (torch's layout), ws
    (N,) fp32, bias (N,) float or None → (M, N) out_dtype (bf16 or fp32).
    `legacy` runs the mma.sync kernel instead (bf16, even N); the port's
    callers never set it."""
    global launches
    m, k = xq.shape
    n = wq.shape[0]
    if wq.shape[1] != k or xs.shape != (m,) or ws.shape != (n,) \
            or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"int8 GEMM shapes: xq {tuple(xq.shape)}, wq "
                         f"{tuple(wq.shape)}, xs {tuple(xs.shape)}, ws "
                         f"{tuple(ws.shape)}")
    if _device_kind(xq) == "cpu":
        return int8_matmul_reference(xq, xs, wq, ws, bias, out_dtype)
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"the int8 GEMM kernel writes {OUT_DTYPES}, asked "
                        f"for {out_dtype}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError("xq and wq must be int8")
    xs, ws = xs.float().contiguous(), ws.float().contiguous()
    if bias is not None:
        bias = bias.float().contiguous()
    for name, t in (("wq", wq), ("xs", xs), ("ws", ws), ("bias", bias)):
        if t is not None and t.device != xq.device:
            raise ValueError(f"{name} is on {t.device}, xq on {xq.device}")
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    _launch(xq, xs, wq, ws, bias, out, legacy)
    launches += 1
    _routes["legacy" if legacy else "hopper"] += 1
    return out

"""w8a8 GEMM with the dequantizing epilogue fused (K6).

Counterpart of visrag_tpu/ops/matmul_int8.py. The kernel is CUDA C++ for
sm_90a, csrc/matmul_int8.cu, bound with ctypes; it replaces the TPU kernel
`_kernel` (launched by `int8_matmul_fused`):

    out[m, n] = (sum_k xq[m, k] * wq[n, k]) * xs[m] * ws[n] + bias[n]

as bf16, the int32 sum exact and the epilogue in fp32 in that order. The
weight stays in torch's (out, in) = (N, K) layout, the K-major operand the
tensor cores want. K is zero-padded on the host to the kernel's 64-byte
k-tile, as the JAX wrapper pads its blocks; zero codes add nothing, so the
padding is exact.

A CPU tensor takes `int8_matmul_reference`, the plain version; a CUDA
tensor launches the kernel or raises. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

SOURCE = "visrag_tpu_torch/csrc/matmul_int8.cu"
K_TILE = 64            # bytes of K per pipeline stage in the kernel

launches = 0


def reset_launch_counts() -> None:
    global launches
    launches = 0


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


def int8_matmul_fused(xq, xs, wq, ws, bias=None, out_dtype=torch.bfloat16):
    """xq (M, K) int8, xs (M,) fp32, wq (N, K) int8 (torch's layout), ws
    (N,) fp32, bias (N,) float or None → (M, N) out_dtype. The kernel writes
    bf16 only."""
    global launches
    m, k = xq.shape
    n = wq.shape[0]
    if wq.shape[1] != k or xs.shape != (m,) or ws.shape != (n,) \
            or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"int8 GEMM shapes: xq {tuple(xq.shape)}, wq "
                         f"{tuple(wq.shape)}, xs {tuple(xs.shape)}, ws "
                         f"{tuple(ws.shape)}")
    if xq.device.type == "cpu":
        return int8_matmul_reference(xq, xs, wq, ws, bias, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"the int8 GEMM kernel writes bfloat16, asked for "
                        f"{out_dtype}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError("xq and wq must be int8")
    if n % 2:
        raise ValueError(f"the int8 GEMM kernel takes an even N, got {n}")
    if k % K_TILE:
        xq = F.pad(xq, (0, K_TILE - k % K_TILE))
        wq = F.pad(wq, (0, K_TILE - k % K_TILE))
    xq, wq = xq.contiguous(), wq.contiguous()
    xs, ws = xs.float().contiguous(), ws.float().contiguous()
    if bias is not None:
        bias = bias.float().contiguous()
    for name, t in (("xq", xq), ("wq", wq), ("xs", xs), ("ws", ws),
                    ("bias", bias)):
        if t is not None and t.device != xq.device:
            raise ValueError(f"{name} is on {t.device}, xq on {xq.device}")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xq.device)
    from ._build import load_library
    fn = load_library("matmul_int8").visrag_int8_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    with torch.cuda.device(xq.device):
        rc = fn(xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                m, n, xq.shape[1],
                torch.cuda.current_stream(xq.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8 GEMM kernel launch failed: CUDA error {rc}")
    launches += 1
    return out

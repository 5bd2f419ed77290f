"""int8 (w8a8) matmul path for the encode towers.

Counterpart of visrag_tpu/ops/quant.py. Inference-only and opt-in
(`SiglipViTConfig.quant`, `MiniCPMConfig.quant`): the bf16 path stays the
default.

Scheme: symmetric per-row (token) dynamic activation scales times
per-column (output channel) weight scales; both factor out of the GEMM's
contraction exactly:

    y[m, n] = (xq[m, :] . wq[:, n]) * xs[m] * ws[n]

The quantization keeps the JAX package's operation order so that the int8
codes are the same bit for bit: fp32 divide by max(amax, 1e-8) / 127,
round half to even, clip to ±127. The activation pass is plain PyTorch
(it is plain XLA in the JAX package); the GEMM with its fp32 epilogue is
K6 (ops/matmul_int8.py) on a CUDA tensor and its exact plain version on a
CPU tensor. The KV cache's quantization (serving/paged_kv.quantize_kv) has
its own convention and lives there.
"""

from __future__ import annotations

import torch

from .matmul_int8 import int8_matmul_fused, int8_matmul_reference


def quant_rowwise(x, axis: int = -1):
    """x (..., k) → (int8 q, fp32 scale (..., 1)). Symmetric absmax."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    # a tensor divisor: PyTorch's CUDA kernels divide by a Python scalar
    # as a multiply by its reciprocal, which can round the scale an ulp
    # away from the CPU's division, and a code a step away with it
    scale = torch.clamp_min(amax, 1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quant_weight_colwise(w):
    """w (k, n) → (int8 (k, n), fp32 (n,)), per output channel."""
    wf = w.float()
    amax = wf.abs().amax(dim=0)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale[None, :]), -127,
                    127).to(torch.int8)
    return q, scale


def int8_matmul(xq, xs, wq, ws, out_dtype=torch.bfloat16):
    """(m, k) s8 @ (k, n) s8 → out_dtype, the scales applied to the exact
    int32 product in fp32 (xs (m, 1) or (m,), ws (n,))."""
    return int8_matmul_reference(xq, xs.reshape(-1), wq.t(), ws, None,
                                 out_dtype)


def int8_linear(x, wq, ws, bias=None, out_dtype=torch.bfloat16):
    """Dense with pre-quantized weights in torch's layout: x (..., k)
    quantized per row here, wq (n, k) int8, ws (n,) fp32, bias (n,) added
    in fp32 → (..., n) out_dtype through K6 (CUDA) or its plain version."""
    lead = x.shape[:-1]
    xq, xs = quant_rowwise(x.reshape(-1, x.shape[-1]))
    y = int8_matmul_fused(xq, xs[:, 0], wq, ws, bias, out_dtype=out_dtype)
    return y.reshape(*lead, wq.shape[0])


def int8_dense(x, w, bias=None, out_dtype=torch.bfloat16):
    """Drop-in dense as in the JAX package: dynamic per-row activation
    quant, per-column weight quant, s8 GEMM. x (..., k), w (k, n) float,
    bias added in fp32."""
    wq, ws = quant_weight_colwise(w)
    return int8_linear(x, wq.t().contiguous(), ws, bias, out_dtype)

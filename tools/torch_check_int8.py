"""Build K2 (valid-length backward, on the Hopper core) and K6 (the int8
GEMM, on wgmma s8 and TMA), print the compiler's report, and hold each
kernel against its plain PyTorch version on the card (K5:
tools/torch_check_paged.py).

    python3 tools/torch_check_int8.py [--time] [--only k2|k6]

A short first check for these kernels: registers and spills from ptxas,
then K2 at d = 64 / 72 / 128 with grouped kv heads (16/2, 28/4), K6 at the
encode's GEMM shapes and at edge shapes (odd N, N = 1, M = 1, K not a
multiple of 16, fp32 output), bit for bit. With --time it also times them with
CUDA events (median of 10), K6 in turns with the mma.sync kernel beside
torch._int_mm alone and with the scaling. Needs one
CUDA card; exits 1 on any disagreement.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from visrag_tpu_torch.ops import _build
from visrag_tpu_torch.ops import attention_lengths as al
from visrag_tpu_torch.ops import matmul_int8 as mi
from visrag_tpu_torch.ops import quant

SOURCES = ("attention_lengths_hopper", "attention_lengths_bwd_hopper",
           "matmul_int8_hopper", "matmul_int8")
DEV = "cuda"


def median_ms(fn, n=10):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def rel(a, b):
    a, b = a.float(), b.float()
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


def check_k2(name, lens, s, h, hk, d, causal, do_time):
    g = torch.Generator(device=DEV).manual_seed(len(name))
    b = len(lens)
    q, do = (torch.randn(b, s, h, d, generator=g, device=DEV).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b, s, hk, d, generator=g, device=DEV).bfloat16()
            for _ in range(2))
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEV)
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    rs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = al.flash_fwd_lengths(*xs, lens_t, causal, d ** -0.5)
    grads = torch.autograd.grad(o, xs, do)
    ref = torch.autograd.grad(al.lengths_attention_reference(
        *rs, lens_t, causal, d ** -0.5), rs, do)
    valid = torch.arange(s, device=DEV)[None] < lens_t[:, None]
    errs = [rel(a[valid], w[valid]) for a, w in zip(grads, ref)]
    zeros = all(not bool(a[~valid].any()) for a in grads)
    ok = zeros and max(errs) <= 2e-2 and all(
        bool(torch.isfinite(a.float()).all()) for a in grads)
    line = (f"K2 {name} lens {lens} S {s} {h}/{hk} d {d} causal {causal}: "
            f"rel dq {errs[0]:.4g} dk {errs[1]:.4g} dv {errs[2]:.4g} "
            f"pad_zeros={zeros} {'ok' if ok else 'FAIL'}")
    if do_time:
        o2 = torch.empty_like(q)
        lse = al.flash_fwd_lse(q, k, v, lens_t, causal, d ** -0.5, o2)
        delta = torch.empty_like(lse)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        t_q = median_ms(lambda: al.flash_bwd_dq(q, k, v, o2, do, lse, delta,
                                                lens_t, causal, d ** -0.5,
                                                dq))
        t_kv = median_ms(lambda: al.flash_bwd_dkv(q, k, v, o2, do, lse, delta,
                                                  lens_t, causal, d ** -0.5,
                                                  dk, dv))
        line += f" dq={t_q:.3f}ms dkv={t_kv:.3f}ms"
    print(line, flush=True)
    return ok


def check_k6(name, m, k, n, do_time, bias=True):
    """K6 bit for bit against its plain version, bf16 and fp32 output."""
    g = torch.Generator(device=DEV).manual_seed(m + n)
    x = torch.randn(m, k, generator=g, device=DEV).bfloat16()
    w = (torch.randn(n, k, generator=g, device=DEV) * 0.03).bfloat16()
    b = torch.randn(n, generator=g, device=DEV) if bias else None
    xq, xs = quant.quant_rowwise(x)
    wq, ws = quant.quant_weight_colwise(w.t())
    wq, xs = wq.t().contiguous(), xs[:, 0].contiguous()
    ok = True
    line = f"K6 {name} {m}x{k}->{n}:"
    for dt in (torch.bfloat16, torch.float32):
        out = mi.int8_matmul_fused(xq, xs, wq, ws, b, dt)
        ref = mi.int8_matmul_reference(xq, xs, wq, ws, b, dt)
        torch.cuda.synchronize()
        same = torch.equal(out, ref)
        diff = (out.float() - ref.float()).abs()
        ok &= same and bool(torch.isfinite(out.float()).all())
        line += (f" {str(dt)[6:]} bit-equal {same} (max_abs "
                 f"{diff.max().item():.4g}, {int((diff != 0).sum())} of "
                 f"{diff.numel()} differ)")
    line += f" {'ok' if ok else 'FAIL'}"
    if do_time:
        new = lambda: mi.int8_matmul_fused(xq, xs, wq, ws, b)   # noqa: E731
        old = lambda: mi.int8_matmul_fused(xq, xs, wq, ws, b,   # noqa: E731
                                           legacy=True)
        t = {"new": [], "old": []}
        for which in ("new", "old", "old", "new"):
            t[which].append(median_ms(new if which == "new" else old))
        t_mm = median_ms(lambda: torch._int_mm(xq, wq.t()))

        def scaled():
            y = torch._int_mm(xq, wq.t()).float() * xs[:, None] \
                * ws[None, :]
            return (y if b is None else y + b[None, :]).to(torch.bfloat16)
        t_lib = median_ms(scaled)
        mean = {kk: sum(v) / len(v) for kk, v in t.items()}
        line += (f" | kernel {mean['new']:.4f} ms "
                 f"({2 * m * k * n / mean['new'] / 1e9:.1f} TOP/s) in turns "
                 f"with mma.sync {mean['old']:.4f} ({t}); torch._int_mm alone "
                 f"{t_mm:.4f}, + scaling {t_lib:.4f}")
    print(line, flush=True)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--only", choices=("k2", "k6"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    t0 = time.time()
    _build.build_all(SOURCES)
    print(f"built in {time.time() - t0:.1f}s", flush=True)
    for name in SOURCES[1:]:
        regs, spilled, _ = _build.ptxas_report(name)
        print(f"{name}: registers {regs}, spills {spilled or 'none'}",
              flush=True)
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip(), flush=True)
    ok = True
    t = args.time
    run = lambda kind: args.only in (None, kind)   # noqa: E731
    if run("k2"):
        ok &= check_k2("3B padded update", [1920, 1500, 700, 64], 1920, 16,
                       2, 128, True, t)
        ok &= check_k2("7B grouping edges", [1, 63, 64, 65, 256], 256, 28, 4,
                       128, True, t)
        ok &= check_k2("non-causal d128", [200, 129], 200, 8, 2, 128, False,
                       t)
        ok &= check_k2("LM d64", [704, 300, 1], 704, 36, 36, 64, True, t)
        ok &= check_k2("ViT d72", [1152, 600, 0, 65], 1152, 16, 16, 72, False,
                       t)
    if run("k6"):
        m_vit, m_lm = (126208, 11264) if t else (4176, 1104)
        ok &= check_k6("ViT qkv", m_vit, 1152, 3456, t)
        ok &= check_k6("ViT fc1", m_vit, 1152, 4304, t)
        ok &= check_k6("LM q/k/v/o", m_lm, 2304, 2304, t, bias=False)
        ok &= check_k6("LM gate/up", m_lm, 2304, 5760, t, bias=False)
        for name, m, k, n in (("ragged K", 77, 200, 70),
                              ("odd N", 333, 1152, 4305),
                              ("N = 1", 130, 256, 1), ("M = 1", 1, 2304, 2304),
                              ("K off 16", 129, 1000, 257)):
            ok &= check_k6(name, m, k, n, False)
    print("ALL OK" if ok else "SOME FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

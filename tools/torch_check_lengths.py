"""Build the valid-length attention kernels (K1 and K2 on the Hopper core,
and PR 1's and PR 5's mma.sync kernels) and the RMSNorm kernels (K7), print
the compiler's report, and hold each against its plain PyTorch version on
the card.

    python3 tools/torch_check_lengths.py [--time] [--only k1|k2|k7]

A short first check for an edited kernel, descriptors first: the 32-byte-
swizzle probe (`visrag_hopper_desc_probe`: a 16-column piece loaded by TMA
with columns past d zero-filled, read through K-major and MN-major
descriptors by SS m64n64k16, RS m64n16k16 and SS m64n16k16) against torch
products; then K1 without and with the LSE at d 64 / 72 / 128, flat and
stacked, causal and not, grouped kv heads (16/2, 28/4), lengths 0, 1,
63-65, 127-129 and full, a partial last query tile, with pad rows exactly 0
and their LSE exactly LSE_PAD; then the backward's probe
(`visrag_hopper_bwd_desc_probe`: the 16-column piece MN-major as the dV,
dQ and dK products read it, from row 0 and from row 32, and K-major from
row 32) against torch products, and K2 (dq, dk/dv) at the same head dims,
forms, groupings and edge lengths against the plain autograd, pad rows of
dq, dk and dv exactly 0; then the warp-per-row RMSNorm at every width the
models give it and at edges. With --time it also times the Hopper K1 and
K2 and the legacy mma.sync kernels in turns (new, old, old, new) beside
SDPA and the bound, and the warp- and block-per-row RMSNorm kernels in
turns beside F.rms_norm, each the median of a burst of calls with a CUDA
event between consecutive calls, queued while the device spins. Needs one
CUDA card; exits 1 on any disagreement.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
import torch.nn.functional as F

from visrag_tpu_torch.ops import _build
from visrag_tpu_torch.ops import attention_lengths as al
from visrag_tpu_torch.ops import norms

DEV = "cuda"
ATOL = 2e-2      # K1 forward, bf16 kernel vs plain, unit-normal inputs
LSE_ATOL = 2e-2
RTOL_GRAD = 2e-2   # K2, relative Frobenius error on valid rows (chip_smoke)
SOURCES = ("attention_lengths_hopper", "attention_lengths",
           "attention_lengths_bwd_hopper", "attention_lengths_bwd", "norms")
NEW_KERNELS = ("attention_fwd_wgmma", "attention_dq_wgmma",
               "attention_dkv_wgmma", "attention_dkv_pair", "rms_warp")


def burst_ms(fn, n=10):
    """Median ms of one fn() in a burst of n calls with a CUDA event between
    consecutive calls, queued while the device spins (chip_smoke.cuda_ms):
    the device's time per call."""
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda._sleep(4_000_000)
    fn()
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


def report_build():
    """Builds the sources and prints each kernel's registers and spills;
    False if a kernel of the Hopper K1 or K2 or the warp-per-row RMSNorm
    spills (the block-per-row fp32 RMSNorm's 8-byte spill is older and
    printed only)."""
    _build.build_all(SOURCES)
    ok = True
    for name in SOURCES:
        lines = (_build.BUILD_DIR / f"{name}.log").read_text().splitlines()
        kernel = None
        for line in lines:
            if "Function properties for" in line:
                kernel = line.split("for ")[-1].strip()
            elif "Used " in line and kernel:
                print(f"  {name}: {kernel}: {line.split('Used ')[1].strip()}")
            elif "spill stores" in line and kernel and \
                    "0 bytes spill stores, 0 bytes spill loads" not in line:
                print(f"  {name}: SPILLS {kernel}: {line.strip()}")
                if any(k in kernel for k in NEW_KERNELS):
                    ok = False
    print(f"[build] {SOURCES}: the new kernels spill-free {ok}")
    return ok


def check_probe():
    """The 32-byte-swizzle descriptors and the n16 products on their own."""
    g = torch.Generator(device=DEV).manual_seed(1)
    x, y = (torch.randn(64, 72, generator=g, device=DEV).bfloat16()
            for _ in range(2))
    s = torch.empty(64, 64, device=DEV)
    o, o2 = (torch.empty(64, 16, device=DEV) for _ in range(2))
    fn = _build.load_library("attention_lengths_hopper") \
        .visrag_hopper_desc_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6
    rc = fn(x.data_ptr(), y.data_ptr(), s.data_ptr(), o.data_ptr(),
            o2.data_ptr(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"descriptor probe failed: {rc}")
    xt, yt = x[:, 64:].float(), y[:, 64:].float()
    want_s = xt @ yt.T
    want_o = s.bfloat16().float() @ yt
    want_o2 = x[:, :64].float() @ yt
    errs = {"s (SS n64, K-major 32B)": (s - want_s).abs().max().item(),
            "o (RS n16, MN-major 32B)": (o[:, :8] - want_o).abs().max()
            .item(),
            "o2 (SS n16, MN-major 32B)": (o2[:, :8] - want_o2).abs().max()
            .item()}
    zeros = bool((o[:, 8:] == 0).all() and (o2[:, 8:] == 0).all())
    print(f"[probe] max abs err {errs}; columns 72-79 zero-filled: {zeros}")
    return max(errs.values()) < 1e-2 and zeros


def k1_case(label, form, lens, s, h, hk, d, causal, lse, do_time, gen):
    b = len(lens)
    scale = d ** -0.5
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEV)
    if form == "flat":
        qkv = torch.randn(b * s, 3 * h * d, generator=gen,
                          device=DEV).bfloat16()
        q, k, v = qkv.view(b, s, 3, h, d).unbind(2)
    else:
        q = torch.randn(b, s, h, d, generator=gen, device=DEV).bfloat16()
        k, v = (torch.randn(b, s, hk, d, generator=gen, device=DEV)
                .bfloat16() for _ in range(2))
    # the output buffer starts as NaN, so that a row the kernel skips shows
    o = torch.full((b, s, h, d), float("nan"), dtype=torch.bfloat16,
                   device=DEV)
    ls = torch.full((b, h, s), float("nan"), device=DEV) if lse else None
    run = lambda legacy=False: al._fwd(q, k, v, o, ls, lens_t, causal,  # noqa
                                       scale, legacy=legacy)
    run()
    torch.cuda.synchronize()
    ref = torch.cat([al.lengths_attention_reference(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], lens_t[i:i + 1], causal, scale)
        for i in range(b)])
    valid = torch.arange(s, device=DEV)[None] < lens_t[:, None]
    err = (o.float() - ref.float()).abs()[valid].max().item() \
        if valid.any() else 0.0
    pad_zero = bool((o[~valid] == 0).all())
    ok = err <= ATOL and pad_zero and bool(torch.isfinite(o.float()).all())
    lse_err = None
    if lse:
        want = torch.cat([al.lengths_lse_reference(
            q[i:i + 1], k[i:i + 1], lens_t[i:i + 1], causal, scale)
            for i in range(b)])
        vm = valid[:, None, :].expand(b, h, s)
        lse_err = (ls[vm] - want[vm]).abs().max().item() if vm.any() else 0.0
        pad_lse = bool((ls[~vm] == al.LSE_PAD).all())
        ok = ok and lse_err <= LSE_ATOL and pad_lse
        pad_zero = pad_zero and pad_lse
    line = (f"[K1] {label} {form} B={b} S={s} H={h}/{hk} d={d} causal "
            f"{causal} lse {lse}: max_abs_err {err:.4g}"
            + (f", lse {lse_err:.4g}" if lse else "")
            + f", pad rows exact {pad_zero}")
    if do_time:
        turns = {"new": [], "pr1": []}
        for which in ("new", "pr1", "pr1", "new"):
            turns[which].append(burst_ms(lambda: run(which == "pr1")))
        mask = torch.arange(s, device=DEV)
        allow = mask[None, None, None, :] < lens_t.clamp(min=1)[:, None,
                                                                  None, None]
        if causal:
            allow = allow & (mask[:, None] >= mask[None, :])[None, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = burst_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=allow, scale=scale, enable_gqa=hk != h))
        pairs = sum(n * (n + 1) // 2 if causal else n * n for n in lens)
        bound = 2 * 2 * pairs * h * d / 989e12 * 1e3
        line += (f" | new {statistics.mean(turns['new']):.4f} ms, legacy "
                 f"{statistics.mean(turns['pr1']):.4f} ms (turns {turns}), "
                 f"SDPA {sdpa:.4f}, ops bound {bound:.4f}")
    print(line)
    return ok


def check_k1(do_time):
    gen = torch.Generator(device=DEV).manual_seed(0)
    edge = [0, 1, 63, 64, 65, 127, 128, 129]
    cases = [
        ("edges", "flat", edge + [1088], 1088, 16, 16, 72, False),
        ("ViT page batch slice", "flat", [1088] * 4 + [1032, 600, 0, 5],
         1088, 16, 16, 72, False),
        ("edges", "stacked", edge + [704], 704, 36, 36, 64, True),
        ("edges", "stacked", edge + [700], 704, 36, 36, 64, False),
        ("GQA 28/4", "stacked", [0, 1, 63, 64, 65, 129, 586, 4096], 4096, 28,
         4, 128, True),
        ("GQA 16/2", "stacked", [812, 4815, 1, 129], 4864, 16, 2, 128, True),
    ]
    ok = True
    for label, form, lens, s, h, hk, d, causal in cases:
        for lse in (False, True):
            ok &= k1_case(label, form, lens, s, h, hk, d, causal, lse, False,
                          gen)
        torch.cuda.empty_cache()
    if do_time:
        for label, form, lens, s, h, hk, d, causal, lse in (
                ("ViT flat 116 x 1088", "flat", [1088] * 100 + [700] * 16,
                 1088, 16, 16, 72, False, False),
                ("ViT + LSE 40 x 1152", "flat", [1152] * 30 + [0] * 10, 1152,
                 16, 16, 72, False, True),
                ("LM causal 16 x 704", "stacked", [704] * 12 + [300] * 4, 704,
                 36, 36, 64, True, False),
                ("GQA whole prefill", "stacked", [586], 4096, 28, 4, 128,
                 True, False),
                ("GQA + LSE padded update", "stacked",
                 [812, 4815, 2400, 3000], 4864, 16, 2, 128, True, True)):
            ok &= k1_case(label, form, lens, s, h, hk, d, causal, lse, True,
                          gen)
            torch.cuda.empty_cache()
    return ok


def check_bwd_probe():
    """The backward's reads of the 16-column piece on their own."""
    g = torch.Generator(device=DEV).manual_seed(3)
    x, y = (torch.randn(64, 72, generator=g, device=DEV).bfloat16()
            for _ in range(2))
    s = torch.empty(64, 64, device=DEV)
    o, oh = (torch.empty(64, 16, device=DEV) for _ in range(2))
    sh = torch.empty(64, 32, device=DEV)
    fn = _build.load_library("attention_lengths_bwd_hopper") \
        .visrag_hopper_bwd_desc_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7
    rc = fn(x.data_ptr(), y.data_ptr(), s.data_ptr(), o.data_ptr(),
            oh.data_ptr(), sh.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"backward descriptor probe failed: {rc}")
    xf, yf = x.float(), y.float()
    sb = s.bfloat16().float()
    want = {"s (SS n64, K-major 128B)": (s, xf[:, :64] @ yf[:, :64].T),
            "o (RS n16, MN-major 32B, 4 k-steps)":
                (o[:, :8], sb @ yf[:, 64:]),
            "oh (RS n16, MN-major 32B from row 32, 2 k-steps)":
                (oh[:, :8], sb[:, 32:] @ yf[32:, 64:]),
            "sh (SS n32, K-major 32B from row 32)":
                (sh, xf[:, 64:] @ yf[32:, 64:].T)}
    errs = {k: (got - ref).abs().max().item() for k, (got, ref) in
            want.items()}
    zeros = bool((o[:, 8:] == 0).all() and (oh[:, 8:] == 0).all())
    print(f"[bwd probe] max abs err {errs}; columns 72-79 zero-filled: "
          f"{zeros}")
    return max(errs.values()) < 1e-2 and zeros


def k2_case(label, form, lens, s, h, hk, d, causal, do_time, gen):
    """K2 (dq, then dk/dv on its delta) at one shape against the plain
    autograd, on K1's LSE; the outputs start as NaN, so a row the kernels
    skip shows."""
    b, scale = len(lens), d ** -0.5
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEV)
    if form == "flat":
        qkv = torch.randn(b * s, 3 * h * d, generator=gen,
                          device=DEV).bfloat16()
        q, k, v = qkv.view(b, s, 3, h, d).unbind(2)
        grads = torch.full_like(qkv, float("nan")).view(b, s, 3, h, d) \
            .unbind(2)
        x_ref = qkv.clone().requires_grad_(True)
        ref_in, leaves = x_ref.view(b, s, 3, h, d).unbind(2), (x_ref,)
    else:
        q, k, v = (torch.randn(b, s, n, d, generator=gen,
                               device=DEV).bfloat16() for n in (h, hk, hk))
        grads = tuple(torch.full_like(t, float("nan")) for t in (q, k, v))
        ref_in = leaves = tuple(t.clone().requires_grad_(True)
                                for t in (q, k, v))
    o = torch.empty(b, s, h, d, dtype=torch.bfloat16, device=DEV)
    # garbage in do's pad rows: the kernels must not read it into anything
    do = torch.randn(b, s, h, d, generator=gen, device=DEV).bfloat16()
    delta = torch.full((b, h, s), float("nan"), device=DEV)
    dq, dk, dv = grads
    lse = al.flash_fwd_lse(q, k, v, lens_t, causal, scale, o)
    run_dq = lambda legacy=False, out=dq, dl=delta: al._bwd(  # noqa: E731
        "dq", q, k, v, o, do, lse, dl, lens_t, causal, scale, out, k, v,
        legacy=legacy)
    run_dkv = lambda legacy=False, ok=dk, ov=dv, dl=delta: al._bwd(  # noqa
        "dkv", q, k, v, o, do, lse, dl, lens_t, causal, scale, q, ok, ov,
        legacy=legacy)
    run_dq()
    run_dkv()
    torch.cuda.synchronize()
    o_ref = al.lengths_attention_reference(*ref_in, lens_t, causal, scale)
    g_ref = torch.autograd.grad(o_ref, leaves, do)
    if form == "flat":
        g_ref = g_ref[0].view(b, s, 3, h, d).unbind(2)
    valid = torch.arange(s, device=DEV)[None] < lens_t[:, None]
    errs = {}
    for name, got, want in zip(("dq", "dk", "dv"), grads, g_ref):
        a, r = got[valid].float(), want[valid].float()
        nr = torch.linalg.norm(r).item()
        errs[name] = (torch.linalg.norm(a - r).item() / nr if nr
                      else torch.linalg.norm(a).item()) if valid.any() \
            else 0.0
    pad_zero = all(bool((t[~valid] == 0).all()) for t in grads)
    vm = valid[:, None, :].expand(b, h, s)
    delta_ok = bool((delta[~vm] == 0).all()) and \
        bool(torch.isfinite(delta).all())
    finite = all(bool(torch.isfinite(t.float()).all()) for t in grads)
    ok = max(errs.values()) <= RTOL_GRAD and pad_zero and delta_ok and finite
    heads = f"{h}/{hk}" if hk != h else f"{h}"
    line = (f"[K2] {label} {form} B={b} S={s} H={heads} d={d} causal "
            f"{causal}: rel_err {{{', '.join(f'{k} {v:.4g}' for k, v in errs.items())}}}"
            f", pad rows exact {pad_zero}, delta pad 0 {delta_ok}, finite "
            f"{finite}")
    if do_time:
        dq2, delta2 = torch.empty_like(dq), torch.empty_like(delta)
        dk2, dv2 = torch.empty_like(dk), torch.empty_like(dv)
        res = {}
        for kind, new, old in (
                ("dq", run_dq, lambda: run_dq(True, dq2, delta2)),
                ("dkv", run_dkv, lambda: run_dkv(True, dk2, dv2, delta2))):
            turns = {"new": [], "pr5": []}
            for which in ("new", "pr5", "pr5", "new"):
                turns[which].append(burst_ms(new if which == "new" else old))
            res[kind] = (statistics.mean(turns["new"]),
                         statistics.mean(turns["pr5"]), turns)
        mask = torch.arange(s, device=DEV)
        allow = mask[None, None, None, :] < lens_t.clamp(min=1)[:, None,
                                                                  None, None]
        if causal:
            allow = allow & (mask[:, None] >= mask[None, :])[None, None]
        sq_, sk_, sv_ = (t.detach().transpose(1, 2).requires_grad_(True)
                         for t in (q, k, v))
        o_s = F.scaled_dot_product_attention(sq_, sk_, sv_, attn_mask=allow,
                                             scale=scale,
                                             enable_gqa=hk != h)
        do_t = do.transpose(1, 2)
        sdpa = burst_ms(lambda: torch.autograd.grad(
            o_s, (sq_, sk_, sv_), do_t, retain_graph=True))
        pairs = sum(n * (n + 1) // 2 if causal else n * n for n in lens)
        for kind, mm in (("dq", 3), ("dkv", 4)):
            new, old, turns = res[kind]
            bound = mm * 2 * pairs * h * d / 989e12 * 1e3
            line += (f" | {kind} new {new:.4f} ms, legacy {old:.4f} ms "
                     f"(turns {turns}), ops bound {bound:.4f}")
        line += (f" | dq + dk/dv {res['dq'][0] + res['dkv'][0]:.4f} ms, SDPA "
                 f"backward {sdpa:.4f}")
    print(line)
    return ok


def check_k2(do_time):
    gen = torch.Generator(device=DEV).manual_seed(4)
    edge = [0, 1, 63, 64, 65, 127, 128, 129]
    cases = [
        ("edges", "flat", edge + [1152], 1152, 16, 16, 72, False),
        ("edges, causal", "flat", edge + [300], 300, 4, 4, 72, True),
        ("edges", "stacked", edge + [704], 704, 36, 36, 64, True),
        ("edges, non-causal", "stacked", edge + [700], 704, 8, 8, 64, False),
        ("GQA 16/2 edges", "stacked", [1, 63, 64, 65, 256], 256, 16, 2, 128,
         True),
        ("GQA 28/4 edges", "stacked", [0, 1, 63, 64, 65, 129, 256], 256, 28,
         4, 128, True),
        ("GQA 16/2, non-causal", "stacked", [5, 200], 256, 16, 2, 128,
         False),
    ]
    ok = True
    for label, form, lens, s, h, hk, d, causal in cases:
        ok &= k2_case(label, form, lens, s, h, hk, d, causal, False, gen)
        torch.cuda.empty_cache()
    if do_time:
        for label, form, lens, s, h, hk, d, causal in (
                ("ViT 40 x 1152", "flat", [1152] * 30 + [0] * 10, 1152, 16,
                 16, 72, False),
                ("LM causal 16 x 704", "stacked", [704] * 12 + [300] * 4,
                 704, 36, 36, 64, True),
                ("padded update 16/2", "stacked", [812, 4815, 2400, 3000],
                 4864, 16, 2, 128, True)):
            ok &= k2_case(label, form, lens, s, h, hk, d, causal, True, gen)
            torch.cuda.empty_cache()
    return ok


def check_rms(do_time):
    gen = torch.Generator(device=DEV).manual_seed(2)
    ok = True
    for rows, d, xdt, wdt in ((16384, 2048, torch.bfloat16, torch.bfloat16),
                              (11264, 2304, torch.bfloat16, torch.bfloat16),
                              (6000, 1280, torch.bfloat16, torch.bfloat16),
                              (4, 3584, torch.bfloat16, torch.bfloat16),
                              (1, 2048, torch.bfloat16, torch.bfloat16),
                              (1000, 64, torch.bfloat16, torch.bfloat16),
                              (777, 4096, torch.bfloat16, torch.bfloat16),
                              (513, 4096, torch.float32, torch.float32),
                              (129, 2048, torch.bfloat16, torch.float32),
                              (129, 2304, torch.float32, torch.bfloat16)):
        x = (torch.randn(rows, d, generator=gen, device=DEV) * 2 + 0.5) \
            .to(xdt)
        w = (1 + 0.3 * torch.randn(d, generator=gen, device=DEV)).to(wdt)
        route = norms.rms_route(xdt, d, rows)
        y = norms._launch(x, w, None, 1e-6)
        ref = norms.rmsnorm_reference(x, w, 1e-6)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs()
        # one bf16 ulp of the larger output plus 2^-16 of the scale; fp32
        # within 1e-5 of |y| + scale
        xf = x.float()
        scale = xf.abs() * torch.rsqrt(xf.square().mean(-1, keepdim=True)
                                       + 1e-6) * w.float().abs()
        big = torch.maximum(y.float().abs(), ref.float().abs())
        if xdt == torch.bfloat16:
            ulp = torch.exp2(torch.floor(torch.log2(big.clamp(min=2.0 ** -126)))
                             - 7)
            bound = ulp + 2.0 ** -16 * scale
        else:
            bound = 1e-5 * (ref.abs() + scale)
        good = bool((err <= bound).all())
        ok &= good
        line = (f"[K7] RMSNorm {rows} x {d} {xdt} w {wdt}: route {route}, "
                f"max_abs_err {err.max().item():.4g}, within bound {good}")
        if do_time:
            turns = {"warp": [], "pr6": []}
            for which in ("warp", "pr6", "pr6", "warp"):
                turns[which].append(burst_ms(
                    lambda: norms._launch(x, w, None, 1e-6,
                                          legacy=which == "pr6")))
            lib = burst_ms(lambda: F.rms_norm(x, (d,), w.to(xdt), 1e-6))
            bound_ms = (2 * rows * d * x.element_size()
                        + d * w.element_size()) / 3.35e12 * 1e3
            line += (f" | warp {statistics.mean(turns['warp']):.4f} ms, block "
                     f"{statistics.mean(turns['pr6']):.4f} ms (turns "
                     f"{turns}), F.rms_norm {lib:.4f}, byte bound "
                     f"{bound_ms:.4f}")
        print(line)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--only", choices=("k1", "k2", "k7"),
                    help="check (and time) one of the kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    ok = report_build()
    if args.only in (None, "k1"):
        ok &= check_probe()
        ok &= check_k1(args.time)
    if args.only in (None, "k2"):
        ok &= check_bwd_probe()
        ok &= check_k2(args.time)
    if args.only in (None, "k7"):
        ok &= check_rms(args.time)
    print(f"[done] all checks passed: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

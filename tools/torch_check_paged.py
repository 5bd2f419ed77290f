"""Build K5 (paged decode attention, csrc/paged_decode_hopper.cu), print the
compiler's report, and hold it against its plain PyTorch version on the
card at every form the port's paths give it.

    python3 tools/torch_check_paged.py [--time] [--only bf16|int8]

A short first check for the kernel: registers, spills and stack frames
from ptxas (and those of the first kernel, csrc/paged_decode.cu, and of
csrc/norms.cu), then K5 on bf16 and int8 pools at the 7B decode shape
(28/4, d 128, 4 slots) at block sizes 128 and 8, MiniCPM-2B's (36/36,
d 64, lengths up to 4,096), the 3B rollout's (16/2, d 128, bs 8, 8 slots
up to 16,536 tokens), and edge lengths 1, bs and bs + 1 at each: bf16
within 2e-2 max abs and relative Frobenius error, int8 within 3.5e-3
relative, finite. With --time it also times each with CUDA events (the
median interval of a burst of 10 queued while the device spins), at the
7B decode shape in turns with the first kernel (new, old, old, new), and
prints the bound and the split plan. Needs one CUDA card; exits 1 on any
disagreement.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from visrag_tpu_torch.ops import _build
from visrag_tpu_torch.serving import paged_kv as pk

SOURCES = ("paged_decode_hopper", "paged_decode", "norms")
DEV = "cuda"
DECODE_7B = [4815, 4643, 4879, 650]
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


def burst_ms(fn, reps=10):
    """Median interval of reps calls queued behind a device spin."""
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


def cold_ms(fn, reps=10):
    """Median device time of one call with the L2 cache flushed before it
    (a 100 MB buffer zeroed between calls, all queued behind a spin), as a
    decode step finds each layer's K and V."""
    flush = torch.empty(25 * 2 ** 20, device=DEV)
    fn()
    torch.cuda.synchronize()
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
          for _ in range(reps)]
    torch.cuda._sleep(4_000_000)
    for a, b in ev:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def make_case(lens, h, kvh, d, bs, quantized, seed):
    """Random pools holding the slots' blocks at random rows, the engine's
    table (a power-of-two width with room for a 16-step chunk, the null
    block, the pool's last row, past each length). → (q, pools, table,
    lengths)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    nb = sum(-(-n // bs) for n in lens) + 2
    pools = []
    for _ in range(2):
        x = torch.randn(nb, kvh, bs, d, generator=g, device=DEV)
        if quantized:
            pool = pk.KVQuant(torch.empty(x.shape, dtype=torch.int8,
                                          device=DEV),
                              torch.empty(x.shape[:-1], device=DEV))
            pk.pool_write_rows(pool, torch.arange(nb, device=DEV), x)
        else:
            pool = x.bfloat16()
        pools.append(pool)
        del x
    mb = 1
    while mb * bs < max(lens) + 17:
        mb *= 2
    table = torch.full((len(lens), mb), nb - 1, dtype=torch.int32,
                       device=DEV)
    perm = torch.randperm(nb - 1, generator=g, device=DEV)
    at = 0
    for i, n in enumerate(lens):
        used = -(-n // bs)
        table[i, :used] = perm[at:at + used].int()
        at += used
    q = torch.randn(len(lens), h, d, generator=g, device=DEV).bfloat16()
    return q, pools, table, torch.tensor(lens, dtype=torch.int32, device=DEV)


def bound_ms(lens, h, kvh, d, quantized, table):
    tokens = sum(lens)
    row = d + 4 if quantized else 2 * d
    nbytes = tokens * kvh * row * 2 + 2 * len(lens) * h * d * 2 \
        + table.numel() * 4
    return max(4 * tokens * h * d / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3


def check(name, lens, h, kvh, d, bs, quantized, do_time, legacy=False):
    q, pools, table, lens_t = make_case(lens, h, kvh, d, bs, quantized,
                                        len(name) + 7 * bs + quantized)
    run = lambda: pk.paged_decode_attention(q, *pools, table, lens_t)  # noqa
    out = run()
    ref = pk.paged_decode_reference(q, *pools, table, lens_t, d ** -0.5)
    torch.cuda.synchronize()
    a, b = out.float(), ref.float()
    rel = (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()
    max_abs = (a - b).abs().max().item()
    finite = bool(torch.isfinite(a).all())
    ok = finite and (rel <= 3.5e-3 if quantized
                     else rel <= 2e-2 and max_abs <= 2e-2)
    splits = pk.split_plan(len(lens), kvh, table.shape[1], bs,
                           pk._occupancy(q.device.index, d, quantized))
    bounds = pk.split_bounds(lens, table.shape[1], bs, splits)
    busy = int(((bounds[..., 1] > bounds[..., 0]).sum() * kvh).item())
    line = (f"K5 {'int8' if quantized else 'bf16'} {name}: {h}/{kvh} d {d} "
            f"bs {bs} table {tuple(table.shape)} lens {lens[:8]}"
            f"{'...' if len(lens) > 8 else ''}: rel {rel:.4g} max_abs "
            f"{max_abs:.4g} finite {finite} {'ok' if ok else 'FAIL'} | "
            f"splits (the cluster size) {splits}, blocks with work "
            f"{busy} of {splits * kvh * len(lens)}")
    if do_time:
        bnd = bound_ms(lens, h, kvh, d, quantized, table)
        if legacy:
            old = lambda: pk.paged_decode_attention(  # noqa: E731
                q, *pools, table, lens_t, legacy=True)
            turns = [burst_ms(f) for f in (run, old, old, run)]
            line += (f" | new {turns[0]:.4f}/{turns[3]:.4f} ms, legacy "
                     f"{turns[1]:.4f}/{turns[2]:.4f} ms")
        else:
            line += f" | kernel {burst_ms(run):.4f} ms"
        line += f", bound {bnd:.4f} ms"
    print(line, flush=True)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--only", choices=("bf16", "int8"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    t0 = time.time()
    _build.build_all(SOURCES)
    print(f"built in {time.time() - t0:.1f}s", flush=True)
    for name in SOURCES:
        regs, spilled, stacked = _build.ptxas_report(name)
        print(f"{name}: registers {regs}, spills {spilled or 'none'}, "
              f"stack frames {stacked or 'none'}", flush=True)
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip(), flush=True)
    ok, t = True, args.time
    g = torch.Generator().manual_seed(0)
    rollout = [16536, 15064] + [int(x) for x in
                                torch.randint(1, 16537, (6,), generator=g)]
    minicpm = [4096, 1] + [int(x) for x in
                           torch.randint(1, 4097, (2,), generator=g)]
    for quantized in (False, True):
        if args.only not in (None, "int8" if quantized else "bf16"):
            continue
        ok &= check("7B decode", DECODE_7B, 28, 4, 128, 128, quantized, t,
                    legacy=True)
        ok &= check("7B decode bs 8", DECODE_7B, 28, 4, 128, 8, quantized, t)
        ok &= check("MiniCPM-2B", minicpm, 36, 36, 64, 128, quantized, t)
        ok &= check("MiniCPM-2B bs 8", minicpm, 36, 36, 64, 8, quantized, t)
        ok &= check("3B rollout bs 8", rollout, 16, 2, 128, 8, quantized, t)
        for bs in (1, 8, 16, 128):
            ok &= check("7B edges", [1, bs, bs + 1, 650], 28, 4, 128, bs,
                        quantized, False)
        ok &= check("3B edges bs 8", [1, 8, 9, 16536], 16, 2, 128, 8,
                    quantized, False)
        ok &= check("MiniCPM edges bs 8", [1, 8, 9, 300], 36, 36, 64, 8,
                    quantized, False)
        ok &= check("rep 3 d 64 bs 2", [1, 2, 3, 999], 6, 2, 64, 2,
                    quantized, False)
    print("ALL OK" if ok else "SOME FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

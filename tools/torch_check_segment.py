"""Build the segment-attention kernels (K4, both the wgmma and the mma.sync
sources) and K3 (both sources), print the compiler's report, and hold each
kernel against its plain PyTorch version on the card.

    python3 tools/torch_check_segment.py [--time]

A short first check for an edited kernel: registers and spills from ptxas,
the pre-pass's tile classes against `segment_tile_classes_reference`, then
forward, LSE, dq, dk, dv at a few shapes (packed first-fit ids, grouped kv
heads, Sq != Sk, pad and negative ids, segments of 127/128/129 tokens, a
segment filling whole 128-row tiles, d = 64 / 80 / 128), the mma.sync
forward, dq and dk/dv at d 64 / 128 as well, and the delta hand-off: the
Hopper dq's delta against the mma.sync dq's, and the dk/dv that follows
each. K3 (the Hopper kernel and, to compare, the first one) on the vision
block's fused-qkv views at window, image-sized and edge ids, its backward
(K4 at d 80 on sorted ids) at window and image ids.
With --time it also times the kernels with CUDA events (median of 10), the
wgmma and the mma.sync forward, dq and dk/dv in turns, and K3 in turns
with the first kernel. Needs one CUDA card; exits 1 on any disagreement.
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
from visrag_tpu_torch.ops import attention as seg
from visrag_tpu_torch.ops import attention_kvgrid as kg

TOL = dict(o=2e-2, lse=2e-2, dq=4e-2, dk=4e-2, dv=4e-2)


def first_fit_ids(rng, rows, width, lens):
    """Segment ids of first-fit-decreasing packing: runs in a row are
    contiguous but their ids are not ascending; 0 pads the tail."""
    order = np.argsort(-np.asarray(lens), kind="stable")
    used = [0] * rows
    ids = np.zeros((rows, width), np.int32)
    for i in order:
        for r in range(rows):
            if used[r] + lens[i] <= width:
                ids[r, used[r]:used[r] + lens[i]] = int(i) + 1
                used[r] += lens[i]
                break
    return ids


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


def check(name, q_seg, kv_seg, h, hk, d, causal, do_time, banded=False,
          legacy=False):
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(len(name))
    b, sq = q_seg.shape
    sk = kv_seg.shape[1]
    q, k, v, do = (torch.randn(shape, generator=g, device=dev,
                               dtype=torch.bfloat16)
                   for shape in ((b, sq, h, d), (b, sk, hk, d),
                                 (b, sk, hk, d), (b, sq, h, d)))
    qs = torch.from_numpy(q_seg).to(dev)
    ks = torch.from_numpy(kv_seg).to(dev)
    scale = d ** -0.5
    q.requires_grad_(True), k.requires_grad_(True), v.requires_grad_(True)
    if banded:
        o = kg.flash_attention_kvgrid(q, k, v, qs)
    else:
        o = seg.flash_attention(q, k, v, qs, ks, causal=causal)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    with torch.no_grad():
        want_o = seg.segment_attention_reference(
            q.float(), k.float(), v.float(), qs, ks, causal=causal,
            sm_scale=scale)
        want = seg.segment_backward_reference(q, k, v, do, qs, ks, causal,
                                              scale)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        seg.segment_fwd(q, k, v, qs, ks, causal, scale, torch.empty_like(o),
                        lse)
        want_lse = seg.segment_lse_reference(q, k, qs, ks, causal, scale)
    if legacy:
        o = torch.empty_like(o)
        dk, dv = torch.empty_like(dk), torch.empty_like(dv)
        delta = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        with torch.no_grad():
            seg._launch_segment("fwd", q, k, v, qs, ks, causal, scale, o=o,
                                lse=lse, legacy=True)
            dq = torch.empty_like(dq)
            seg._launch_segment("dq", q, k, v, qs, ks, causal, scale, o=o,
                                do=do, dq=dq, lse=lse, delta=delta,
                                legacy=True)
            seg._launch_segment("dkv", q, k, v, qs, ks, causal, scale, do=do,
                                dk=dk, dv=dv, lse=lse, delta=delta,
                                legacy=True)
        torch.cuda.synchronize()
    err = dict(o=(o.float() - want_o).abs().max().item(),
               lse=(lse - want_lse).abs().max().item(),
               dq=(dq.float() - want[0]).abs().max().item(),
               dk=(dk.float() - want[1]).abs().max().item(),
               dv=(dv.float() - want[2]).abs().max().item())
    qpad, kpad = qs <= 0, ks <= 0
    zeros = bool((o[qpad] == 0).all() and (dq[qpad] == 0).all()
                 and (dk[kpad] == 0).all() and (dv[kpad] == 0).all()
                 and (lse.transpose(1, 2)[qpad] == seg.LSE_PAD).all())
    scale_ref = {kk: max(1.0, float(x.abs().max())) for kk, x in
                 zip(("dq", "dk", "dv"), want)}
    ok = zeros and all(
        err[kk] <= TOL[kk] * scale_ref.get(kk, 1.0) for kk in err)
    line = f"{name}: " + " ".join(f"{kk}={x:.3g}" for kk, x in err.items()) \
        + f" pad_zeros={zeros}"
    if d in seg.HOPPER_HEAD_DIMS and not banded and not legacy:
        hand = handoff(q, k, v, o.detach(), do, lse, qs, ks, causal, scale)
        ok &= hand["ok"]
        line += (f" handoff: delta max_abs {hand['delta']:.3g}, dk/dv rel "
                 f"{hand['dkv']:.3g}")
    line += f" {'ok' if ok else 'FAIL'}"
    if do_time and not banded:
        with torch.no_grad():
            o2 = torch.empty_like(o)
            delta = torch.empty_like(lse)
            dq2, dk2, dv2 = (torch.empty_like(x) for x in (q, k, v))
            times = {}
            for tag, old in (("", False), ("old ", True), ("old ", True),
                             ("", False)):
                t_f = median_ms(lambda: seg._launch_segment(
                    "fwd", q, k, v, qs, ks, causal, scale, o=o2, lse=lse,
                    legacy=old))
                t_kv = median_ms(lambda: seg._launch_segment(
                    "dkv", q, k, v, qs, ks, causal, scale, do=do, dk=dk2,
                    dv=dv2, lse=lse, delta=delta, legacy=old))
                t_q = median_ms(lambda: seg._launch_segment(
                    "dq", q, k, v, qs, ks, causal, scale, o=o, do=do, dq=dq2,
                    lse=lse, delta=delta, legacy=old))
                times.setdefault(tag + "fwd", []).append(t_f)
                times.setdefault(tag + "dq", []).append(t_q)
                times.setdefault(tag + "dkv", []).append(t_kv)
        line += " " + " ".join(f"{kk}={sum(x) / len(x):.4f}ms" for kk, x in
                               times.items())
    print(line, flush=True)
    return ok


def handoff(q, k, v, o, do, lse, qs, ks, causal, scale):
    """The Hopper dq's delta against the mma.sync dq's (fp32, summation order
    apart), and the Hopper dk/dv after each: within 1e-3 relative (a delta
    that differs in its last bits moves a bf16 dk/dv element by one
    rounding at most)."""
    out = {}
    for legacy in (False, True):
        delta = torch.empty_like(lse)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        with torch.no_grad():
            seg._launch_segment("dq", q, k, v, qs, ks, causal, scale, o=o,
                                do=do, dq=torch.empty_like(q), lse=lse,
                                delta=delta, legacy=legacy)
            seg._launch_segment("dkv", q, k, v, qs, ks, causal, scale, do=do,
                                dk=dk, dv=dv, lse=lse, delta=delta)
        out[legacy] = (delta, dk, dv)
    torch.cuda.synchronize()
    (d1, k1, v1), (d0, k0, v0) = out[False], out[True]
    d_err = (d1 - d0).abs().max().item()
    kv_err = max(rel(k1, k0), rel(v1, v0))
    ok = d_err <= 1e-4 * max(1.0, d0.abs().max().item()) and kv_err <= 1e-3
    return {"delta": d_err, "dkv": kv_err, "ok": ok}


def rel(a, b):
    a, b = a.float(), b.float()
    nb = torch.linalg.norm(b).item()
    return torch.linalg.norm(a - b).item() / nb if nb else \
        torch.linalg.norm(a).item()


def check_k3(name, ids_np, do_time, h=16, d=80):
    """K3 on views of one fused (1, S, 3, H, D) qkv tensor, as the vision
    block passes them: the Hopper kernel and the first one against the
    plain version (2e-2 max abs on real rows), pad rows exactly 0; with
    --time both kernels in turns."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(len(name))
    s = ids_np.shape[1]
    qkv = torch.randn(1, s, 3, h, d, generator=g, device=dev).bfloat16()
    q, k, v = qkv.unbind(2)
    ids = torch.from_numpy(ids_np).to(dev)
    want = kg.flash_attention_kvgrid_reference(q, k, v, ids)
    real = ids[0] > 0
    line, ok = f"K3 {name} (S {s}):", True
    for tag, legacy in (("hopper", False), ("first", True)):
        out = kg._launch(q, k, v, ids, d ** -0.5, legacy=legacy)
        torch.cuda.synchronize()
        err = (out[0][real].float() - want[0][real].float()).abs().max()
        zeros = bool((out[0][~real] == 0).all())
        ok &= err.item() <= 2e-2 and zeros
        line += f" {tag} max_abs {err.item():.3g} pad_zeros {zeros};"
    if do_time:
        times = {"hopper": [], "first": []}
        for tag in ("hopper", "first", "first", "hopper"):
            times[tag].append(median_ms(lambda: kg._launch(
                q, k, v, ids, d ** -0.5, legacy=tag == "first")))
        line += " " + " ".join(f"{t} {sum(x) / 2:.4f}ms"
                               for t, x in times.items())
    print(line + (" ok" if ok else " FAIL"), flush=True)
    return ok


def vision_ids(longest, total, pad, seed=0):
    """Sorted ids over runs of 1..longest tokens (window layers: 64; full
    layers: an image's patches), then `pad` zeros; (1, total + pad)."""
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < total:
        sizes.append(int(rng.integers(max(1, longest // 2), longest + 1)))
    ids = np.repeat(np.arange(1, len(sizes) + 1), sizes)[:total]
    return np.concatenate([ids, np.zeros(pad)])[None].astype(np.int32)


def check_classes(rng):
    """The pre-pass on the card against segment_tile_classes_reference."""
    ok = True
    for width, tile in ((300, 64), (700, 128), (4864, 128), (1000, 64)):
        ids = first_fit_ids(rng, 3, width, list(rng.integers(1, 400, 12)))
        ids[0, :5] = -1
        got = seg.segment_tile_classes(torch.from_numpy(ids).cuda(), tile)
        want = seg.segment_tile_classes_reference(torch.from_numpy(ids), tile)
        ok &= bool(torch.equal(got.cpu(), want))
    print(f"pre-pass tile classes equal the plain version: {ok}", flush=True)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    t0 = time.time()
    names = ("attention_segment", "attention_segment_hopper",
             "attention_kvgrid", "attention_kvgrid_hopper")
    _build.build_all(names)
    print(f"built in {time.time() - t0:.1f}s", flush=True)
    for name in names:
        regs, spilled, stacked = _build.ptxas_report(name)
        print(f"{name}: registers {regs}, spills {spilled or 'none'}, "
              f"stack frames {stacked or 'none'}", flush=True)
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip(), flush=True)
    rng = np.random.default_rng(0)
    ok = True
    edge = np.zeros((2, 300), np.int32)
    edge[0, :1] = 5
    edge[0, 1:64] = 3
    edge[0, 64:128] = 9
    edge[0, 128:193] = 2
    edge[0, 200:260] = -4           # negative ids match nothing
    kv_edge = edge.copy()
    ok &= check_classes(rng)
    ok &= check("edges d128 causal", edge, kv_edge, 4, 2, 128, True,
                args.time)
    ok &= check("edges d128 causal, mma.sync", edge, kv_edge, 4, 2, 128, True,
                False, legacy=True)
    ok &= check("edges d64, mma.sync", edge, kv_edge, 2, 2, 64, False, False,
                legacy=True)
    tiles = np.zeros((2, 700), np.int32)
    tiles[0, :127], tiles[0, 127:255], tiles[0, 255:384] = 4, 6, 8
    tiles[1, :640] = 3                    # whole 128-row tiles: unmasked
    for hk, d, causal in ((2, 128, True), (4, 64, False), (1, 128, False),
                          (4, 64, True)):
        ok &= check(f"127/128/129 and whole tiles, d{d} causal {causal}",
                    tiles, tiles, 4, hk, d, causal, False)
    ok &= check("edges d64", edge, kv_edge, 2, 2, 64, False, args.time)
    ids = first_fit_ids(rng, 3, 1280, [900, 700, 500, 300, 260, 200, 64, 1])
    ok &= check("first-fit 16/2 d128", ids, ids, 16, 2, 128, True, args.time)
    ok &= check("7B grouping 28/4", ids[:1, :512], ids[:1, :512], 28, 4, 128,
                True, args.time)
    qid = np.concatenate([np.full(100, 1), np.full(91, 2)])[None].astype(
        np.int32)
    kid = np.concatenate([np.full(150, 2), np.full(107, 1),
                          np.zeros(20)])[None].astype(np.int32)
    ok &= check("Sq != Sk", qid, kid, 4, 4, 128, False, args.time)
    ok &= check("Sq != Sk causal", qid, kid, 4, 1, 128, True, args.time)
    win = np.repeat(np.arange(1, 41), 64)[:2500]
    win = np.concatenate([win, np.zeros(60)])[None].astype(np.int32)
    ok &= check("vision d80 K4", win, win, 16, 16, 80, False, args.time)
    ok &= check("vision d80 K4 causal", win, win, 16, 16, 80, True, False)
    ok &= check("vision d80 K4, mma.sync", win, win, 16, 16, 80, False,
                False, legacy=True)
    ok &= check("vision d80 K3 + K4 backward", win, win, 16, 16, 80, False,
                args.time, banded=True)
    img = vision_ids(1500, 3900, 37)
    ok &= check("image ids d80 K3 + K4 backward", img, img, 16, 16, 80,
                False, args.time, banded=True)
    edge3 = np.asarray([[1] + [2] * 63 + [3] * 65 + [4] + [5] * 130
                        + [6] * 700 + [7] * 127 + [8] * 129 + [0] * 165],
                       np.int32)
    for name, ids3 in (("window", vision_ids(64, 17631, 37)),
                       ("image", vision_ids(5000, 17631, 37, seed=1)),
                       ("edges", edge3), ("one segment",
                                          np.ones((1, 1000), np.int32))):
        ok &= check_k3(name, ids3, args.time)
    if args.time:
        ids = first_fit_ids(rng, 3, 4864, [4800, 4790, 4780, 60, 50, 40])
        ok &= check("packed update 3x4864", ids, ids, 16, 2, 128, True, True)
        one = np.ones((1, 16640), np.int32)
        ok &= check("1x16640", one, one, 16, 2, 128, True, True)
    print("ALL OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

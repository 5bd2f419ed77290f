"""Hold K4's Hopper forward, dq and dk/dv kernels of this tree bit for bit
against another tree's (an A/B of a refactor that must not change them).

    python3 tools/torch_ab_segment.py --other DIR [--time] [--digests]

DIR is a checkout of the other tree (for example `git archive` of the
parent commit unpacked into `chip_checkout/parent`, which .gitignore
lists). Its `visrag_tpu_torch/csrc/attention_segment_hopper.cu` is built
with this tree's nvcc flags into DIR's `visrag_tpu_torch/build/`, and both
libraries run on the same inputs through this tree's wrapper
(`ops/attention._launch_segment`): the packed update of chip_smoke.py's
phase 8 (its RL prompts, packed by the trainer's own functions: 16/2 heads,
d 128, causal) and one 16,640-token row. The forward's output and LSE,
dq's output and delta (when the other tree has the Hopper dq) and dk/dv's
outputs must be equal bit for bit. With --time it also times both
trees' kernels in turns (this, other, other, this), each the median of a
burst of calls queued while the device spins (chip_smoke.cuda_ms). With
--digests it also builds the other tree's K1 and K2 Hopper sources and
prints `chip_smoke.kernel_digests()` (K1, K2 and K4 outputs at fixed
inputs) through both trees' libraries as JSON lines, the other tree's
first: chip_smoke.PARENT_DIGESTS holds those of the tree before K3's
redesign. Needs one CUDA card; exits 1 if an output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from visrag_tpu_torch.ops import _build  # noqa: E402
from visrag_tpu_torch.ops import attention as seg  # noqa: E402

NAME = "attention_segment_hopper"


def build_other(root, name=NAME):
    """The other tree's source `name` (K4's Hopper source by default), built
    with this tree's flags. → the loaded library."""
    src = os.path.join(root, "visrag_tpu_torch", "csrc", f"{name}.cu")
    out_dir = os.path.join(root, "visrag_tpu_torch", "build")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"lib{name}-other.so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(out)


def packed_update_ids():
    """The first packed micro-batch of chip_smoke.py's phase 9, as phase 8
    builds it. → (ids (B, S) int32, heads, kv heads, head dim)."""
    from visrag_tpu_torch.driver.common import encode_qwen_prompt_row
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    cfg = Qwen25VLConfig.b3()
    with tempfile.TemporaryDirectory(prefix="visrag_ab_") as work:
        rows_path = cs._rl_rows(work)
        tok = cs.RLStandInTokenizer()
        rollout = cs._rl_config(work, 1).rollout
        with open(rows_path) as f:
            prompts = [encode_qwen_prompt_row(json.loads(line), tok, tok, cfg,
                                              rollout) for line in f]
    seqlens = [len(p["input_ids"]) + cs.RL_RESPONSE_TOKENS
               for p in prompts for _ in range(4)]
    ids, _, _, _ = cs._packed_ids(seqlens, 16384)
    tc = cfg.text
    return ids, tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim


def ab_case(label, ids_np, h, hk, d, other, do_time, gen):
    """Forward and dk/dv with this tree's library and the other's on the
    same inputs. → True if every output is equal bit for bit."""
    dev = "cuda"
    b, s = ids_np.shape
    scale = d ** -0.5
    ids = torch.from_numpy(np.ascontiguousarray(ids_np)).to(dev)
    q = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, s, hk, d, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    do = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
    this = _build.load_library(NAME)
    load = _build.load_library

    def run(lib, kind, **out):
        _build.load_library = \
            lambda name: lib if name == NAME else load(name)
        try:
            seg._launch_segment(kind, q, k, v, ids, ids, True, scale, **out)
        finally:
            _build.load_library = load

    outs = {}
    for tag, lib in (("this", this), ("other", other)):
        o = torch.empty_like(q)
        lse = torch.empty(b, h, s, device=dev)
        run(lib, "fwd", o=o, lse=lse)
        outs[tag, "fwd"] = (o, lse)
    o, lse = outs["this", "fwd"]
    kinds = ["fwd", "dkv"]
    if hasattr(other, "visrag_segment_hopper_dq"):
        kinds.insert(1, "dq")
        for tag, lib in (("this", this), ("other", other)):
            dq = torch.empty_like(q)
            delta = torch.empty(b, h, s, device=dev)
            run(lib, "dq", o=o, do=do, dq=dq, lse=lse, delta=delta)
            outs[tag, "dq"] = (dq, delta)
    dq = torch.empty_like(q)
    delta = torch.empty(b, h, s, device=dev)
    seg._launch_segment("dq", q, k, v, ids, ids, True, scale, o=o, do=do,
                        dq=dq, lse=lse, delta=delta)
    for tag, lib in (("this", this), ("other", other)):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        run(lib, "dkv", do=do, dk=dk, dv=dv, lse=lse, delta=delta)
        outs[tag, "dkv"] = (dk, dv)
    torch.cuda.synchronize()
    same = {kind: all(torch.equal(a, c) for a, c in
                      zip(outs["this", kind], outs["other", kind]))
            for kind in kinds}
    line = (f"[ab] {label} B={b} S={s} H={h}/{hk} d={d} causal: bitwise "
            f"equal forward (o, lse) {same['fwd']}, dq (dq, delta) "
            f"{same.get('dq', 'not in the other tree')}, dk/dv "
            f"{same['dkv']}")
    if do_time:
        dk, dv = outs["this", "dkv"]
        args = {"fwd": dict(o=o, lse=lse),
                "dq": dict(o=o, do=do, dq=dq, lse=lse, delta=delta),
                "dkv": dict(do=do, dk=dk, dv=dv, lse=lse, delta=delta)}
        for kind in kinds:
            kw = args[kind]
            turns = {"this": [], "other": []}
            for tag in ("this", "other", "other", "this"):
                lib = this if tag == "this" else other
                turns[tag].append(cs.cuda_ms(lambda: run(lib, kind, **kw)))
            line += (f" | {kind} this {statistics.mean(turns['this']):.4f} "
                     f"ms, other {statistics.mean(turns['other']):.4f} "
                     f"(turns {turns})")
    print(line, flush=True)
    return all(same.values())


DIGEST_SOURCES = ("attention_lengths_hopper", "attention_lengths_bwd_hopper",
                  NAME)


def digests(root, other_k4):
    """chip_smoke.kernel_digests() through the other tree's libraries (its
    K4 library already built: other_k4), then through this tree's. →
    (other's, this tree's)."""
    from visrag_tpu_torch.ops import attention_lengths as al
    libs = {name: build_other(root, name) for name in DIGEST_SOURCES
            if name != NAME}
    libs[NAME] = other_k4
    load = _build.load_library
    _build.load_library = lambda name: libs.get(name) or load(name)
    al._entry.cache_clear()
    al._bwd_entry.cache_clear()
    try:
        other = cs.kernel_digests()
    finally:
        _build.load_library = load
        al._entry.cache_clear()
        al._bwd_entry.cache_clear()
    return other, cs.kernel_digests()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="root of the other tree's checkout")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--digests", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    other = build_other(os.path.abspath(args.other))
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids, h, hk, d = packed_update_ids()
    ok = ab_case("packed update", ids, h, hk, d, other, args.time, gen)
    ok &= ab_case("one 16640-token row", np.ones((1, 16640), np.int32), h,
                  hk, d, other, args.time, gen)
    if args.digests:
        theirs, ours = digests(os.path.abspath(args.other), other)
        print(json.dumps(theirs))
        print(json.dumps(ours))
        print(f"[ab] K1, K2 and K4 digests equal: {theirs == ours}")
        ok &= theirs == ours
    print(f"[{cs.smi()}] bit for bit: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

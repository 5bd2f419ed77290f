"""Time the full-width retriever training step of this tree and of another
tree in turns on one card: chip_smoke.py's phase 5 (train_retriever.main,
3 steps of 16 pairs, GradCache micro-batch 4) run in a fresh process from
each tree's root, in the order this, other, other, this.

    python3 tools/torch_ab_train.py --other DIR

DIR is a checkout of the other tree (for example `git archive` of the
parent commit unpacked into `chip_checkout/parent`, which .gitignore
lists). Each run builds its tree's kernels, sets up phase 3's model on seed
0 and runs phase 5; the tool prints each run's seconds per step (the
trainer's own steps_per_s, from phase 5's log line) and the mean of the
steady steps (2 and 3) per tree. Steps issued from the host spread between
calls, so only runs of one call are compared. Needs one CUDA card; exits 1
if a run fails.
"""

from __future__ import annotations

import argparse
import ast
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = ("import torch, chip_smoke as c; "
         "torch.backends.cuda.matmul.allow_tf32 = False; "
         "torch.backends.cudnn.allow_tf32 = False; "
         "c.phase0_environment(); c.phase1_build(); "
         "c.phase5_training(c.phase3_setup())")


def run_phase5(root):
    """Phase 5 in a fresh process from `root`. → seconds per step."""
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                          capture_output=True, text=True)
    line = next((x for x in proc.stdout.splitlines()
                 if x.startswith("[5] train_retriever.main")), None)
    if proc.returncode != 0 or line is None:
        raise RuntimeError(f"phase 5 failed in {root} (rc "
                           f"{proc.returncode}):\n{proc.stdout[-3000:]}"
                           f"{proc.stderr[-3000:]}")
    return ast.literal_eval(line.split("s/step ")[1].split(" (steady")[0])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="root of the other tree's checkout")
    args = ap.parse_args(argv)
    roots = {"this": ROOT, "other": os.path.abspath(args.other)}
    steps = {"this": [], "other": []}
    for tag in ("this", "other", "other", "this"):
        s = run_phase5(roots[tag])
        steps[tag].append(s)
        print(f"[ab train] {tag}: s/step {s}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    means = {tag: statistics.mean(x for s in runs for x in s[1:])
             for tag, runs in steps.items()}
    print(f"[ab train] steady s/step (steps 2-3 of each run): this "
          f"{means['this']:.3f}, other {means['other']:.3f} | {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

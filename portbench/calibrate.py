"""Readings that the limits of `correct` are set from, on the chip.

    python portbench/calibrate.py --workload <cell> --seeds <n> [<n> ...] \
        [--control-seeds <n> ...] [--seconds <s>] [--out <file.jsonl>]

For each seed: the cell's set-up, a short window of the timed path and
the check, as a run makes them (the program's readings, the lower ends of
the limits); then, on the control seeds, the control in the program's
place (the traffic kind's `Run.control`), judged by the same reference.
Each reading is judged against the cell's limits by the harness's own
comparison (`harness.judge`), and each line says whether it passed.

Each reading is one JSON line. Runs here judge as many outputs as a run
does; the set-up is the kind's `calibration_mix` (one distinct batch, or
a pool of one burst) to save time, at the cell's own sizes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness
    cell = harness.load_cell(args.workload)
    kind = harness.load_module(harness.HERE / "traffic"
                               / f"{cell.mix['kind']}.py")
    cell.mix = kind.calibration_mix(cell.mix)
    sink = open(args.out, "a") if args.out else None
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        run = kind.Run(cell, seed, torch.device("cuda"), False)
        run.warmup()
        result = run.window(args.seconds, harness.Tracer(False, "cuda"))
        run.release()
        program = run.check()
        line = {"cell": cell.name, "seed": seed, "failed": result["failed"],
                "program": dict(program),
                "program_within": harness.judge(program, cell.limits)[0]}
        if seed in args.control_seeds:
            control = run.control()
            line["control"] = dict(control)
            line["control_within"] = harness.judge(control, cell.limits)[0]
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the port's benchmark once.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of its standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), device, and with --trace 1 a breakdown;
the numbers compared against the plain reference come last on standard
error and under `compared`. Exits non-zero, printing no result, without
the CUDA devices the cell needs or where the process has loaded JAX.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "visrag_tpu_torch").is_dir():
        print("portbench: the program (visrag_tpu_torch) is not beside the "
              "benchmark", file=sys.stderr)
        return 2
    # the program builds its kernels into visrag_tpu_torch/build/ in the
    # checkout; transformers, where something imports it, loads no flax
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())

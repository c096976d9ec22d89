"""The readings that the limits of `correct` are set from: one cell run on
many seeds in one process, as configured or as its control, each run's
compared numbers printed as one JSON line. The benchmark's own runs never
run the control.

    python3 fhebench/readings.py --workload <cell> --seconds <s> --control <c> --seeds <n> ...

A control is the port one step below the configuration's precision, with
the same inputs, traffic and window: `limbs=N`, the big modulus Q cut to
its first N primes (N = L - 1 is the nearest step; 2 is the kernels'
fewest limbs), or `prune=N`, N of the l gadget digits pruned, the port's
own option; `none` runs the configuration as it is.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", default="none",
                    help="none, limbs=N or prune=N")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from fhebench.run import load_cell, run_cell

    import torch

    if not torch.cuda.is_available():
        print("fhebench: readings need a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    control = None
    if args.control != "none":
        key, _, value = args.control.partition("=")
        control = {key: int(value)}
    for seed in args.seeds:
        res = run_cell(cell, seed, args.seconds, False, start=time.perf_counter(),
                       control=control)
        print(json.dumps({"workload": cell.name, "seed": seed, "control": args.control,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(HERE.parent))
    sys.exit(main())

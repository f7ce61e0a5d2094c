"""The readings the checks' limits are set from: for each seed, a short
window of a cell at its own size, then its numbers twice, the program's
and the control's (the reference in float32 with TF32 products in the
program's place), in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        --seconds <s> [--control] [--fault <name>]

One JSON line a seed: the seed, the requests, the program's numbers,
with ``--control`` the control's, the window's end-to-end numbers and the
seconds the checks took.
``--fault <name>`` plants a fault of ``portbench/faults.py`` under the
timed path and reads the numbers it gives.  Not a run of the benchmark:
the benchmark's runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import nullcontext

from .faults import FAULTS
from .run import Spec, cache_dirs, driver_for


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true",
                    help="also read the control's numbers")
    ap.add_argument("--fault", default=None,
                    help="plant a fault of portbench/faults.py under the "
                         "timed path")
    args = ap.parse_args(argv)
    spec = Spec(args.workload)
    cache_dirs()
    from gaussian_processes_tpu_torch.utils.tracing import (
        read_launch_counts, reset_launch_counts)
    driver = driver_for(spec.config)
    seeds = [int(s) for s in args.seeds.split(",")]
    session = driver.setup(spec.config, spec.traffic, seeds[0], "cuda")
    for seed in seeds:
        session.seed = seed
        reset_launch_counts()
        with FAULTS[args.fault]() if args.fault else nullcontext():
            win = driver.window(session, args.seconds, False)
        shapes = read_launch_counts()["shapes"]
        t0 = time.perf_counter()
        program = driver.check(session, win)
        t1 = time.perf_counter()
        control = (driver.check(session, win, control=True)
                   if args.control else None)
        line = {"workload": args.workload, "seed": seed,
                "fault": args.fault,
                "attempted": win["attempted"], "failed": win["failed"],
                "e2e": win["e2e"], "program": program, "control": control,
                "check_s": [t1 - t0, time.perf_counter() - t1],
                "request_s": [k.get("seconds") for _, k in win.get("done", [])],
                "gram_k": _k_share(shapes)}
        print(json.dumps(line), flush=True)
    return 0


def _k_share(shapes: dict) -> dict:
    """Gram launches by contraction length."""
    by_k: dict = {}
    for (b, m, n, k), c in shapes.items():
        by_k[k] = by_k.get(k, 0) + c
    return {str(k): c for k, c in sorted(by_k.items())}


if __name__ == "__main__":
    sys.exit(main())

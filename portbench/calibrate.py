"""Readings that set a cell's limits: the program's, its control's and the
planted faults', seed by seed, in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        --variants program,control,half [--seconds 3] [--out file.jsonl]

For each seed the cell's set-up runs and then a window of `--seconds`
(a training cell's check follows the window's last unit, a serving cell's
compares the window's answers), then the check computes each variant's
numbers: "program", the program's; "control", the
reference in the cell's control numerics put in the program's place;
"half", the reference with half of each chunk's rows left out and the mean
taken over the rest. One JSON line a seed goes to standard output and to
`--out`.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import harness


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="program")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.set_env()
    import torch
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        sys.exit(2)
    device = torch.device("cuda", 0)
    variants = tuple(args.variants.split(","))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = harness.Cell(args.workload, seed, device)
        drv = harness.driver_for(cell)
        try:
            drv.setup()
        except RuntimeError as e:  # a singular solve in the first steps
            row = {"workload": args.workload, "seed": seed, "error": str(e)}
        else:
            stats = harness.window(drv, args.seconds)
            drv.release()
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            readings = drv.check(variants)
            row = {"workload": args.workload, "seed": seed, "readings": readings,
                   "units": stats["units"], "failed": stats["failed"], "run_s": t1 - t0,
                   "check_s": time.perf_counter() - t1}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del drv
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

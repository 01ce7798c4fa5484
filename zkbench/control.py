"""The controls and the planted faults of a cell, for setting its limits.

    python3 -m zkbench.control --workload <cell> --seeds 11,12,13 [--seconds 1] [--modes a,b]

Not part of a benchmark run.  For each seed it runs the cell's set-up and a
short window once for each mode, at the cell's own sizes, and prints each
run's checks as one JSON line.  The modes are the `CONTROLS` of the cell's
kind of job (`tasks/<task>.py`), all of them unless `--modes` names some;
each has to fail one of the task's limits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from . import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control and the planted fault of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--modes", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        run.log("[zkbench.control] needs a CUDA device")
        return 3
    bench = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    cell, config, traffic = run.resolve(bench, args.workload)
    task = run.task_of(config)
    modes = args.modes.split(",") if args.modes else list(task.CONTROLS)
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in modes:
            out = run.run_cell(cell, config, traffic, seed, args.seconds, False, "cuda",
                               control=task.CONTROLS[mode])
            ok, shown = run.verdict(out["checks"], task.LIMITS)
            print(json.dumps(dict(workload=args.workload, seed=seed, mode=mode, correct=ok,
                                  proofs=len(out["done"]), checks=shown)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

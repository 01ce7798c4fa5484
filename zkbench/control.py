"""The control and the planted fault of a cell, for setting its limits.

    python3 -m zkbench.control --workload <cell> --seeds 11,12,13 [--seconds 1]

Not part of a benchmark run.  For each seed it runs the cell's set-up and a
short window twice, at the cell's own sizes, and prints each run's checks
as one JSON line:

* `control`: the program's own zero-blinding path switched on (the
  service's `Mixer.zero()` in place of the job's mixer, the CLI's
  `--deterministic`), where the configuration states zero-knowledge
  blinding.  `unblinded` has to come out above its limit.
* `altered`: each proof's `V_eval` changed by one where the entry hands the
  proof over.  `relation_fail` has to come out above its limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from . import run
from .reference.curve import R


def alter_v_eval(proof: dict) -> dict:
    return dict(proof, V_eval=(proof["V_eval"] + 1) % R)


MODES = {
    "control": dict(zero_blinding=True),
    "altered": dict(alter=alter_v_eval),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control and the planted fault of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--modes", default="control,altered")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        run.log("[zkbench.control] needs a CUDA device")
        return 3
    bench = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    cell, config, traffic = run.resolve(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in args.modes.split(","):
            out = run.run_cell(cell, config, traffic, seed, args.seconds, False, "cuda",
                               control=MODES[mode])
            ok, shown = run.verdict(out["checks"])
            print(json.dumps(dict(workload=args.workload, seed=seed, mode=mode, correct=ok,
                                  proofs=len(out["done"]), checks=shown)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

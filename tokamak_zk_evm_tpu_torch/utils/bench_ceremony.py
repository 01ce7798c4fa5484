"""Time the MPC ceremony's steps at the synthetic full shape, alone.

    python -m tokamak_zk_evm_tpu_torch.utils.bench_ceremony

Builds every kernel, then runs `utils/ceremony_drive.py` once: the
ceremony in process with seeded rngs (`drive_ceremony`: phase-1 compute and
verify, phase-2 prepare, contribute and verify, the check against
`generate_sigma`, two tampered Sigmas) and through the CLI's files
(`drive_ceremony_files`: the `mpc` steps, then preprocess, prove and
verify).  Prints one JSON line of seconds by step (host clock, each step
ending in a synchronize), then the card's name and power limit.  The package
timed is the one imported.  To compare two trees on one card, run it from
each checkout in turns (a tree without `ceremony_drive.py` takes a copy of
this one's).  Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import time


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_ceremony needs a CUDA device")

    from ..backend import build
    from . import ceremony_drive as CD

    t0 = time.perf_counter()
    build.build_all()
    built = time.perf_counter() - t0
    dev = torch.device("cuda")
    fx = CD.synthetic_fixture()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = CD.drive_ceremony(torch, np, dev, fx)
    t.update(CD.drive_ceremony_files(torch, dev, fx))
    tree = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    print(json.dumps({"tree": tree, "build_s": built,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "seconds": t}),
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip().splitlines()[:1]}))


if __name__ == "__main__":
    main()

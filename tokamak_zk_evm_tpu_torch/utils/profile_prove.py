"""Profile one full-shape prove on the card: device busy share and the
kernels that take the device time.

    python -m tokamak_zk_evm_tpu_torch.utils.profile_prove [--core NAME] [--out DIR]

Builds `build_synthetic()` at its defaults, runs setup twice (the first
builds and loads every kernel; the second, warm, is timed) and one untraced
prove, builds a second Prover outside the traced window, then traces its
`prove()` alone with `torch.profiler` and prints one JSON line: the warm
setup's seconds, the prove's wall seconds, the device busy seconds
(union of the CUDA activity intervals), the busy share, and the device
seconds of every CUDA kernel, most first, all of `prove()` and nothing of
Prover init.  `--out DIR` also writes
the Chrome trace there; `--core` picks the MSM core both proves run on
(`ops.msm.use_core`: "pippenger", the default, or "affine_tree").  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _busy_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> None:
    ap = argparse.ArgumentParser(description="profile one full-shape prove")
    ap.add_argument("--out", help="directory for the Chrome trace")
    ap.add_argument("--core", default="pippenger", help="MSM core (ops.msm.CORES)")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..models.protocol import Mixer
    from ..models.prover import Prover
    from ..models.setup import Tau, generate_sigma
    from ..ops import msm
    from ..testing.synthetic import build_synthetic

    if not torch.cuda.is_available():
        raise SystemExit("profile_prove needs a CUDA device")
    fx = build_synthetic()
    p = fx.params
    sigma = generate_sigma(p, Tau.fixed(), fx.library, fx.infos, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sigma = generate_sigma(p, Tau.fixed(), fx.library, fx.infos, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def prover():
        out = Prover(p, sigma, fx.library, fx.infos, fx.placements, fx.permutation,
                     fx.instance, mixer=Mixer.random(np.random.default_rng(3)), device="cuda")
        torch.cuda.synchronize()
        return out

    def prove(pr):
        t0 = time.perf_counter()
        with msm.use_core(args.core):
            pr.prove()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prove(prover())
    pr = prover()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = prove(pr)
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in dev]) / 1e6
    by_name: dict[str, float] = {}
    for e in dev:
        name = e.name.replace("(anonymous namespace)::", "").split("(")[0][:80]
        by_name[name] = by_name.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "prove_trace.json"))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "core": args.core,
        "setup_s": setup_s,
        "prove_wall_s": wall,
        "device_busy_s": busy,
        "busy_share": busy / wall if wall else None,
        "kernels_s": dict(ranked),
    }))


if __name__ == "__main__":
    main()

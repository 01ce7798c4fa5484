"""Profile one full-shape proof on the card: Prover init and `prove()`, the
device busy share, the kernels that take the device time, and the idle gaps
named by the program's own spans.

    python -m tokamak_zk_evm_tpu_torch.utils.profile_prove [--out DIR]

Builds `build_synthetic()` at its defaults, runs setup twice (the first
builds and loads every kernel; the second, warm, is timed) and one untraced
proof, then traces a second proof, `Prover(...)` and `prove()`, with
`torch.profiler` on, which turns the program's tracer (`utils/timing`) on
too.  Prints one JSON line: the warm setup's seconds, init's and the
prove's wall seconds, the device busy seconds (union of the CUDA activity
intervals), the busy share, the device seconds of every CUDA kernel (most
first), the seconds by program span, and the idle time by the innermost
program span open at each gap's midpoint: every gap's seconds under its
span's name, and the ten longest gaps.  Spans and device events share the
`time.time_ns` clock.  `--out DIR` also writes the Chrome trace there.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import time


def busy_and_gaps(intervals, t0: int, t1: int):
    """Union of (start, end) intervals within [t0, t1] -> (busy, gaps), the
    gaps as (start, end), in the intervals' unit."""
    busy, end, gaps = 0, t0, []
    for s, e in sorted(intervals):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if s > end:
            gaps.append((end, s))
        busy += max(0, e - max(s, end))
        end = max(end, e)
    if t1 > end:
        gaps.append((end, t1))
    return busy, gaps


def innermost(spans, t: int, default: str = "outside") -> str:
    """The name of the innermost of the nested (name, t0, t1) spans open at
    t; `spans` sorted by start, the longer first on a tie."""
    i = bisect.bisect_right(spans, t, key=lambda s: s[1])
    for name, s, e in reversed(spans[:i]):
        if e >= t:
            return name
    return default


def label_gaps(intervals, spans, t0: int, t1: int, top: int = 10) -> dict:
    """Idle time within [t0, t1] by the innermost span open at each gap's
    midpoint, and the `top` longest gaps as [name, length, start - t0]."""
    spans = sorted(spans, key=lambda s: (s[1], s[1] - s[2]))
    _, gaps = busy_and_gaps(intervals, t0, t1)
    by_span: dict[str, int] = {}
    named = []
    for g0, g1 in gaps:
        name = innermost(spans, (g0 + g1) // 2)
        by_span[name] = by_span.get(name, 0) + (g1 - g0)
        named.append([name, g1 - g0, g0 - t0])
    named.sort(key=lambda g: -g[1])
    return dict(by_span=dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
                longest=named[:top])


def main() -> None:
    ap = argparse.ArgumentParser(description="profile one full-shape proof")
    ap.add_argument("--out", help="directory for the Chrome trace")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..models.protocol import Mixer
    from ..models.prover import Prover
    from ..models.setup import Tau, generate_sigma
    from ..testing.synthetic import build_synthetic
    from . import timing

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

    def proof():
        """(init seconds, prove seconds), each closed by a synchronize."""
        t0 = time.perf_counter()
        pr = Prover(p, sigma, fx.library, fx.infos, fx.placements, fx.permutation,
                    fx.instance, mixer=Mixer.random(np.random.default_rng(3)), device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pr.prove()
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    proof()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.time_ns()
        init_s, prove_s = proof()
        w1 = time.time_ns()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    busy, _ = busy_and_gaps([(s, e) for _, s, e in dev], w0, w1)
    by_name: dict[str, float] = {}
    for name, s, e in dev:
        name = name.replace("(anonymous namespace)::", "").split("(")[0][:80]
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    spans = [(e.name, e.t0, e.t1) for e in timing.snapshot().events]
    gaps = label_gaps([(s, e) for _, s, e in dev], spans, w0, w1)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "prove_trace.json"))
    wall = (w1 - w0) / 1e9
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "setup_s": setup_s,
        "init_wall_s": init_s,
        "prove_wall_s": prove_s,
        "device_busy_s": busy / 1e9,
        "busy_share": busy / 1e9 / wall if wall else None,
        "kernels_s": dict(ranked),
        "spans_s": timing.summarize()["by_name"],
        "idle_by_span_s": {k: v / 1e9 for k, v in gaps["by_span"].items()},
        "idle_gaps": [[n, g / 1e9, at / 1e9] for n, g, at in gaps["longest"]],
    }))


if __name__ == "__main__":
    main()

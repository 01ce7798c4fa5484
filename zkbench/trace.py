"""Spans, op counters and the device trace of a traced run.

Everything here is switched on only with `--trace 1`.  Spans are host-clock
intervals (`time.time_ns`, the clock the profiler stamps its events with)
around calls into the program's layers, each closed after
`torch.cuda.synchronize()`.  The op counters wrap the program's MSM and NTT
entries (`ops.msm.msm_start`, `ops.ntt.ntt_axis`) and record each call's
shape; the MSM counter also counts the points that carry a nonzero scalar,
on the device and without a host sync.  Its few small kernels a call are
the harness's own: `device_events` leaves out every kernel whose launch
(matched by the profiler's correlation id) the host made inside a counter,
so they count in no busy second, kernel count or kernel time.  The device
trace is `torch.profiler` with CUDA activity only; `summarize` reduces its
events to busy seconds (the union of their intervals), seconds by kernel
name, the kernel count and the longest idle gaps, each named by the span it
fell in.
"""

from __future__ import annotations

import bisect
import time

import torch


class Recorder:
    """Spans, op shapes and the profiler of one process."""

    def __init__(self, device: str):
        self.device = device
        self.spans: list = []  # (label, t0_ns, t1_ns)
        self.msm: list = []  # (points, nonzero count tensor)
        self.own: list = []  # (t0_ns, t1_ns) of the counters' own launches
        self.ntt: list = []  # (n, batch)
        self.prof = None
        self._undo: list = []

    def sync(self):
        if self.device != "cpu":
            torch.cuda.synchronize()

    def span(self, label: str, fn, *a, **kw):
        """fn(*a, **kw) between two synchronizes, recorded as `label`."""
        self.sync()
        t0 = time.time_ns()
        out = fn(*a, **kw)
        self.sync()
        self.spans.append((label, t0, time.time_ns()))
        return out

    def last_s(self) -> float:
        _, t0, t1 = self.spans[-1]
        return (t1 - t0) / 1e9

    # -- op counters -----------------------------------------------------
    def install(self):
        from tokamak_zk_evm_tpu_torch.ops import msm as msm_mod
        from tokamak_zk_evm_tpu_torch.ops import ntt as ntt_mod

        rec = self
        msm_start, ntt_axis = msm_mod.msm_start, ntt_mod.ntt_axis

        def counted_msm_start(scalars, px, py, pinf, *a, **kw):
            t0 = time.time_ns()
            live = ((scalars != 0).any(0) & (pinf.reshape(-1) == 0)).sum()
            rec.own.append((t0, time.time_ns()))
            rec.msm.append((int(scalars.shape[1]), live))
            return msm_start(scalars, px, py, pinf, *a, **kw)

        def counted_ntt_axis(grid, axis, *a, **kw):
            n = int(grid.shape[axis])
            rec.ntt.append((n, grid.numel() // (grid.shape[0] * n)))
            return ntt_axis(grid, axis, *a, **kw)

        msm_mod.msm_start = counted_msm_start
        ntt_mod.ntt_axis = counted_ntt_axis
        self._undo = [(msm_mod, "msm_start", msm_start), (ntt_mod, "ntt_axis", ntt_axis)]

    def uninstall(self):
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)
        self._undo = []

    # -- profiler ----------------------------------------------------------
    def start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if self.device != "cpu" else [ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def stop_profiler(self):
        self.sync()
        self.prof.__exit__(None, None, None)

    def device_events(self) -> list:
        """(name, start_ns, end_ns) of every device activity traced but the
        counters' own: those launched from inside a counter."""
        events = list(self.prof.profiler.kineto_results.events())
        if self.device == "cpu":
            return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                    if e.name().startswith("aten::") and not _inside(self.own, e.start_ns())]
        cuda = torch.autograd.DeviceType.CUDA
        own = {e.correlation_id() for e in events
               if e.device_type() != cuda and e.correlation_id()
               and _inside(self.own, e.start_ns())}
        return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                if e.device_type() == cuda and e.correlation_id() not in own]

    def counts(self) -> dict:
        return dict(msm=[[n, int(c)] for n, c in self.msm], ntt=[list(t) for t in self.ntt])


def _inside(intervals: list, t: int) -> bool:
    """Whether t falls in one of the intervals, which are in time order."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def _label(spans, t: int, default: str) -> str:
    for label, t0, t1 in spans:
        if t0 <= t <= t1:
            return label
    return default


def summarize(events: list, spans: list, t0: int, t1: int, default: str) -> dict:
    """Busy seconds, seconds and launches by name, and the ten longest idle
    gaps within [t0, t1] (ns), each named by the span it falls in."""
    ev = sorted((s, e, name) for name, s, e in events if e > t0 and s < t1)
    busy, end, gaps = 0, t0, []
    by_name: dict = {}
    kernels = 0
    for s, e, name in ev:
        s, e = max(s, t0), min(e, t1)
        if s > end:
            gaps.append((s - end, end))
        busy += max(0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0) + (e - s)
        if not name.startswith(("Memcpy", "Memset", "memcpy", "memset")):
            kernels += 1
    if t1 > end:
        gaps.append((t1 - end, end))
    gaps.sort(reverse=True)
    return dict(
        busy_s=busy / 1e9,
        by_name={k: v / 1e9 for k, v in by_name.items()},
        kernels=kernels,
        gaps=[[_label(spans, g0 + g // 2, default), g / 1e9] for g, g0 in gaps[:10]],
    )

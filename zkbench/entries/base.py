"""What every entry adapter offers the harness, and the in-process defaults.

An adapter drives one of the program's entry points with the plain data of
the cell's kind of job (`tasks/<task>.py`).  `run.py` calls, in this order:
`setup()` (what the entry holds across jobs: counted in `setup_s`),
`prepare(job, key)` for the warm-up job and for every job of the window
(whatever `run_job` needs, made before the window and timed apart from
`setup_s`), `run_job(item)` twice on the warm-up job (in `setup_s`), then
`begin_window(rec)`, `run_job` job after job, `end_window()` (the device
peak), with a trace `trace_record(w0_ns, w1_ns, window_s)`, then
`forbidden()` and `close()`.  The defaults serve an entry that runs its jobs
in this process; one that runs them in other processes overrides the
window's four methods.
"""

from __future__ import annotations

import torch


class Entry:
    mixers = True  # a proof's jobs carry the generator's mixers
    zero_blinding = False  # a proof's control: the program's own zero-blinding path

    def __init__(self, ctx):
        self.ctx = ctx
        self.device = ctx.device
        self.rec = None

    def setup(self):
        pass

    def prepare(self, job, key):
        return job

    def run_job(self, item) -> dict:
        """dict(proof=<the job's answer, as the task's judge reads it: a proof
        as `reference.layout` names it>, timing={...})"""
        raise NotImplementedError

    def sync(self):
        if self.device != "cpu":
            torch.cuda.synchronize()

    def begin_window(self, rec):
        """`rec`: the traced run's recorder, or None."""
        self.rec = rec
        if self.device != "cpu":
            self.sync()
            torch.cuda.reset_peak_memory_stats()
        if rec is not None:
            rec.start_profiler()

    def end_window(self) -> int:
        self.sync()
        return torch.cuda.max_memory_allocated() if self.device != "cpu" else 0

    def trace_record(self, w0_ns: int, w1_ns: int, window_s: float) -> dict:
        """The device's side of the traced window: window_s, busy_s, kernels,
        by_name, gaps, msm, ntt (`metrics/__init__.py`)."""
        from ..trace import summarize

        rec = self.rec
        rec.stop_profiler()
        tr = summarize(rec.device_events(), rec.spans, w0_ns, w1_ns, "harness")
        c = rec.counts()
        return dict(tr, window_s=window_s, msm=c["msm"], ntt=c["ntt"])

    def forbidden(self) -> list[str]:
        """Forbidden modules loaded by processes other than this one."""
        return []

    def close(self):
        pass

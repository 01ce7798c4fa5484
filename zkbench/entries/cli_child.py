"""One CLI job's process: `tokamak_zk_evm_tpu_torch.cli.main` with the
`prove` arguments, as `python -m tokamak_zk_evm_tpu_torch` calls it.

    python -m zkbench.entries.cli_child OUT.json TRACE -- <cli arguments>

Before it returns it writes OUT.json: the wall-clock stamps (ns) of its
imports done, of its call into `cli.main` and of its end, the exit code, and
the process's `torch.cuda.max_memory_allocated`, and, read last, the modules
of `jax`, `jaxlib`, `flax` or the JAX package it held (the harness refuses
the run when there is one).  With TRACE 1 it also times the CRS load
and the Prover's init and rounds (each closed by a synchronize), counts the
MSM and NTT calls, and traces the device over the whole of `cli.main`.
"""

from __future__ import annotations

import json
import sys
import time


def main(argv: list[str]) -> int:
    out, trace = argv[0], argv[1] == "1"
    cli_args = argv[argv.index("--") + 1:]
    import torch

    from tokamak_zk_evm_tpu_torch import cli

    device = cli_args[cli_args.index("--device") + 1] if "--device" in cli_args else "cuda"
    t_ready = time.time_ns()  # interpreter up, imports done: cli.start_s ends here
    rec = None
    if trace:
        from tokamak_zk_evm_tpu_torch.io import crs
        from tokamak_zk_evm_tpu_torch.models import prover as prover_mod

        from zkbench.trace import Recorder

        rec = Recorder(device)
        load = crs.load_sigma_any
        base = prover_mod.Prover
        crs.load_sigma_any = lambda *a, **kw: rec.span("cli.crs_load", load, *a, **kw)

        class TimedProver(base):
            def __init__(self, *a, **kw):
                rec.span("prover.init", super().__init__, *a, **kw)

            def prove(self):
                return rec.span("prover.rounds", super().prove)

        prover_mod.Prover = TimedProver
        rec.install()
        rec.start_profiler()
    t_main = time.time_ns()
    rc = cli.main(cli_args)
    if device != "cpu":
        torch.cuda.synchronize()
    t_exit = time.time_ns()
    result = dict(rc=rc, t_ready=t_ready, t_main=t_main, t_exit=t_exit,
                  peak=torch.cuda.max_memory_allocated() if device != "cpu" else 0)
    if rec is not None:
        from zkbench.trace import summarize

        rec.stop_profiler()
        result["spans"] = {label: (t1 - t0) / 1e9 for label, t0, t1 in rec.spans}
        result["trace"] = summarize(rec.device_events(), rec.spans, t_main, t_exit, "cli.other")
        result["counts"] = rec.counts()
        result["t_written"] = time.time_ns()  # the trace's own cost ends here
    from zkbench.isolation import forbidden_modules

    result["forbidden"] = forbidden_modules()
    with open(out, "w") as f:
        json.dump(result, f)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

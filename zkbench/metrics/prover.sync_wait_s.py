"""Seconds a proof the host waits on the card inside the Prover: the
program's `sync.*` spans under `prover.init` and `prover.prove`
(`program_spans`), a complete proof's mean.  Read from the program's tracer,
not from `rec`."""

from zkbench import program_spans


def read(rec):
    return program_spans.mean("sync_wait_s")

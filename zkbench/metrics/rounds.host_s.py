"""Host seconds a proof in the rounds: the program's `prover.prove` span less
the `sync.*` spans inside it (`program_spans`), a complete proof's mean.
Read from the program's tracer, not from `rec`."""

from zkbench import program_spans


def read(rec):
    return program_spans.mean("rounds_host_s")

"""Host waits on the card a proof: the program's `host_syncs` counter under
`prover.init` and `prover.prove` (`program_spans`), a complete proof's mean.
Read from the program's tracer, not from `rec`."""

from zkbench import program_spans


def read(rec):
    return program_spans.mean("syncs")

"""Host seconds a proof in the Prover's witness build: the program's
`init.witness` span less the `sync.*` spans inside it (`program_spans`), a
complete proof's mean.  Read from the program's tracer, not from `rec`."""

from zkbench import program_spans


def read(rec):
    return program_spans.mean("witness_host_s")

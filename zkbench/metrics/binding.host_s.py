"""Host seconds a proof in the Prover's binding (statement packing, the
binding MSMs' host side, the 16 host scalar multiplications): the program's
`init.binding` span less the `sync.*` spans inside it (`program_spans`), a
complete proof's mean.  Read from the program's tracer, not from `rec`."""

from zkbench import program_spans


def read(rec):
    return program_spans.mean("binding_host_s")

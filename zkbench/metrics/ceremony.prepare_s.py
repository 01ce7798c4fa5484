"""Seconds the circuit-specific prepare takes, `phase2_prepare`: the
program's `p2.prepare` root spans in the traced window (each ends with the
wait for the families), their mean.  Read from the program's tracer; None
where the program has no such span."""

from zkbench import ceremony_spans


def read(rec):
    return ceremony_spans.mean("p2.prepare")

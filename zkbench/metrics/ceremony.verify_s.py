"""Seconds the coordinator's check takes, `phase2_verify`: the program's
`p2.verify` root spans in the traced window, their mean.  Read from the
program's tracer; None where the program has no such span."""

from zkbench import ceremony_spans


def read(rec):
    return ceremony_spans.mean("p2.verify")

"""Seconds a phase-1 contribution takes, `Phase1Accumulator.compute`: the
program's `p1.contribute` root spans in the traced window, their mean.  Read
from the program's tracer, not from `rec`; None where the program has no
such span."""

from zkbench import ceremony_spans


def read(rec):
    return ceremony_spans.mean("p1.contribute")

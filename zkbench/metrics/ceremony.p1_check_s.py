"""Seconds a job of the coordinator's phase-1 check: the program's `p1.load`
(the checked load of the accumulator's JSON) and `p1.verify` root spans in
the traced window, over the jobs that completed in it.  Read from the
program's tracer; None where it has none."""

from zkbench import ceremony_spans


def read(rec):
    s = sum(ceremony_spans.seconds("p1.load")) + sum(ceremony_spans.seconds("p1.verify"))
    return s / rec["proofs"] if s > 0 and rec["proofs"] else None

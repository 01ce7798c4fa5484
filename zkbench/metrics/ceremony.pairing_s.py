"""Seconds a job of host pairings: the program's `p2.pairing` spans (every
`multi_pairing` of the coordinator's check, its Schnorr checks' included) in
the traced window, over the jobs that completed in it.  Read from the
program's tracer; None where it has none."""

from zkbench import ceremony_spans


def read(rec):
    return ceremony_spans.per_job("p2.pairing", rec)

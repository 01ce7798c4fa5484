"""Seconds a job of transcript hashing: the program's `p2.hash` spans (the
families' pull to the host, `sync.p2.hash_pull`, included; one in the
contribution, one in the check) in the traced window, over the jobs that
completed in it.  Read from the program's tracer; None where it has none."""

from zkbench import ceremony_spans


def read(rec):
    return ceremony_spans.per_job("p2.hash", rec)

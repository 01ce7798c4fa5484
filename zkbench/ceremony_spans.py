"""The ceremony's spans in the program's traced window, for the readers of
`ceremony.contribute_s`, `ceremony.verify_s`, `ceremony.hash_s` and
`ceremony.pairing_s`.  Each walks `program_spans.snapshot().events`; an
empty list, or None, where the program has no such span."""

from zkbench import program_spans


def seconds(name: str) -> list:
    """The seconds of every span `name` in the program's traced window."""
    snap = program_spans.snapshot()
    return [(e.t1 - e.t0) / 1e9 for e in snap.events if e.name == name] if snap else []


def mean(name: str):
    s = seconds(name)
    return sum(s) / len(s) if s else None


def per_job(name: str, rec):
    """The spans' seconds over the jobs that completed in the window."""
    s = sum(seconds(name))
    return s / rec["proofs"] if s > 0 and rec["proofs"] else None

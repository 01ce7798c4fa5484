"""Seconds of `Prover.prove()` (rounds 0-4) between two synchronizes, a
job's mean."""


def read(rec):
    vals = [j["rounds_s"] for j in rec["jobs"] if j.get("rounds_s") is not None]
    return sum(vals) / len(vals) if vals else None

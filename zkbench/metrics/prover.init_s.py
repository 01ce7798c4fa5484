"""Seconds of `Prover(...)` construction (witness and instance polynomials,
the binding MSMs) between two synchronizes, a job's mean."""


def read(rec):
    vals = [j["init_s"] for j in rec["jobs"] if j.get("init_s") is not None]
    return sum(vals) / len(vals) if vals else None

"""Seconds inside `io.crs.load_sigma_any` (the rkyv CRS parse and its copy to
the card), closed by a synchronize, a CLI job's mean."""


def read(rec):
    vals = [j["crs_load_s"] for j in rec["jobs"] if j.get("crs_load_s") is not None]
    return sum(vals) / len(vals) if vals else None

"""Seconds from spawning a CLI job's process to its call into `cli.main`
(interpreter start, imports, CUDA not yet touched), a job's mean; the wrapper
in `entries/cli_child.py` stamps the call."""


def read(rec):
    vals = [j["start_s"] for j in rec["jobs"] if j.get("start_s") is not None]
    return sum(vals) / len(vals) if vals else None

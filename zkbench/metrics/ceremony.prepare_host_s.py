"""Host seconds of the circuit-specific prepare: each `p2.prepare` span's
seconds less the `sync.*` spans inside it (a wait nested in another counted
once), their mean over the traced window.  Read from the program's tracer;
None where the program has no such span."""

from zkbench import program_spans

ROOT = "p2.prepare"


def host_seconds(snap) -> list:
    """Each `p2.prepare` span's seconds less its waits."""
    wait: dict = {}  # span id -> seconds of sync spans in its subtree
    out = []
    for e in snap.events:  # closing order: a span's children close before it
        below = wait.pop(e.id, 0.0)
        if e.name == ROOT:
            out.append((e.t1 - e.t0) / 1e9 - below)
        elif e.parent:
            own = (e.t1 - e.t0) / 1e9 if e.name.startswith("sync.") else below
            wait[e.parent] = wait.get(e.parent, 0.0) + own
    return out


def read(rec):
    snap = program_spans.snapshot()
    s = host_seconds(snap) if snap is not None else []
    return sum(s) / len(s) if s else None

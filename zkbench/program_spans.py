"""The program's own spans and counters, per proof.

The program's tracer (`tokamak_zk_evm_tpu_torch.utils.timing`) is on while a
profiler is active, so in a traced run of an entry that proves in this
process its latest period is the window.  `per_proof()` reduces that period
to one row a complete proof id (one whose `prover.init` and `prover.prove`
roots both closed in it):

* `witness_host_s`, `binding_host_s`, `rounds_host_s`: the host self time of
  `init.witness`, `init.binding` and `prover.prove`, each span's seconds less
  the `sync.*` spans inside it;
* `sync_wait_s`: the seconds inside `sync.*` spans under both roots;
* `syncs`: the `host_syncs` counter under both roots;
* `init`, `prove`: the roots' (start, end) on `time.time_ns`.

None where the program has no such tracer (an older program), the period
recorded nothing, or it dropped events.  The CLI's job processes trace
nothing this process can read.
"""

from __future__ import annotations

ROOTS = ("prover.init", "prover.prove")
SUBTREES = dict(witness_host_s="init.witness", binding_host_s="init.binding",
                rounds_host_s="prover.prove")


def snapshot():
    """The program's latest traced period, or None (see the module doc)."""
    try:
        from tokamak_zk_evm_tpu_torch.utils import timing
    except ImportError:
        return None
    take = getattr(timing, "snapshot", None)
    if take is None:
        return None
    snap = take()
    if not snap.events or snap.dropped:
        return None
    return snap


def rows(snap) -> list[dict]:
    """One dict a complete proof id, in the order their init began."""
    wait: dict = {}  # span id -> seconds of sync spans in its subtree
    by_proof: dict = {}
    for e in snap.events:  # closing order: a span's children close before it
        below = wait.pop(e.id, 0.0)
        own = (e.t1 - e.t0) / 1e9 if e.name.startswith("sync.") else below
        if e.parent:
            wait[e.parent] = wait.get(e.parent, 0.0) + own
        if e.proof is not None and (e.name in ROOTS or e.name in SUBTREES.values()):
            by_proof.setdefault(e.proof, {})[e.name] = (e, own)
    syncs: dict = {}
    for (proof, name, _), k in snap.counts.items():
        if name == "host_syncs":
            syncs[proof] = syncs.get(proof, 0) + k
    out = []
    for proof, spans in by_proof.items():
        if not all(r in spans for r in ROOTS):
            continue
        row = dict(proof=proof, syncs=syncs.get(proof, 0),
                   sync_wait_s=sum(spans[r][1] for r in ROOTS),
                   init=(spans["prover.init"][0].t0, spans["prover.init"][0].t1),
                   prove=(spans["prover.prove"][0].t0, spans["prover.prove"][0].t1))
        for key, name in SUBTREES.items():
            e, w = spans.get(name, (None, 0.0))
            row[key] = (e.t1 - e.t0) / 1e9 - w if e is not None else 0.0
        out.append(row)
    return sorted(out, key=lambda r: r["init"][0])


def per_proof(snap=None) -> list[dict] | None:
    snap = snapshot() if snap is None else snap
    if snap is None:
        return None
    return rows(snap) or None


def mean(key: str, snap=None) -> float | None:
    """The mean of `key` over the period's complete proofs, or None."""
    r = per_proof(snap)
    return sum(x[key] for x in r) / len(r) if r else None

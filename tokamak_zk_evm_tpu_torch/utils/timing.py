"""The port's in-program tracer: spans and counters over the prover's layers.

Off by default.  `enable()` / `disable()` (or a `tracing()` block) turn it on
explicitly; it is also on while a `torch.profiler` profile is active
(`torch.autograd._profiler_enabled()`), so a profiled region traces the
program with no call of its own.  While it is off, `span()`, `sync()` and
`count()` record nothing after one check.

A span records its id, its parent's id (0 for none), its proof id, name,
category, start and end on `time.time_ns()` (the clock the profiler stamps
its events with) and sizes.  A span opened with `proof=` (the Prover's roots,
ids from `new_proof()`) hands its proof id to every span and count under it;
a span given no category takes its parent's.  `sync(site)` is the span
`sync.<site>` around a point where the host waits for the card, counted as
`host_syncs`.  Counters add up per (proof id, name, sizes).

A period is one stretch in which tracing is on.  Its first span or count
clears what the previous period recorded, so `snapshot()` and `summarize()`
read the latest period alone.  A period the profiler opened ends at the
first span or count that finds tracing off, or at `disable()`.  At most
`CAP` events and `CAP` counter keys are kept; past that they are dropped and
counted (`Snapshot.dropped`).

No `record_function` range is emitted: a profile sees the same device work
with tracing on and off.  Spans nest on one stack: trace from one thread.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from collections import defaultdict
from typing import NamedTuple

import torch

CAP = 1 << 18


class Event(NamedTuple):
    id: int
    parent: int
    proof: int | None
    name: str
    category: str
    t0: int
    t1: int
    sizes: dict

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


class Snapshot(NamedTuple):
    """The latest period: its events (in closing order), counters keyed by
    (proof id, name, sorted sizes), events and keys dropped, its number."""

    events: list
    counts: dict
    dropped: int
    period: int


class _State:
    def __init__(self):
        self.explicit = False  # enable() in force
        self.live = False  # the current period is open
        self.period = 0
        self.events: list = []
        self.counts: dict = {}
        self.dropped = 0
        self.stack: list = []  # open spans, innermost last
        self.ids = itertools.count(1)


_S = _State()
_proofs = itertools.count(1)
_profiling = torch.autograd._profiler_enabled


def _on() -> bool:
    s = _S
    if s.explicit or _profiling():
        if not s.live:
            _begin()
        return True
    s.live = False
    return False


def _begin():
    s = _S
    s.live = True
    s.period += 1
    s.events, s.counts, s.dropped = [], {}, 0


def enable():
    """Turn tracing on and start a new period."""
    _S.explicit = True
    _begin()


def disable():
    """Turn explicit tracing off and end the period; what it recorded stays
    readable until the next period starts."""
    _S.explicit = False
    _S.live = False


@contextlib.contextmanager
def tracing():
    """Tracing on inside the block (a new period), unless it is on already."""
    if _S.explicit:
        yield
        return
    enable()
    try:
        yield
    finally:
        disable()


def new_proof() -> int:
    """A proof id, unique in the process."""
    return next(_proofs)


class _Span:
    __slots__ = ("name", "category", "proof", "sizes", "id", "parent", "t0")

    def __init__(self, name, category, proof, sizes):
        self.name, self.category, self.proof, self.sizes = name, category, proof, sizes

    def __enter__(self):
        s = _S
        up = s.stack[-1] if s.stack else None
        self.parent = up.id if up is not None else 0
        if self.proof is None and up is not None:
            self.proof = up.proof
        if self.category is None:
            self.category = up.category if up is not None else "misc"
        self.id = next(s.ids)
        s.stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        s = _S
        s.stack.pop()
        if len(s.events) < CAP:
            s.events.append(Event(self.id, self.parent, self.proof, self.name, self.category,
                                  self.t0, t1, self.sizes))
        else:
            s.dropped += 1
        return False


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str, category: str | None = None, proof: int | None = None, **sizes):
    """A context that records one span while tracing is on."""
    if not _on():
        return _NULL
    return _Span(name, category, proof, sizes)


def sync(site: str):
    """The span `sync.<site>` of a host wait on the card, counted as
    `host_syncs`."""
    if not _on():
        return _NULL
    _add("host_syncs", 1, ())
    return _Span("sync." + site, None, None, {})


def count(name: str, k: int = 1, **sizes):
    """Add k to counter `name` (per proof id and sizes) while tracing is on."""
    if _on():
        _add(name, k, tuple(sorted(sizes.items())))


def _add(name, k, sizes):
    s = _S
    key = (s.stack[-1].proof if s.stack else None, name, sizes)
    if key in s.counts:
        s.counts[key] += k
    elif len(s.counts) < CAP:
        s.counts[key] = k
    else:
        s.dropped += 1


def open_span() -> str | None:
    """The name of the innermost span open now, or None."""
    return _S.stack[-1].name if _S.stack else None


def snapshot() -> Snapshot:
    """The latest period's events and counters (copies)."""
    s = _S
    return Snapshot(list(s.events), dict(s.counts), s.dropped, s.period)


def summarize() -> dict:
    """Seconds by name (every span) and by category (the spans with no
    ancestor of their own category, so nested spans count once), of the
    latest period."""
    events = _S.events
    cat_of = {e.id: e.category for e in events}
    parent = {e.id: e.parent for e in events}
    by_cat, by_name = defaultdict(float), defaultdict(float)
    for e in events:
        by_name[e.name] += e.seconds
        up = parent[e.id]
        while up and cat_of.get(up) != e.category:
            up = parent.get(up, 0)
        if not up:
            by_cat[e.category] += e.seconds
    return {"by_category": dict(by_cat), "by_name": dict(by_name)}

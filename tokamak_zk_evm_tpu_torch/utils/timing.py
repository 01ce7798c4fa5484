"""Span-based tracing, the port's counterpart of the reference's `timing` module
(`libs/src/lib.rs:11-141`, `prove/src/lib.rs:150-242`): named spans with
categories (load/build/poly/encode/prove), collected globally, reportable as
JSON.  Enabled unconditionally (cost is a clock read; the reference gates it
behind a cargo feature because Rust spans are pervasive — ours wrap whole
phases)."""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

_EVENTS: list[dict] = []


def reset():
    _EVENTS.clear()


@contextlib.contextmanager
def span(name: str, category: str = "misc", **sizes):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _EVENTS.append(
            {
                "name": name,
                "category": category,
                "seconds": time.perf_counter() - t0,
                "sizes": sizes,
            }
        )


def take_events() -> list[dict]:
    out = list(_EVENTS)
    _EVENTS.clear()
    return out


def summarize(events=None) -> dict:
    events = events if events is not None else _EVENTS
    by_cat = defaultdict(float)
    by_name = defaultdict(float)
    for e in events:
        by_cat[e["category"]] += e["seconds"]
        by_name[e["name"]] += e["seconds"]
    return {"by_category": dict(by_cat), "by_name": dict(by_name)}


def dump_json(path: str):
    with open(path, "w") as f:
        json.dump({"events": _EVENTS, "summary": summarize()}, f, indent=1)

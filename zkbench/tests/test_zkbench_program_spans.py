"""The readers of the program's own spans (`zkbench/program_spans.py` and the
five metrics on it): their arithmetic on hand-made buffers, None on an empty
or overflowed buffer and on a program without the tracer, only the latest
traced period read, and the CPU's traced service run reporting all five."""

from __future__ import annotations

import json
import os
import time

import pytest

from tokamak_zk_evm_tpu_torch.utils import timing
from zkbench import program_spans, run
from zkbench import metrics as metrics_pkg

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
READERS = {"witness.host_s": "witness_host_s", "binding.host_s": "binding_host_s",
           "rounds.host_s": "rounds_host_s", "prover.sync_wait_s": "sync_wait_s",
           "prover.syncs_per_proof": "syncs"}
MS = 1_000_000  # ns


def _ev(i, parent, proof, name, t0_ms, t1_ms):
    return timing.Event(i, parent, proof, name, "build", t0_ms * MS, t1_ms * MS, {})


def _proof(pid, base, first_id):
    """One proof's spans in closing order, times in ms from `base`:
    init 0-100 (witness 0-60 with a 10 ms sync, binding 60-90 with 5 ms and
    3 ms syncs, a 2 ms sync directly under init at 95), prove 100-150 (a
    round 100-140 holding a 4 ms sync inside an msm.finish)."""
    i = first_id
    init, wit, bind, prove, rnd, fin = range(i, i + 6)
    b = base
    return [
        _ev(i + 6, wit, pid, "sync.field.tensor", b + 20, b + 30),
        _ev(wit, init, pid, "init.witness", b, b + 60),
        _ev(i + 7, bind, pid, "sync.msm.nonzero", b + 61, b + 66),
        _ev(i + 8, bind, pid, "sync.msm.finish_pull", b + 70, b + 73),
        _ev(bind, init, pid, "init.binding", b + 60, b + 90),
        _ev(i + 9, init, pid, "sync.field.host", b + 95, b + 97),
        _ev(init, 0, pid, "prover.init", b, b + 100),
        _ev(i + 10, fin, pid, "sync.msm.finish_pull", b + 110, b + 114),
        _ev(fin, rnd, pid, "msm.finish", b + 108, b + 120),
        _ev(rnd, prove, pid, "prove0", b + 100, b + 140),
        _ev(prove, 0, pid, "prover.prove", b + 100, b + 150),
    ]


def _snap(events, counts=None, dropped=0):
    return timing.Snapshot(events, counts or {}, dropped, 1)


def test_rows_on_a_hand_made_buffer():
    ev = _proof(7, 0, 1) + _proof(8, 200, 100)
    counts = {(7, "host_syncs", ()): 5, (8, "host_syncs", ()): 7, (None, "host_syncs", ()): 9,
              (7, "other", ()): 3}
    rows = program_spans.rows(_snap(ev, counts))
    assert [r["proof"] for r in rows] == [7, 8]
    r = rows[0]
    assert r["witness_host_s"] == pytest.approx(0.050)
    assert r["binding_host_s"] == pytest.approx(0.022)
    assert r["rounds_host_s"] == pytest.approx(0.046)
    assert r["sync_wait_s"] == pytest.approx(0.024)
    assert r["syncs"] == 5 and rows[1]["syncs"] == 7
    assert r["init"] == (0, 100 * MS) and r["prove"] == (100 * MS, 150 * MS)
    assert program_spans.mean("syncs", _snap(ev, counts)) == 6


def test_an_incomplete_proof_is_left_out():
    ev = _proof(7, 0, 1) + [e for e in _proof(8, 200, 100) if e.name != "prover.prove"]
    assert [r["proof"] for r in program_spans.rows(_snap(ev))] == [7]


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_on_a_hand_made_buffer(name, monkeypatch):
    ev = _proof(7, 0, 1) + _proof(8, 200, 100)
    counts = {(7, "host_syncs", ()): 5, (8, "host_syncs", ()): 7}
    want = {"witness.host_s": 0.050, "binding.host_s": 0.022, "rounds.host_s": 0.046,
            "prover.sync_wait_s": 0.024, "prover.syncs_per_proof": 6}[name]
    reader = metrics_pkg.load(name)
    monkeypatch.setattr(timing, "snapshot", lambda: _snap(ev, counts))
    assert reader.read({}) == pytest.approx(want)
    monkeypatch.setattr(timing, "snapshot", lambda: _snap([]))
    assert reader.read({}) is None
    monkeypatch.setattr(timing, "snapshot", lambda: _snap(ev, counts, dropped=1))
    assert reader.read({}) is None


def test_none_from_a_program_without_the_tracer(monkeypatch):
    monkeypatch.delattr(timing, "snapshot")
    for name in READERS:
        assert metrics_pkg.load(name).read({}) is None


def _traced_proof(pid, wait_s):
    with timing.span("prover.init", "build", proof=pid):
        with timing.span("init.witness"):
            with timing.sync("field.tensor"):
                time.sleep(wait_s)
        with timing.span("init.binding"):
            pass
    with timing.span("prover.prove", "prove", proof=pid):
        pass


def test_an_earlier_window_is_not_read():
    with timing.tracing():
        _traced_proof(timing.new_proof(), 0.02)
        _traced_proof(timing.new_proof(), 0.02)
    first = program_spans.per_proof()
    assert len(first) == 2
    with timing.tracing():
        pid = timing.new_proof()
        _traced_proof(pid, 0.001)
    rows = program_spans.per_proof()
    assert [r["proof"] for r in rows] == [pid]
    assert rows[0]["syncs"] == 1 and rows[0]["sync_wait_s"] < 0.02


def test_the_cpu_traced_service_run_reports_all_five():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        from zkbench.tests.test_zkbench_harness import _run

        out, res = _run("s256-service.full-tx", True)
    finally:
        torch.set_num_threads(n)
    assert res["correct"]
    assert set(READERS) <= set(res["metrics"])
    rows = program_spans.per_proof()
    assert len(rows) == len(out["done"]) == out["attempted"]
    m = res["metrics"]
    assert m["prover.syncs_per_proof"]["value"] == rows[0]["syncs"] > 0
    parts = sum(m[k]["value"] for k in READERS if k != "prover.syncs_per_proof")
    init_rounds = m["prover.init_s"]["value"] + m["prover.rounds_s"]["value"]
    assert parts <= init_rounds and parts == pytest.approx(init_rounds, rel=0.05)

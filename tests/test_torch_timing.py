"""The port's tracer (`utils/timing`) on the CPU, at the toy fixture's shape.

* Off by default: three proves record no event and no count, and start no
  period.
* On under `enable()` / `tracing()` and while a `torch.profiler` profile is
  active; a new period leaves the earlier one's events out.
* A traced prove: every span carries the Prover's proof id and a parent that
  encloses it, stamps on `time.time_ns`, the span tree of the Prover's
  layers, and the subtrees' host self times plus the `sync.*` spans adding
  up to the two roots.
* The counters of a warm prove, pinned: host waits on the card, and the
  placement variables converted to Montgomery form (each once).
* The MSM's pull of its results is a `sync.*` span under `msm.finish`.
* The buffer's cap drops events and counter keys and counts them.
* `utils/profile_prove.py` names idle gaps by the innermost span open at
  each gap's midpoint, on synthetic intervals.
"""

from __future__ import annotations

import collections
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tokamak_zk_evm_tpu_torch.host.curve import G1, g1_scalar_mul_affine
from tokamak_zk_evm_tpu_torch.models.protocol import Mixer
from tokamak_zk_evm_tpu_torch.models.prover import Prover
from tokamak_zk_evm_tpu_torch.models.setup import Tau, generate_sigma
from tokamak_zk_evm_tpu_torch.ops import curve as TC
from tokamak_zk_evm_tpu_torch.ops import msm as TM
from tokamak_zk_evm_tpu_torch.testing.fixtures import build_fixture
from tokamak_zk_evm_tpu_torch.utils import timing

torch.set_num_threads(1)

# a warm toy prove (`Mixer.zero()`): its host waits by site
SYNC_SITES = {
    "sync.field.tensor": 213, "sync.poly.find_degree": 31, "sync.msm.nonzero": 22,
    "sync.msm.unique_consecutive": 22, "sync.msm.chunk_segments": 22,
    "sync.msm.repeat_interleave": 22, "sync.msm.finish_pull": 22,
    "sync.witness.upload": 1, "sync.binding.indices": 3, "sync.field.host": 2,
}
HOST_SYNCS = sum(SYNC_SITES.values())  # 360
VARS_CONVERTED = 22  # the toy's placement variables, each converted once

TREE = {  # span -> the parent it has, every one of them
    "init.witness": "prover.init", "init.binding": "prover.init",
    "witness.convert": "init.witness", "witness.bXY": "init.witness",
    "witness.uXY": "init.witness", "witness.vXY": "init.witness",
    "witness.wXY": "init.witness", "witness.instance": "init.witness",
    "binding.host_curve": "init.binding",
    "prove0": "prover.prove", "prove1": "prover.prove", "prove2": "prover.prove",
    "prove3": "prover.prove", "prove4": "prover.prove",
}
UNDER = {  # span -> the parents it may have, and those it must appear under
    "binding.pack": {"init.binding"},
    "binding.msm": {"init.binding"},
    "transcript": {"prove0", "prove1", "prove2", "prove3"},
    "msm.finish": {"binding.msm", "prove0", "prove1", "prove2", "prove4"},
}


@pytest.fixture(scope="module")
def toy():
    fx = build_fixture()
    sigma = generate_sigma(fx.params, Tau.fixed(), fx.library, fx.infos, device="cpu")
    return fx, sigma


def _prover(toy):
    fx, sigma = toy
    return Prover(fx.params, sigma, fx.library, fx.infos, fx.placements, fx.permutation,
                  fx.instance, mixer=Mixer.zero(), device="cpu")


@pytest.fixture(scope="module")
def untraced(toy):
    """Three proves with tracing off, after an empty explicit period: the
    snapshot after each."""
    timing.enable()
    timing.disable()
    snaps = []
    for _ in range(3):
        _prover(toy).prove()
        snaps.append(timing.snapshot())
    return snaps


@pytest.fixture(scope="module")
def traced(toy, untraced):
    """One warm prove inside `tracing()`: (snapshot, proof id, clock bounds)."""
    t_lo = time.time_ns()
    with timing.tracing():
        pr = _prover(toy)
        pr.prove()
    t_hi = time.time_ns()
    return timing.snapshot(), pr.proof_id, t_lo, t_hi


def test_tracing_off_records_nothing(untraced):
    period = untraced[0].period
    for snap in untraced:
        assert snap.events == [] and snap.counts == {} and snap.dropped == 0
        assert snap.period == period
    assert timing.span("x") is timing.span("y") and timing.sync("z") is timing.span("x")


def test_on_under_enable_and_under_the_profiler(toy):
    with timing.tracing():
        _prover(toy)
    names = {e.name for e in timing.snapshot().events}
    assert {"prover.init", "init.witness", "init.binding"} <= names

    with profile(activities=[ProfilerActivity.CPU]):
        pr = _prover(toy)
    snap = timing.snapshot()
    assert {e.proof for e in snap.events} == {pr.proof_id}
    names = {e.name for e in snap.events}
    assert {"prover.init", "witness.convert", "binding.host_curve"} <= names

    with timing.span("off"):  # tracing is off again: the profiler's period has ended
        pass
    assert timing.snapshot().period == snap.period
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("second"):
            pass
    later = timing.snapshot()
    assert later.period == snap.period + 1 and [e.name for e in later.events] == ["second"]


def test_parents_proof_id_and_clock(traced):
    snap, pid, t_lo, t_hi = traced
    by_id = {e.id: e for e in snap.events}
    roots = [e for e in snap.events if e.parent == 0]
    assert sorted(e.name for e in roots) == ["prover.init", "prover.prove"]
    for e in snap.events:
        assert e.proof == pid
        assert t_lo <= e.t0 <= e.t1 <= t_hi
        if e.parent:
            up = by_id[e.parent]
            assert up.t0 <= e.t0 and e.t1 <= up.t1
    assert {e.category for e in roots} == {"build", "prove"}


def test_the_span_tree(traced):
    snap = traced[0]
    by_id = {e.id: e for e in snap.events}
    parents = collections.defaultdict(set)
    for e in snap.events:
        parents[e.name].add(by_id[e.parent].name if e.parent else None)
    for name, up in TREE.items():
        assert parents[name] == {up}, name
    for name, ups in UNDER.items():
        assert parents[name] and parents[name] <= ups, name
    assert sum(e.name == "witness.convert" for e in snap.events) == 1
    assert {"prove0", "prove1", "prove2", "prove4"} <= parents["msm.finish"]
    assert parents["transcript"] == UNDER["transcript"]
    syncs = collections.Counter(e.name for e in snap.events if e.name.startswith("sync."))
    assert syncs == SYNC_SITES


def test_self_times_and_waits_add_up_to_the_roots(traced):
    snap = traced[0]
    wait = collections.defaultdict(int)  # span id -> ns of sync spans beneath it
    dur = {}
    for e in snap.events:  # closing order
        own = e.t1 - e.t0 if e.name.startswith("sync.") else wait[e.id]
        wait[e.parent] += own
        dur[e.name] = (e.t1 - e.t0, wait[e.id])
    roots = dur["prover.init"][0] + dur["prover.prove"][0]
    host = sum(dur[k][0] - dur[k][1] for k in ("init.witness", "init.binding", "prover.prove"))
    waits = dur["prover.init"][1] + dur["prover.prove"][1]
    assert waits > 0
    assert host + waits <= roots
    assert host + waits == pytest.approx(roots, rel=0.02)


def test_counts_of_a_warm_prove(traced):
    snap, pid = traced[:2]
    totals = collections.Counter()
    for (proof, name, sizes), k in snap.counts.items():
        assert proof == pid
        totals[name] += k
    assert totals == {"host_syncs": HOST_SYNCS, "witness.vars_converted": VARS_CONVERTED}


def test_the_msm_spans_its_pull():
    pts = [g1_scalar_mul_affine(G1.gen, k) for k in (1, 2, 3)]
    s = TM.scalars_from_ints([5, 7, 11], "cpu")
    tx, ty, ti = TC.pack_affine(pts, "cpu")
    with timing.tracing():
        TM.msm(s, tx, ty, ti)
    snap = timing.snapshot()
    name = {e.id: e.name for e in snap.events}
    pulls = [e for e in snap.events if e.name == "sync.msm.finish_pull"]
    assert len(pulls) == 1
    assert {name[e.parent] for e in pulls} == {"msm.finish"}


def test_the_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(timing, "CAP", 5)
    with timing.tracing():
        for i in range(8):
            with timing.span(f"s{i}", proof=1):
                timing.count(f"c{i}")
    snap = timing.snapshot()
    assert [e.name for e in snap.events] == [f"s{i}" for i in range(5)]
    assert len(snap.counts) == 5
    assert snap.dropped == 3 + 3
    with timing.tracing():  # a new period starts with nothing dropped
        pass
    assert timing.snapshot().dropped == 0


def test_summary_counts_nested_spans_once():
    with timing.tracing():
        with timing.span("outer", "build"):
            with timing.span("inner"):
                with timing.sync("wait"):
                    time.sleep(0.002)
            with timing.span("enc", "encode"):
                pass
    s = timing.summarize()
    assert set(s["by_category"]) == {"build", "encode"}
    assert s["by_category"]["build"] == pytest.approx(s["by_name"]["outer"])
    assert s["by_name"]["sync.wait"] >= 0.002


def test_profile_prove_names_idle_gaps_by_the_innermost_span():
    from tokamak_zk_evm_tpu_torch.utils.profile_prove import busy_and_gaps, label_gaps

    spans = [  # nested, as the tracer records them (in closing order)
        ("sync.msm.nonzero", 30, 34), ("binding.pack", 20, 28), ("init.binding", 20, 40),
        ("witness.convert", 0, 10), ("witness.bXY", 0, 12), ("init.witness", 0, 18),
        ("prover.init", 0, 50), ("msm.finish", 60, 64), ("prove0", 55, 70),
        ("prover.prove", 50, 80),
    ]
    kernels = [(11, 14), (13, 19), (29, 31), (34, 36), (66, 68), (95, 97)]
    busy, gaps = busy_and_gaps(kernels, 0, 100)
    assert busy == 8 + 2 + 2 + 2 + 2 and gaps == [(0, 11), (19, 29), (31, 34),
                                                      (36, 66), (68, 95), (97, 100)]
    out = label_gaps(kernels, spans, 0, 100, top=3)
    # midpoints 5, 24, 32, 51, 81, 98: witness.convert, binding.pack, the MSM's wait,
    # prover.prove at its first instant, then none open
    assert out["by_span"] == {"prover.prove": 30, "outside": 27 + 3, "witness.convert": 11,
                              "binding.pack": 10, "sync.msm.nonzero": 3}
    assert out["longest"] == [["prover.prove", 30, 36], ["outside", 27, 68],
                              ["witness.convert", 11, 0]]
    # a child that starts with its parent is the innermost one
    assert label_gaps([], [("outer", 0, 10), ("inner", 0, 4)], 0, 3)["by_span"] == {"inner": 3}

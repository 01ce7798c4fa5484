"""The close of phase 1's kind of job (`tasks/phase1.py`, `entries/phase1.py`,
`reference/phase1.py`) on the CPU at a tiny library: the cell end to end
through `run_cell`, traced and untraced, both controls, the readers of its
six metrics, and the reference's isolation from the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from zkbench import gen, run
from zkbench import metrics as metrics_pkg
from zkbench.reference import phase1 as RP
from zkbench.tasks import phase1 as task

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
CELL = "s256-phase1.close-and-prepare"
TINY_LIB = dict(l=6, l_D=22, l_free=4, l_user=2, l_user_out=1, m_D=35, n=16, s_D=5, s_max=8)
SEED = 2**33 + 7
H100 = "NVIDIA H100 80GB HBM3"
METRICS = ("ceremony.p1_contribute_s", "ceremony.p1_check_s", "ceremony.prepare_s",
           "ceremony.prepare_host_s", "ceremony.prepare_g1_device_s",
           "kernels.prepare_g1_roofline_pct")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_cell_and_config_are_declared():
    cell, config, traffic = run.resolve(BENCH, CELL)
    assert cell["chips"] == 1 and config["task"] == "phase1" and config["entry"] == "phase1"
    conf = {c["name"]: c for c in BENCH["configs"]}["s256-phase1"]
    assert conf["reduced"] == [] and config["reduced"] == []
    assert config["library"] == {c["name"]: json.load(open(os.path.join(run.ROOT, c["file"])))
                                 for c in BENCH["configs"]}["s256-ceremony"]["library"]
    assert traffic["samples"] == 16
    for m in BENCH["per_layer"]:
        if m["name"] in METRICS:
            assert m["workloads"] == [CELL]
            metrics_pkg.load(m["name"])
    assert {m["name"] for m in BENCH["per_layer"] if CELL in m.get("workloads", [])} == set(METRICS)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import zkbench.reference.phase1; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'tokamak_zk_evm_tpu', 'tokamak_zk_evm_tpu_torch', 'torch')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def _run(trace_on, control=None):
    cell, config, traffic = run.resolve(BENCH, CELL)
    out = run.run_cell(cell, dict(config, library=TINY_LIB), traffic, SEED, 0.01, trace_on,
                       "cpu", control=control)
    return out, run.result_line(BENCH, cell, out, trace_on, "cpu")


def test_cell_end_to_end_on_the_cpu():
    out, res = _run(False)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"proof_s", "setup_s"}  # no device memory on the CPU
    assert {k: v["value"] for k, v in res["checks"].items()} == dict(
        rejected=0, pok_fail=0, mismatch=0, missing=0, judged=1)
    assert out["forbidden"] == []


def test_cell_traced_on_the_cpu_reads_the_programs_spans():
    out, res = _run(True)
    assert res["correct"], res["checks"]
    # the device readers need a card's kernel names
    assert set(res["metrics"]) == set(METRICS[:4])
    timing = out["trace"]["jobs"][0]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["ceremony.p1_contribute_s"] <= timing["contribute_s"]
    assert got["ceremony.p1_check_s"] <= timing["check_s"]
    assert got["ceremony.prepare_host_s"] <= got["ceremony.prepare_s"] <= timing["prepare_s"]


@pytest.mark.parametrize("mode,flags", [("control", ("rejected", "mismatch")),
                                        ("altered", ("mismatch",))])
def test_each_control_is_not_correct(mode, flags):
    _, res = _run(False, control=task.CONTROLS[mode])
    assert not res["correct"]
    for flag in flags:
        assert res["checks"][flag]["value"] >= 1 > res["checks"][flag]["limit"]
    assert res["checks"]["pok_fail"]["value"] == 0
    if mode == "altered":  # the coordinator never sees the change: the reference alone does
        assert res["checks"]["rejected"]["value"] == 0


def test_roofline_and_device_readers():
    """The least time of the full-size lanes at the card's peaks over B13's
    device seconds, on a hand-made record and counters; nothing without a
    counter or a B13 kernel."""
    from zkbench import program_spans

    roof = metrics_pkg.load("kernels.prepare_g1_roofline_pct")
    dev = metrics_pkg.load("ceremony.prepare_g1_device_s")
    rec = dict(by_name={"g1_add_kernel": 0.3, "void g1_dbl_kernel(int*)": 0.2,
                        "bucket_sum_kernel_affine": 5.0}, kind=H100, proofs=2)
    counts = {(None, "prep.full_scalar_lanes", ()): 1000, (None, "p1.multiplied_points", ()): 20,
              (None, "p1.checked_points", ()): 30, (None, "prep.mul_lanes", ()): 10**9,
              (None, "p2.rescaled_points", ()): 10**9}
    snap = SimpleNamespace(events=[object()], dropped=0, counts=counts)
    mp = pytest.MonkeyPatch()
    mp.setattr(program_spans, "snapshot", lambda: snap)
    try:
        assert dev.read(rec) == pytest.approx(0.25)
        least = metrics_pkg.load("kernels.g1_roofline_pct").least(H100, 1050)
        assert least == pytest.approx(1050 * 124 * 7 * 81 / (64 * 132 * 1.98e9))
        assert roof.read(rec) == pytest.approx(100 * least / 0.5)
        snap.counts = {(None, "p2.rescaled_points", ()): 10**9}
        assert roof.read(rec) is None
        assert roof.read(dict(rec, by_name={})) is None
        assert dev.read(dict(rec, by_name={})) is None
    finally:
        mp.undo()


def test_span_readers(monkeypatch):
    """Each reader on hand-made spans, and None from a program without them."""
    from zkbench import program_spans

    def ev(i, parent, name, t0, t1):
        return SimpleNamespace(id=i, parent=parent, name=name, t0=int(t0 * 1e9), t1=int(t1 * 1e9))

    events = [ev(2, 1, "p1.mul", 0.5, 1.5), ev(1, 0, "p1.contribute", 0, 2),
              ev(4, 3, "p1.subgroup", 2, 2.5), ev(3, 0, "p1.load", 2, 3),
              ev(5, 0, "p1.verify", 3, 4.5),
              ev(8, 7, "sync.field.host", 5.2, 5.3), ev(7, 6, "sync.prep.xy", 5, 5.5),
              ev(6, 10, "prep.xy", 5, 6), ev(9, 10, "sync.prep.done", 7, 8),
              ev(10, 0, "p2.prepare", 5, 9)]
    snap = SimpleNamespace(events=events, dropped=0, counts={})
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    rec = dict(proofs=1, by_name={}, kind=H100)
    got = {name: metrics_pkg.load(name).read(rec) for name in METRICS[:4]}
    assert got == pytest.approx({"ceremony.p1_contribute_s": 2.0, "ceremony.p1_check_s": 2.5,
                                 "ceremony.prepare_s": 4.0, "ceremony.prepare_host_s": 2.5})
    monkeypatch.setattr(program_spans, "snapshot", lambda: None)  # a program without them
    rec["by_name"] = {"g1_add_kernel": 1.0}
    for name in METRICS:
        if name != "ceremony.prepare_g1_device_s":  # the device trace's alone
            assert metrics_pkg.load(name).read(rec) is None, name


def test_jobs_are_seeded_and_distinct():
    cell, config, traffic = run.resolve(BENCH, CELL)
    ctx = run.Ctx(run.ROOT, dict(config, library=TINY_LIB), traffic, SEED, "cpu", None)
    task.shared(ctx)
    a = [task.make_job(ctx, i) for i in range(3)]
    assert a == [task.make_job(ctx, i) for i in range(3)]
    seeds = {j[k] for j in a + [task.warmup_job(ctx)] for k in ("contributor", "coordinator",
                                                                 "beacon")}
    assert len(seeds) == 12
    assert all(j["y"] == RP.beacon(j["beacon"]) for j in a)
    x_len, ax_len = RP.acc_sizes(ctx.lib.params)
    assert (x_len, ax_len) == (31, 18)
    assert len(ctx.acc_samples["x_g1"]) == 16 and max(ctx.acc_samples["x_g1"]) < x_len
    assert all(len(set(r)) == 16 and max(r) < ax_len for r in ctx.acc_samples["alpha_x_g1"])
    other = run.Ctx(run.ROOT, ctx.config, ctx.traffic, SEED + 1, "cpu", None)
    task.shared(other)
    assert task.make_job(other, 0) != a[0] and other.acc_samples != ctx.acc_samples
    assert gen.rng_for(SEED, 10).integers(10) == gen.rng_for(SEED, 10).integers(10)

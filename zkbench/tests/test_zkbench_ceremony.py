"""The ceremony's kind of job (`tasks/ceremony.py`, `entries/ceremony.py`,
`reference/ceremony.py`, `reference/g2.py`) on the CPU at a tiny library:
the plain G2 and the reference against the program, the cell end to end
through `run_cell`, traced and untraced, both controls, a broken chain, and
the reference's isolation from the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from zkbench import gen, run
from zkbench import metrics as metrics_pkg
from zkbench.reference import ceremony as RC
from zkbench.reference import curve as C
from zkbench.reference import g2 as G2
from zkbench.tasks import ceremony as task

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
CELL = "s256-ceremony.phase2-chain"
TINY_LIB = dict(l=6, l_D=22, l_free=4, l_user=2, l_user_out=1, m_D=35, n=16, s_D=5, s_max=8)
SEED = 2**33 + 5
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_g2_arithmetic_and_the_programs_generator():
    from tokamak_zk_evm_tpu_torch.host import curve as HC

    g = G2.G2_GEN
    assert G2.on_curve(g) and g == HC.G2.gen
    assert G2.times(g, C.R) is None and G2.mul(g, C.R + 3) == G2.times(g, 3)
    acc = None
    for k in range(1, 6):
        acc = G2.add(acc, g)
        assert acc == G2.times(g, k) and G2.on_curve(acc)
    assert G2.add(G2.times(g, 2), G2.times(g, C.R - 2)) is None
    k = 0xDEADBEEF12345
    assert G2.mul(g, k) == HC.g2_scalar_mul_affine(g, k)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import zkbench.reference.ceremony, zkbench.reference.g2; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'tokamak_zk_evm_tpu', 'tokamak_zk_evm_tpu_torch', 'torch')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def _ctx():
    cell, config, traffic = run.resolve(BENCH, CELL)
    ctx = run.Ctx(run.ROOT, dict(config, library=TINY_LIB), traffic, SEED, "cpu", None)
    task.shared(ctx)
    return ctx


@pytest.fixture(scope="module")
def chain():
    """The program's entry on a tiny library: the starting CRS, and two jobs
    run one after the other."""
    from zkbench.entries.ceremony import Entry

    ctx = _ctx()
    entry = Entry(ctx)
    entry.setup()
    base = entry.samples(entry.sigma)
    jobs = [task.make_job(ctx, i) for i in range(2)]
    answers = [entry.run_job(entry.prepare(job, i))["proof"] for i, job in enumerate(jobs)]
    return SimpleNamespace(ctx=ctx, base=base, jobs=jobs, answers=answers)


def test_reference_base_is_the_programs_starting_crs(chain):
    ctx = chain.ctx
    assert RC.differing(chain.base, RC.Ceremony(ctx.lib, ctx.tau, ctx.samples).base()) == []
    sizes = RC.family_sizes(ctx.lib.params)
    for name, idx in ctx.samples.items():
        assert len(set(idx)) == len(idx) == min(16, sizes[name]) and max(idx) < sizes[name]


def test_reference_passes_the_programs_chain(chain):
    ctx = chain.ctx
    pairs = [(j["contributor"], a) for j, a in zip(chain.jobs, chain.answers)]
    assert all(a["accepted"] for a in chain.answers)
    assert RC.differing(chain.answers[1]["prev"], chain.answers[0]["cur"]) == []
    flags = RC.Ceremony(ctx.lib, ctx.tau, ctx.samples).judge(pairs)
    assert flags == dict(rejected=0, pok_fail=0, mismatch=0, detail=[])
    # the secrets are the documented draws, in order: a wrong order cannot pass
    s = RC.secrets(chain.jobs[0]["contributor"])
    swapped = dict(s, u=dict(s["u"], gamma=s["u"]["delta"], delta=s["u"]["gamma"]))
    assert RC.Ceremony.pok_fails(swapped, chain.answers[0]["pok"]) == ["gamma", "delta"]


def test_a_broken_chain_is_a_mismatch(chain):
    ctx = chain.ctx
    second = dict(chain.answers[1], prev=chain.answers[0]["prev"])  # built on the wrong CRS
    pairs = [(chain.jobs[0]["contributor"], chain.answers[0]),
             (chain.jobs[1]["contributor"], second)]
    flags = RC.Ceremony(ctx.lib, ctx.tau, ctx.samples).judge(pairs)
    assert flags["mismatch"] >= 1 and flags["pok_fail"] == 0
    unanchored = [(chain.jobs[1]["contributor"], chain.answers[1])]  # job 1 alone: not the base
    assert RC.Ceremony(ctx.lib, ctx.tau, ctx.samples).judge(unanchored)["mismatch"] >= 1


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
    assert {"ceremony.contribute_s", "ceremony.verify_s", "ceremony.hash_s",
            "ceremony.pairing_s"} <= set(res["metrics"])
    timing = out["trace"]["jobs"][0]
    assert res["metrics"]["ceremony.contribute_s"]["value"] <= timing["contribute_s"]
    assert res["metrics"]["ceremony.verify_s"]["value"] <= timing["verify_s"]


@pytest.mark.parametrize("mode,flags", [("control", ("rejected", "mismatch")),
                                        ("altered", ("mismatch",))])
def test_each_control_is_not_correct(mode, flags):
    _, res = _run(False, control=task.CONTROLS[mode])
    assert not res["correct"]
    for flag in flags:
        assert res["checks"][flag]["value"] >= 1 > res["checks"][flag]["limit"]
    if mode == "altered":  # the coordinator never sees the change: the reference alone does
        assert res["checks"]["rejected"]["value"] == 0


def test_g1_roofline_and_device_readers():
    """The rescaling's least time at the card's peaks over B13's device
    seconds, on a hand-made record and counter."""
    roof = metrics_pkg.load("kernels.g1_roofline_pct")
    points = 6_621_681
    least = roof.least(H100, points)
    want = points * 124 * 7 * 81 / (64 * 132 * 1.98e9)  # multiply-add-bound
    assert points * 392 / 3.35e12 < want / 30
    assert least == pytest.approx(want)
    assert roof.least("some other card", points) is None
    by_name = {"g1_add_kernel(int const*, int*)": 0.004, "void g1_dbl_kernel(int*)": 0.006,
               "g1_affine_kernel": 0.001, "bucket_sum_kernel_affine": 0.5, "elementwise": 9.0}
    rec = dict(by_name=by_name, kind=H100, proofs=2)
    dev = metrics_pkg.load("ceremony.g1_device_s")
    assert dev.seconds(rec) == pytest.approx(0.011)
    assert dev.read(rec) == pytest.approx(0.0055)
    assert metrics_pkg.load("ceremony.msm_device_s").read(rec) == pytest.approx(0.25)
    assert metrics_pkg.load("ceremony.g1_device_s").read(dict(rec, by_name={})) is None


def test_g1_roofline_reads_the_rescaled_points(monkeypatch):
    """The share counts the program's `p2.rescaled_points`, whichever kernels
    did the work, and reads nothing where the counter is absent."""
    from zkbench import program_spans

    roof = metrics_pkg.load("kernels.g1_roofline_pct")
    rec = dict(by_name={"g1_add_kernel": 0.3, "g1_dbl_kernel": 0.2}, kind=H100, proofs=1)
    counts = {(None, "p2.rescaled_points", "ceremony"): 1000,
              (None, "g1.dbl_lanes", "ceremony"): 10**9}
    snap = SimpleNamespace(events=[object()], dropped=0, counts=counts)
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    assert roof.read(rec) == pytest.approx(100 * roof.least(H100, 1000) / 0.5)
    snap.counts = {(None, "g1.dbl_lanes", "ceremony"): 10**9}
    assert roof.read(rec) is None


def test_span_readers_read_nothing_from_a_program_without_spans(monkeypatch):
    from zkbench import program_spans

    monkeypatch.setattr(program_spans, "snapshot", lambda: None)
    rec = dict(by_name={"g1_add_kernel": 1.0}, kind=H100, proofs=1)
    for name in ("ceremony.contribute_s", "ceremony.verify_s", "ceremony.hash_s",
                 "ceremony.pairing_s", "kernels.g1_roofline_pct"):
        assert metrics_pkg.load(name).read(rec) is None, name


def test_jobs_are_seeded_and_distinct():
    ctx = _ctx()
    a = [task.make_job(ctx, i) for i in range(3)]
    assert a == [task.make_job(ctx, i) for i in range(3)]
    seeds = {s for j in a + [task.warmup_job(ctx)] for s in (j["contributor"], j["coordinator"])}
    assert len(seeds) == 8
    other = run.Ctx(run.ROOT, ctx.config, ctx.traffic, SEED + 1, "cpu", None)
    task.shared(other)
    assert task.make_job(other, 0) != a[0] and other.samples != ctx.samples
    assert gen.rng_for(SEED, 7).integers(10) == gen.rng_for(SEED, 7).integers(10)

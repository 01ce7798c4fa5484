"""The harness: finding files by name, its arithmetic on fixed inputs, the
isolation check, and each cell end to end at a tiny shape on the CPU (the
program's plain versions), sound and with the timed path broken."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from zkbench import roofline, run, trace
from zkbench import metrics as metrics_pkg
from zkbench.tasks import proof

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
# the published layout at its smallest: four public buffers and one chain kind
TINY_LIB = dict(l=6, l_D=22, l_free=4, l_user=2, l_user_out=1, m_D=35, n=16, s_D=5, s_max=8)
TINY_MIX = dict(placements=[5, 5], heavy_share=[1, 2], judge=2)
H100 = "NVIDIA H100 80GB HBM3"


def test_metric_found_by_name_from_an_added_file(tmp_path, monkeypatch):
    (tmp_path / "new.layer_s.py").write_text("def read(rec):\n    return rec['proofs'] * 2.0\n")
    monkeypatch.setattr(metrics_pkg, "_HERE", str(tmp_path))
    assert metrics_pkg.load("new.layer_s").read({"proofs": 3}) == 6.0
    with pytest.raises(FileNotFoundError):
        metrics_pkg.load("no.such_metric")


def test_config_and_mix_found_by_name_from_added_files(tmp_path):
    (tmp_path / "zkbench" / "traffic").mkdir(parents=True)
    (tmp_path / "zkbench" / "traffic" / "mix-b.json").write_text(json.dumps(TINY_MIX))
    (tmp_path / "conf-a.json").write_text(json.dumps({"entry": "service", "library": TINY_LIB}))
    bench = {"configs": [{"name": "conf-a", "file": "conf-a.json"}],
             "workloads": [{"name": "conf-a.mix-b", "config": "conf-a", "traffic": "mix-b",
                            "chips": 1}]}
    cell, config, traffic = run.resolve(bench, "conf-a.mix-b", root=str(tmp_path))
    assert config["library"] == TINY_LIB and traffic == TINY_MIX
    with pytest.raises(KeyError):
        run.resolve(bench, "conf-a.other", root=str(tmp_path))


def test_roofline_arithmetic():
    b, ops = roofline.msm_least(1 << 22, 1 << 21)
    assert b == 32 * (1 << 22) + 96 * (1 << 21) + 144
    assert ops == (1 << 21) * 11 * 81
    t = roofline.least_seconds(H100, b, ops)
    assert t == pytest.approx(ops / (64 * 132 * 1.98e9)) and t > b / 3.35e12
    b, ops = roofline.ntt_least(16384, 512)
    assert b == 64 * 16384 * 512 and ops == 4096 * 14 * 512 * 36
    assert roofline.least_seconds(H100, b, ops) == pytest.approx(b / 3.35e12)
    assert roofline.least_seconds("some other card", b, ops) is None
    rec = dict(by_name={"void ntt_pass_kernel<3>(int*)": 0.002, "bucket_sum_kernel_affine": 1.0,
                        "elementwise": 5.0},
               ntt=[[16384, 512]], msm=[[1 << 22, 1 << 21]], kind=H100, proofs=2)
    ntt_pct = metrics_pkg.load("kernels.ntt_roofline_pct").read(rec)
    assert ntt_pct == pytest.approx(100 * (64 * 16384 * 512 / 3.35e12) / 0.002)
    assert metrics_pkg.load("ops.ntt_device_s").read(rec) == pytest.approx(0.001)
    assert metrics_pkg.load("ops.msm_device_s").read(rec) == pytest.approx(0.5)
    assert metrics_pkg.load("kernels.msm_roofline_pct").read(dict(rec, kind="cpu")) is None


def test_summarize_window_arithmetic():
    ev = [("k1", 100, 200), ("k2", 150, 300), ("Memcpy HtoD", 500, 600), ("k3", 900, 1000),
          ("k4", 1900, 2100)]
    spans = [("prover.init", 300, 500), ("prover.rounds", 600, 1000)]
    s = trace.summarize(ev, spans, 0, 2000, "harness")
    assert s["busy_s"] == pytest.approx((200 + 100 + 100 + 100) / 1e9)
    assert s["kernels"] == 4
    assert s["by_name"]["k4"] == pytest.approx(100 / 1e9)
    assert s["gaps"][0] == ["harness", pytest.approx(900 / 1e9)]
    assert ["prover.init", pytest.approx(200 / 1e9)] in s["gaps"]
    assert ["prover.rounds", pytest.approx(300 / 1e9)] in s["gaps"]
    rec = dict(window_s=2e-6, busy_s=s["busy_s"], kernels=4, proofs=2)
    assert metrics_pkg.load("device.idle_pct").read(rec) == pytest.approx(75.0)
    assert metrics_pkg.load("device.kernels_per_proof").read(rec) == 2.0


class _Event:
    def __init__(self, name, start, dur, on_device, corr):
        self._v = (name, start, dur, on_device, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._v[4]


def test_the_counters_own_kernels_are_left_out():
    """A kernel whose launch the host made inside an MSM counter is the
    harness's, and no device reading counts it."""
    from types import SimpleNamespace

    events = [_Event("cudaLaunchKernel", 100, 5, False, 1),  # the program's launch
              _Event("cudaLaunchKernel", 210, 5, False, 2),  # the counter's
              _Event("cudaLaunchKernel", 400, 5, False, 3),
              _Event("bucket_sum_kernel", 300, 50, True, 1),
              _Event("reduce_kernel", 360, 10, True, 2),
              _Event("ntt_pass_kernel", 420, 30, True, 3)]
    rec = trace.Recorder("cuda")
    rec.own = [(200, 220)]
    rec.prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert rec.device_events() == [("bucket_sum_kernel", 300, 350),
                                   ("ntt_pass_kernel", 420, 450)]


def test_result_line_and_verdict():
    cell = {c["name"]: c for c in BENCH["workloads"]}["s256-service.full-tx"]
    checks = dict(relation_fail=0, unblinded=0, mismatch=0, layout_fail=0, missing=0, judged=3)
    out = dict(done=[{}] * 4, failed=[], window_s=10.0, peak=2**30, setup_peak=2**31,
               setup_s=20.0, attempted=4, checks=checks, task=proof)
    res = run.result_line(BENCH, cell, out, False, "cpu")
    assert res["correct"] and list(res)[-1] == "checks"
    assert res["metrics"]["proof_s"] == {"value": 2.5, "unit": "s"}
    assert res["metrics"]["peak_device_gib"]["value"] == 1.0
    assert res["device"]["memory_peak_bytes"] == 2**31
    for bad in (dict(checks, unblinded=1), dict(checks, judged=0), dict(checks, missing=1)):
        assert not run.verdict(bad, proof.LIMITS)[0]


def test_isolation_compares_whole_top_level_names():
    names = ["tokamak_zk_evm_tpu_torch", "tokamak_zk_evm_tpu_torch.ops.msm", "jaxtyping",
             "numpy", "flaxen"]
    assert run.forbidden_modules(names) == []
    assert run.forbidden_modules(names + ["jax.numpy", "tokamak_zk_evm_tpu.models"]) == \
        ["jax.numpy", "tokamak_zk_evm_tpu.models"]


def test_harness_loads_no_jax():
    code = ("import sys; import zkbench.run, zkbench.control, zkbench.entries.service, "
            "zkbench.entries.cli, zkbench.entries.cli_child, zkbench.entries.base, "
            "zkbench.isolation, zkbench.trace, zkbench.tasks.proof; "
            "from zkbench import run; bad = run.forbidden_modules(); print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    r = subprocess.run([sys.executable, "-m", "zkbench.run", "--workload", "s256-service.full-tx",
                        "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
                       cwd=run.ROOT, capture_output=True, text=True)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _run(workload, trace_on, control=None):
    cell = {c["name"]: c for c in BENCH["workloads"]}[workload]
    entry = workload.split(".")[0].split("-")[1]
    config = {"entry": entry, "library": TINY_LIB}
    out = run.run_cell(cell, config, TINY_MIX, 2**31 + 99, 0.01, trace_on, "cpu",
                       control=control)
    return out, run.result_line(BENCH, cell, out, trace_on, "cpu")


@pytest.mark.parametrize("workload", ["s256-service.full-tx", "s256-cli.full-tx"])
def test_cell_end_to_end_on_the_cpu(workload):
    out, res = _run(workload, False)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"proof_s", "setup_s"}  # no device memory on the CPU
    assert res["checks"]["judged"]["value"] == 1
    assert out["forbidden"] == [] and len(out["done"]) == 1


def test_a_job_process_that_loads_jax_refuses_the_run(tmp_path, monkeypatch):
    """The CLI cell proves in job processes: a forbidden module that one of
    them holds refuses the run, though this process never loads it."""
    (tmp_path / "sitecustomize.py").write_text(
        "import sys, types\nsys.modules['jax'] = types.ModuleType('jax')\n")
    path = [str(tmp_path), run.ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
        os.pathsep) if p]
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(path))
    out, _ = _run("s256-cli.full-tx", False)
    assert out["forbidden"] == ["jax"]
    assert "jax" in run.refused(out) and "jax" not in run.forbidden_modules()


def test_service_traced_on_the_cpu():
    out, res = _run("s256-service.full-tx", True)
    assert res["correct"]
    assert {"prover.init_s", "prover.rounds_s", "device.idle_pct"} <= set(res["metrics"])
    assert out["trace"]["ntt"] and out["trace"]["msm"]
    assert res["breakdown"]["device_ops"] and "busy_s" in res["device"]


@pytest.mark.parametrize("workload,mode,flag", [
    ("s256-service.full-tx", "control", "unblinded"),
    ("s256-service.full-tx", "altered", "relation_fail"),
    ("s256-cli.full-tx", "control", "unblinded"),
    ("s256-cli.full-tx", "altered", "relation_fail"),
])
def test_broken_timed_path_is_not_correct(workload, mode, flag):
    from zkbench.tasks.proof import CONTROLS as MODES

    out, res = _run(workload, False, control=MODES[mode])
    assert not res["correct"]
    assert res["checks"][flag]["value"] >= 1 > res["checks"][flag]["limit"]


def test_a_job_that_never_comes_is_not_correct(monkeypatch):
    from zkbench.entries import service

    real = service.Entry.run_job
    calls = []

    def lost(self, item):
        calls.append(1)
        if len(calls) == 3:  # the window's first job; the warm-up job is proved twice first
            raise RuntimeError("the prover died")
        return real(self, item)

    monkeypatch.setattr(service.Entry, "run_job", lost)
    cell = {c["name"]: c for c in BENCH["workloads"]}["s256-service.full-tx"]
    out = run.run_cell(cell, {"entry": "service", "library": TINY_LIB}, TINY_MIX, 7, 0.01,
                       False, "cpu")
    res = run.result_line(BENCH, cell, out, False, "cpu")
    assert not res["correct"] and res["failed"] == 1
    assert res["checks"]["missing"]["value"] == 1

"""The port's scaling report (`tokamak_zk_evm_tpu_torch/utils/scaling_report.py`)
on spawned gloo ranks on the CPU.

* Two and four ranks run it at a 64 x 16 grid and a 2^8-point MSM: its
  rows have the JAX report's keys (read from the committed
  `scaling_report.json`) and its own `sharded`, one row for the unsharded
  op and one for each mesh of 1, 2 and 4 ranks, and the dist calls ran.
  Each sharded row's output was held to the unsharded op (`bintt`, and its
  inverse back to the grid) and each MSM's to the oracle (sum k_i c_i) G
  inside the report, which raises on a mismatch; a wrong `bintt_dist` or
  `msm_dist` on a one-rank group here shows that it does.
* The command line writes the report to `--out`, prints it, and leaves the
  root `scaling_report.json` byte for byte as it was (that it raises
  without a card is held in `test_torch_isolation.py`).
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from tokamak_zk_evm_tpu_torch.utils import scaling_report as SR

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIZES = dict(x_size=64, y_size=16, msm_log2=8)


@pytest.fixture(scope="module")
def reports():
    """{world: report}, each world spawned once, on first use."""
    done = {}

    def get(world):
        if world not in done:
            done[world] = SR.run_cpu_ranks(world, timeout=600, **SIZES)
        return done[world]

    return get


def _jax_row_keys():
    with open(ROOT / "scaling_report.json") as f:
        jax = json.load(f)
    return jax, {r["n_devices"] > 1: set(r) for r in jax["rows"]}


@pytest.mark.parametrize("world", [2, 4])
def test_rows_have_the_jax_report_s_form(reports, world):
    jax, keys = _jax_row_keys()
    rep = reports(world)
    assert set(jax) - {"rows"} <= set(rep)
    assert rep["platform"] == "cpu" and rep["device"] == "cpu" and rep["backend"] == "gloo"
    assert rep["world"] == world
    for row in rep["rows"]:
        assert set(row) == keys[row["n_devices"] > 1] | {"sharded"}
        assert row["seconds"] > 0 and row["efficiency"] > 0


@pytest.mark.parametrize("world", [2, 4])
def test_a_row_per_op_and_mesh_size(reports, world):
    rep = reports(world)
    want = []
    for op in ("bintt_64x16", "msm_2^8"):
        want.append((op, 1, False))
        want += [(op, n, True) for n in (1, 2, 4) if n <= world]
    assert [(r["op"], r["n_devices"], r["sharded"]) for r in rep["rows"]] == want
    for r in rep["rows"]:
        if not r["sharded"]:
            assert r["efficiency"] == 1.0
        if r["n_devices"] > 1:
            cap = min(r["n_devices"], os.cpu_count()) / r["n_devices"]
            assert r["efficiency_vs_host_ceiling"] == pytest.approx(r["efficiency"] / cap)


@pytest.mark.parametrize("world", [2, 4])
def test_the_sharded_ops_ran_on_every_mesh(reports, world):
    calls = reports(world)["dist_calls"]
    meshes = len([n for n in (1, 2, 4) if n <= world])
    # bintt_dist: an untimed call, three timed and one inverse a mesh; msm_dist two
    assert calls["bintt_dist"] == 5 * meshes
    assert calls["msm_dist"] == 2 * meshes


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_a_wrong_bintt_dist_raises(one_rank, monkeypatch):
    from tokamak_zk_evm_tpu_torch.parallel import ntt_dist

    real = ntt_dist.bintt_dist

    def off_by_one(rows, mesh, inverse=False):
        out = real(rows, mesh, inverse)
        out[0, 0, 0] ^= 1
        return out

    monkeypatch.setattr(ntt_dist, "bintt_dist", off_by_one)
    with pytest.raises(RuntimeError, match="!= bintt"):
        SR.measure(x_size=8, y_size=4, msm_log2=2, device="cpu", iters=1)


def test_a_wrong_inverse_bintt_dist_raises(one_rank, monkeypatch):
    from tokamak_zk_evm_tpu_torch.parallel import ntt_dist

    real = ntt_dist.bintt_dist

    def wrong_inverse(rows, mesh, inverse=False):
        return real(rows, mesh, False)

    monkeypatch.setattr(ntt_dist, "bintt_dist", wrong_inverse)
    with pytest.raises(RuntimeError, match="inverse bintt_dist"):
        SR.measure(x_size=8, y_size=4, msm_log2=2, device="cpu", iters=1)


def test_a_wrong_msm_dist_raises(one_rank, monkeypatch):
    from tokamak_zk_evm_tpu_torch.host.curve import G1
    from tokamak_zk_evm_tpu_torch.parallel import msm_dist

    monkeypatch.setattr(msm_dist, "msm_dist", lambda *a: G1.gen)
    with pytest.raises(RuntimeError, match="msm_dist on 1 rank"):
        SR.measure(x_size=8, y_size=4, msm_log2=4, device="cpu", iters=1)


def test_cli_writes_its_out_path_only(tmp_path):
    root_report = (ROOT / "scaling_report.json").read_bytes()
    out = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT), SCALE_PLATFORM="cpu", VIRT_DEVICES="2",
               SCALE_MSM_LOG2="4", OMP_NUM_THREADS="1")
    # the grid narrowed through run_cpu_ranks' arguments: the CLI's is the prover's 2^23
    code = ("import functools, sys\n"
            "for m in ('jax', 'jaxlib', 'tokamak_zk_evm_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from tokamak_zk_evm_tpu_torch.utils import scaling_report as SR\n"
            "SR.run_cpu_ranks = functools.partial(SR.run_cpu_ranks, x_size=16, y_size=8)\n"
            "sys.exit(SR.main(sys.argv[1:]))\n")
    res = subprocess.run([sys.executable, "-c", code, "--out", str(out)], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    printed = json.loads(res.stdout.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == printed
    assert [r["op"] for r in printed["rows"]][::3] == ["bintt_16x8", "msm_2^4"]
    assert (ROOT / "scaling_report.json").read_bytes() == root_report
    assert SR.DEFAULT_OUT == str(ROOT / ".cache" / "torch_scaling_report.json")

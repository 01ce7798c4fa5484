"""The port's bench (`tokamak_zk_evm_tpu_torch/bench.py`) against the
repository's `bench.py`, on the CPU.

* Its mid and small rungs, BASELINE_CUDA_S and the metric name of every
  rung are `bench.py`'s (read by import and from its AST; its top level
  imports no JAX), the full rung is `build_synthetic()` at its defaults,
  and the small rung's fixture is the JAX bench's.
* One rung through the bench's own code (`TOKAMAK_BENCH_DEVICE=cpu`,
  `TOKAMAK_BENCH_VERIFY=1`, `TOKAMAK_BENCH_WARMUP=0`, the cache under
  `tmp_path`) in a subprocess with `jax` blocked.  The rung's shape is
  swapped for the toy fixture (`testing/fixtures.build_fixture()`): the
  small rung takes minutes on the CPU's plain versions (its setup ~51 s,
  init ~21 s, a prove past 220 s), the toy ~25 s.  The printed line has
  the five keys, the prover's span categories, "cpu" for the device, no
  peak device memory, no kernel launch (the CPU takes the plain
  versions), its CPU seconds, and the digest of the toy's `Mixer.zero()`
  proof (`GOLDEN_PROOF_SHA256`); a second call on the same cache loads
  the CRS and prints the same digest.
* The per-op probes at 2^8 points and a 16 x 8 grid, held to the oracle;
  a wrong MSM raises.
* The ladder's order and banking, with each rung's process stubbed.
* Without a card and without a device named the bench raises;
  `TOKAMAK_BENCH_SCALE=real` with no library exits non-zero with the
  library resolver's error.
* The port's cache and warm-marker paths are not the JAX bench's, and the
  marker's digest covers the kernels' CUDA sources.
"""

import ast
import importlib.util
import inspect
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from tokamak_zk_evm_tpu_torch import bench as B
from tokamak_zk_evm_tpu_torch.backend import kernels as K
from tokamak_zk_evm_tpu_torch.testing.fixtures import GOLDEN_PROOF_SHA256
from tokamak_zk_evm_tpu_torch.testing.synthetic import build_synthetic

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}

_TOY_RUNG = r"""
import sys
for m in ("jax", "jaxlib", "tokamak_zk_evm_tpu"):
    sys.modules[m] = None
from tokamak_zk_evm_tpu_torch import bench
from tokamak_zk_evm_tpu_torch.testing.fixtures import build_fixture
fx = build_fixture()
bench.SHAPES["small"] = dict(kind="synthetic", n=fx.params.n, s_max=fx.params.s_max)
bench.build_shape = lambda scale: fx
bench.main()
assert not any(m == "jax" or m.startswith(("jax.", "tokamak_zk_evm_tpu."))
               for m, v in sys.modules.items() if v is not None)
"""


def _jax_bench():
    spec = importlib.util.spec_from_file_location("repo_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TOKAMAK_BENCH_") and k != "TZK_SUBCIRCUIT_LIBRARY"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **extra)
    return env


def _run(args, env, timeout=300):
    return subprocess.run([sys.executable] + args, cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=timeout)


# -- bench.py's names -------------------------------------------------------


def test_rungs_and_baseline_are_bench_py_s():
    jb = _jax_bench()
    for scale in ("mid", "small"):
        assert B.SHAPES[scale] == jb.SHAPES[scale]
    assert B.BASELINE_CUDA_S == jb.BASELINE_CUDA_S == 21.082
    assert B.SHAPES["real"] == jb.SHAPES["full"]
    assert B.LADDER == ("small", "mid", "full")
    defaults = {k: p.default for k, p in inspect.signature(build_synthetic).parameters.items()}
    assert {k: v for k, v in B.SHAPES["full"].items() if k != "kind"} == defaults


def test_metric_names_follow_bench_py():
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name == "main")
    lib = next(n.value for n in ast.walk(main) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "lib")
    metric = next(v for n in ast.walk(main) if isinstance(n, ast.Dict)
                  for k, v in zip(n.keys, n.values)
                  if isinstance(k, ast.Constant) and k.value == "metric")
    names = {}
    for scale, shape in B.SHAPES.items():
        env = {"scale": scale, "shape": shape}
        env["lib"] = eval(compile(ast.Expression(lib), "bench.py", "eval"), {}, env)
        want = eval(compile(ast.Expression(metric), "bench.py", "eval"), {}, env)
        assert B.metric_name(scale, shape) == want
        names[scale] = want
    assert names["full"] == "prove_wall_clock_full_synthetic_n4096_smax256"
    assert names["real"] == "prove_wall_clock_real_real_library_n4096_smax256"


def test_small_rung_fixture_is_the_jax_bench_s():
    jfx, tfx = _jax_bench().build_shape("small"), B.build_shape("small")
    assert vars(tfx.params) == vars(jfx.params)
    assert [p.variables for p in tfx.placements] == [p.variables for p in jfx.placements]
    assert repr(tfx.permutation) == repr(jfx.permutation)


# -- one rung on the CPU ------------------------------------------------------


@pytest.fixture(scope="module")
def toy_lines(tmp_path_factory):
    """The toy rung's line, twice on one cache root."""
    env = _env(TOKAMAK_BENCH_DEVICE="cpu", TOKAMAK_BENCH_VERIFY="1", TOKAMAK_BENCH_WARMUP="0",
               TOKAMAK_BENCH_SCALE="small",
               TOKAMAK_BENCH_CACHE=str(tmp_path_factory.mktemp("bench_cache")))
    lines = []
    for _ in range(2):
        out = _run(["-c", _TOY_RUNG], env)
        assert out.returncode == 0, out.stderr[-3000:]
        lines.append(out.stdout.strip().splitlines())
    return lines


def test_rung_prints_one_line_of_bench_py_s_form(toy_lines):
    for out in toy_lines:
        assert len(out) == 1
        line = json.loads(out[0])
        assert set(line) == KEYS
        assert line["metric"] == "prove_wall_clock_small_synthetic_n8_smax4"
        assert line["unit"] == "s" and line["value"] > 0 and line["vs_baseline"] == 0.0


def test_rung_detail_on_the_cpu(toy_lines):
    d = json.loads(toy_lines[0][0])["detail"]
    assert set(d["spans"]) == {"build", "encode", "prove"}
    assert all(v > 0 for v in d["spans"].values())
    assert d["device"] == "cpu"
    assert "peak_device_memory_bytes" not in d
    assert d["launches"] == dict.fromkeys(K.counts(), 0)  # the CPU takes the plain versions
    assert d["host_usage"]["user_s"] + d["host_usage"]["sys_s"] > 0
    assert set(d["host_usage"]) == set(B.host_usage())
    assert d["verify_snark"] is True
    assert d["proof_sha256"] == GOLDEN_PROOF_SHA256
    assert "crs_load_s" not in d
    assert not any(k.startswith(("msm_", "bintt_", "scaling")) for k in d)  # small: no probes


def test_second_call_loads_the_cached_crs(toy_lines):
    d = json.loads(toy_lines[1][0])["detail"]
    assert d["crs_load_s"] >= 0
    assert d["proof_sha256"] == GOLDEN_PROOF_SHA256
    assert d["verify_snark"] is True


# -- the per-op probes --------------------------------------------------------


def test_per_op_probes_meet_the_oracle(tmp_path, monkeypatch):
    from tokamak_zk_evm_tpu_torch.utils import scaling_report as SR

    report = tmp_path / "report.json"
    report.write_text(json.dumps({"rows": [{"op": "x", "n_devices": 1}]}))
    monkeypatch.setattr(SR, "DEFAULT_OUT", str(report))
    d = B.measure_per_op(torch.device("cpu"), msm_log2=8, grid=(16, 8))
    assert d["msm_2p8_oracle"] is True and d["msm_2p8_s"] > 0 and d["bintt_2p7_s"] > 0
    s = d["scaling"]
    assert s["msm_2p8_points_per_s"] > 0 and s["bintt_2p7_butterflies_per_s"] > 0
    assert s["mesh_efficiency"] == json.loads(report.read_text())
    assert set(d) == {"msm_2p8_s", "msm_2p8_oracle", "bintt_2p7_s", "scaling"}


def test_per_op_probe_raises_on_a_wrong_msm(tmp_path, monkeypatch):
    from tokamak_zk_evm_tpu_torch.ops import msm as TM
    from tokamak_zk_evm_tpu_torch.utils import scaling_report as SR

    monkeypatch.setattr(SR, "DEFAULT_OUT", str(tmp_path / "none.json"))
    monkeypatch.setattr(TM, "msm", lambda *a: None)
    with pytest.raises(RuntimeError, match="MSM of 2\\^4 points"):
        B.measure_per_op(torch.device("cpu"), msm_log2=4, grid=(4, 4))


# -- the ladder ---------------------------------------------------------------


def _stub_rungs(monkeypatch, failing=()):
    ran = []

    def run(argv, **kw):
        scale = kw["env"]["TOKAMAK_BENCH_SCALE"]
        ran.append(scale)
        assert argv[1:] == ["-m", "tokamak_zk_evm_tpu_torch.bench"]
        out = f'diagnostic\n{{"metric": "{scale}"}}\n'.encode()
        return subprocess.CompletedProcess(argv, 1 if scale in failing else 0, out)

    monkeypatch.setattr(B.subprocess, "run", run)
    return ran


@pytest.mark.parametrize("warm", [False, True])
def test_ladder_banks_each_rung_as_it_ends(warm, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TOKAMAK_BENCH_CACHE", str(tmp_path))
    if warm:
        B.mark_full_warm()
    ran = _stub_rungs(monkeypatch, failing=("mid",))
    assert B.run_ladder() == 0
    banked = [json.loads(ln)["metric"] for ln in capsys.readouterr().out.splitlines()]
    assert ran == (["full"] if warm else ["small", "mid", "full"])
    assert banked == (["full"] if warm else ["small", "full"])


def test_ladder_fails_when_no_rung_banks(tmp_path, monkeypatch):
    monkeypatch.setenv("TOKAMAK_BENCH_CACHE", str(tmp_path))
    _stub_rungs(monkeypatch, failing=B.LADDER)
    assert B.run_ladder() == 1


# -- failures -----------------------------------------------------------------


@pytest.mark.parametrize("scale", [None, "small"])
def test_no_card_and_no_device_raises(scale):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    env = _env(**({"TOKAMAK_BENCH_SCALE": scale} if scale else {}))
    out = _run(["-m", "tokamak_zk_evm_tpu_torch.bench"], env, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert out.stdout == ""


def test_real_rung_without_a_library_exits_with_the_resolver_s_error(tmp_path):
    env = _env(TOKAMAK_BENCH_DEVICE="cpu", TOKAMAK_BENCH_SCALE="real",
               TOKAMAK_BENCH_CACHE=str(tmp_path))
    out = _run(["-m", "tokamak_zk_evm_tpu_torch.bench"], env, timeout=120)
    assert out.returncode != 0
    assert "--library is required" in out.stderr
    assert out.stdout == ""


# -- caches -------------------------------------------------------------------


def test_cache_and_marker_paths_are_not_the_jax_bench_s(tmp_path, monkeypatch):
    jb = _jax_bench()
    monkeypatch.delenv("TOKAMAK_BENCH_CACHE", raising=False)
    jax_cache = pathlib.Path(jb._REPO) / ".cache"
    port = [B.warm_marker(), B.fixture_path(256)] + [B.crs_dir(s) for s in B.SHAPES]
    jax = [jb.WARM_MARKER, str(jax_cache / "fixture_real_256.pkl")] + [
        str(jax_cache / f"crs_{s}_{sh['kind']}_{sh['n']}_{sh['s_max']}")
        for s, sh in jb.SHAPES.items()]
    root = ROOT / ".cache" / "torch_bench"
    for p in port:
        assert pathlib.Path(p).parent == root
        assert p not in jax
    monkeypatch.setenv("TOKAMAK_BENCH_CACHE", str(tmp_path))
    assert all(pathlib.Path(p).parent == tmp_path
               for p in [B.warm_marker(), B.fixture_path(256), B.crs_dir("full")])


def test_warm_marker_digest_covers_the_cuda_sources(tmp_path, monkeypatch):
    pkg = tmp_path / "pkg"
    src = pathlib.Path(B.__file__).parent
    shutil.copytree(src, pkg, ignore=shutil.ignore_patterns("build", "__pycache__"))
    monkeypatch.setattr(B, "_PKG", str(pkg))
    base = B.code_state_digest()
    cu = next((pkg / "backend" / "csrc").glob("*.cu"))
    cu.write_text(cu.read_text() + "\n")
    edited = B.code_state_digest()
    assert edited != base
    (pkg / "frontend" / "merkle.py").write_text("# edited\n")
    assert B.code_state_digest() == edited

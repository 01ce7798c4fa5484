"""The port stands alone: no JAX, no JAX package, no silent CPU fallback.

* a subprocess blocks `jax` (and the JAX package) in `sys.modules`, imports
  the port (the multi-device modules too) and proves the toy fixture on
  the CPU, reproducing the golden digest;
* no file of the port and not `chip_smoke.py` names `jax` or
  `tokamak_zk_evm_tpu` in an import;
* the entry points (and the CRS loaders, the ceremony's steps, the CLI
  and `parallel.multihost.init_from_env`) raise without a CUDA device
  unless given device="cpu";
* the port's copies of the JAX-free host modules agree with the originals,
  the I/O ones (`io/artifacts.py`, `io/rkyv_oracle.py`,
  `io/subcircuit_library.py`) file for file on the toy fixture.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

# The plain versions issue many small ops; one intra-op thread per test
# process keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "tokamak_zk_evm_tpu_torch"

_PROVE = r"""
import hashlib, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["tokamak_zk_evm_tpu"] = None
from tokamak_zk_evm_tpu_torch.io.artifacts import canonical_proof_bytes
from tokamak_zk_evm_tpu_torch.models.protocol import Mixer
from tokamak_zk_evm_tpu_torch.models.prover import Prover
from tokamak_zk_evm_tpu_torch.models.setup import Tau, generate_sigma
from tokamak_zk_evm_tpu_torch.testing.fixtures import GOLDEN_PROOF_SHA256, build_fixture
fx = build_fixture()
sigma = generate_sigma(fx.params, Tau.fixed(), fx.library, fx.infos, device="cpu")
proof, _ = Prover(fx.params, sigma, fx.library, fx.infos, fx.placements, fx.permutation,
                  fx.instance, mixer=Mixer.zero(), device="cpu").prove()
assert hashlib.sha256(canonical_proof_bytes(proof)).hexdigest() == GOLDEN_PROOF_SHA256
from tokamak_zk_evm_tpu_torch.models import dusk_pot, mpc_setup
from tokamak_zk_evm_tpu_torch.parallel import context, mesh, msm_dist, multihost, ntt_dist
acc = mpc_setup.Phase1Accumulator.initial(fx.params)
acc1, proof = acc.compute(__import__("numpy").random.default_rng(0), "cpu")
assert mpc_setup.Phase1Proof.from_json(proof.to_json(), "cpu") == proof
assert dusk_pot.g1_from_bytes(dusk_pot.g1_to_bytes(acc1.x_g1[0], True), True) == acc1.x_g1[0]
assert not any(m == "jax" or m.startswith(("jax.", "tokamak_zk_evm_tpu."))
               for m, v in sys.modules.items() if v is not None)
print("PROVED-WITHOUT-JAX")
"""


def test_port_proves_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _PROVE], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PROVED-WITHOUT-JAX" in out.stdout


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_no_jax_imports(path):
    bad = [m for m in _imports(ROOT / path)
           if m == "jax" or m.startswith("jax.") or m == "jaxlib"
           or m == "tokamak_zk_evm_tpu" or m.startswith("tokamak_zk_evm_tpu.")]
    assert not bad, f"{path} imports {bad}"


def _entry_points():
    from tokamak_zk_evm_tpu_torch.models.preprocess import preprocess
    from tokamak_zk_evm_tpu_torch.models.prover import Prover
    from tokamak_zk_evm_tpu_torch.models.setup import Tau, generate_sigma
    from tokamak_zk_evm_tpu_torch.models.verifier import Verifier
    from tokamak_zk_evm_tpu_torch.testing.fixtures import build_fixture

    from tokamak_zk_evm_tpu_torch.cli import main
    from tokamak_zk_evm_tpu_torch.io import crs, rkyv_crs
    from tokamak_zk_evm_tpu_torch.models import mpc_setup as M

    fx = build_fixture()
    acc = M.Phase1Accumulator.initial(fx.params)
    return {
        "phase1_compute": lambda: acc.compute(np.random.default_rng(0)),
        "phase1_verify": lambda: acc.verify(acc, None),
        "phase1_from_json": lambda: M.Phase1Accumulator.from_json(acc.to_json()),
        "phase2_prepare": lambda: M.phase2_prepare(acc, 5, fx.params, fx.library, fx.infos),
        "cli_mpc": lambda: main(["mpc", "phase1-init", "--library", "x", "--output", "y"]),
        "generate_sigma": lambda: generate_sigma(fx.params, Tau.fixed(), fx.library, fx.infos),
        "Prover": lambda: Prover(fx.params, None, fx.library, fx.infos, fx.placements,
                                 fx.permutation, fx.instance),
        "preprocess": lambda: preprocess(None, fx.permutation, fx.instance, fx.params),
        "Verifier": lambda: Verifier(fx.params, None, None, fx.instance, None),
        "load_sigma": lambda: crs.load_sigma("no-such-dir"),
        "read_combined_sigma": lambda: rkyv_crs.read_combined_sigma("no-such-file", fx.params),
        "cli": lambda: main(["doctor"]),
        "init_from_env": _init_from_env,
    }


def _init_from_env():
    """`multihost.init_from_env` with a two-process group named in the
    environment: it must raise for the missing card before joining."""
    from tokamak_zk_evm_tpu_torch.parallel import multihost

    saved = {k: os.environ.get(k) for k in ("TZK_COORDINATOR", "TZK_NUM_PROCESSES",
                                            "TZK_PROCESS_ID")}
    os.environ.update(TZK_COORDINATOR="localhost:1", TZK_NUM_PROCESSES="2", TZK_PROCESS_ID="0")
    try:
        multihost.init_from_env()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("name", ["generate_sigma", "Prover", "preprocess", "Verifier",
                                  "load_sigma", "read_combined_sigma", "cli",
                                  "phase1_compute", "phase1_verify", "phase1_from_json",
                                  "phase2_prepare", "cli_mpc", "init_from_env"])
def test_entry_points_need_cuda_or_cpu_argument(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_host_copies_match_originals():
    from tokamak_zk_evm_tpu import fields as JFd
    from tokamak_zk_evm_tpu.host import keccak as JK
    from tokamak_zk_evm_tpu.host.curve import G1 as JG1, G2 as JG2
    from tokamak_zk_evm_tpu.models.transcript import RollingKeccakTranscript as JT
    from tokamak_zk_evm_tpu_torch import fields as TFd
    from tokamak_zk_evm_tpu_torch.host import keccak as TK
    from tokamak_zk_evm_tpu_torch.host.curve import G1 as TG1, G2 as TG2
    from tokamak_zk_evm_tpu_torch.models.transcript import RollingKeccakTranscript as TT

    for name in ("R_MOD", "Q_MOD", "TAU_FIXED", "FIXED_G1_GEN", "FIXED_G2_GEN"):
        assert getattr(TFd, name) == getattr(JFd, name)
    rng = np.random.default_rng(9)
    for n in (0, 1, 135, 136, 137, 300):
        data = rng.bytes(n)
        assert TK.keccak256(data) == JK.keccak256(data) == TK._keccak256_py(data)
    jt, tt = JT(), TT()
    for v in (3, 2**200 + 5):
        jt.commit_fr(v)
        tt.commit_fr(v)
    jt.commit_g1(JG1.gen)
    tt.commit_g1(TG1.gen)
    assert [tt.get_challenge() for _ in range(3)] == [jt.get_challenge() for _ in range(3)]
    k = 0x1234567890ABCDEF
    assert TG1.to_affine(TG1.scalar_mul(TG1.from_affine(TG1.gen), k)) == \
        JG1.to_affine(JG1.scalar_mul(JG1.from_affine(JG1.gen), k))
    assert TG2.to_affine(TG2.scalar_mul(TG2.from_affine(TG2.gen), k)) == \
        JG2.to_affine(JG2.scalar_mul(JG2.from_affine(JG2.gen), k))


def test_pairing_copy_matches_original():
    from tokamak_zk_evm_tpu.host.pairing import multi_pairing as j_mp
    from tokamak_zk_evm_tpu_torch.host.curve import G1, G2
    from tokamak_zk_evm_tpu_torch.host.pairing import multi_pairing as t_mp

    p = G1.to_affine(G1.scalar_mul(G1.from_affine(G1.gen), 5))
    q = G2.to_affine(G2.scalar_mul(G2.from_affine(G2.gen), 7))
    assert t_mp([p, G1.gen], [G2.gen, q]) == j_mp([p, G1.gen], [G2.gen, q])


def test_io_copies_match_originals(tmp_path, monkeypatch):
    """The copied I/O functions give the originals' values and write their
    bytes: hex parsing, the library dir (setup params, subcircuit infos,
    binary R1CS), the synthesizer's three JSONs, the Solidity proof and
    preprocess files, proof4_test.json, sigma_verify.json, the rkyv
    oracle's payload, and library resolution."""
    from tokamak_zk_evm_tpu.io import artifacts as JA
    from tokamak_zk_evm_tpu.io import rkyv_oracle as JO
    from tokamak_zk_evm_tpu.io import subcircuit_library as JL
    from tokamak_zk_evm_tpu.testing.fixtures import build_fixture as j_build_fixture
    from tokamak_zk_evm_tpu_torch.io import artifacts as TA
    from tokamak_zk_evm_tpu_torch.io import rkyv_crs as TR
    from tokamak_zk_evm_tpu_torch.io import rkyv_oracle as TO
    from tokamak_zk_evm_tpu_torch.io import subcircuit_library as TL
    from tokamak_zk_evm_tpu_torch.models.protocol import PreprocessResult, Proof4Test
    from tokamak_zk_evm_tpu_torch.models.setup import Tau, generate_sigma
    from tokamak_zk_evm_tpu_torch.testing.fixtures import build_fixture

    for h in ("0xf", "f", "0x0", "0x10", "", "0X1234abcd", "abc"):
        assert TA.parse_hex(h) == JA.parse_hex(h)
    fx, jfx = build_fixture(), j_build_fixture()

    def tree(d):
        return {os.path.relpath(os.path.join(r, f), d): open(os.path.join(r, f), "rb").read()
                for r, _, fs in os.walk(d) for f in fs}

    def write(mod, fixture, d):
        os.makedirs(d)
        mod.save_library(os.path.join(d, "lib"), fixture.params, fixture.infos, fixture.library)
        mod.save_placement_variables(fixture.placements, os.path.join(d, "pv.json"))
        mod.save_instance(fixture.instance, os.path.join(d, "instance.json"))
        mod.save_permutation(fixture.permutation, os.path.join(d, "perm.json"))
        return tree(d)

    assert write(TA, fx, str(tmp_path / "t")) == write(JA, jfx, str(tmp_path / "j"))
    lib = str(tmp_path / "j" / "lib")
    tp, ti, tl = TA.load_library(lib)
    jp, ji, jl = JA.load_library(lib)
    assert (vars(tp), [vars(i) for i in ti]) == (vars(jp), [vars(i) for i in ji])
    assert [(r.A_cols, r.B_cols, r.C_cols) for r in tl] == \
        [(r.A_cols, r.B_cols, r.C_cols) for r in jl]
    r1cs = os.path.join(lib, "r1cs", "subcircuit0.r1cs")
    assert TA.parse_r1cs(r1cs)[1] == JA.parse_r1cs(r1cs)[1]
    for name, loader in (("pv.json", "load_placement_variables"), ("instance.json", "load_instance"),
                         ("perm.json", "load_permutation")):
        p = str(tmp_path / "j" / name)
        got, want = getattr(TA, loader)(p), getattr(JA, loader)(p)
        assert repr(got) == repr(want)

    sigma = generate_sigma(fx.params, Tau.fixed(), fx.library, fx.infos, device="cpu")
    pts = [sigma.G, sigma.sigma_1.x, sigma.sigma_1.y, None]
    pre = PreprocessResult(s0=pts[0], s1=pts[1], O_pub_fix=pts[3])
    assert TA.preprocess_to_solidity(pre) == JA.preprocess_to_solidity(pre)
    d = TA.preprocess_to_solidity(pre)
    assert repr(TA.preprocess_from_solidity(d)) == repr(JA.preprocess_from_solidity(d))
    p4t = Proof4Test(**{n: pts[i % 4] for i, n in enumerate(TA._P4T_FIELDS)})
    for mod, tag in ((TA, "t"), (JA, "j")):
        mod.save_proof4test(p4t, str(tmp_path / f"{tag}_p4t.json"))
        mod.save_sigma_verify(sigma, str(tmp_path / f"{tag}_sv.json"))
    for f in ("p4t", "sv"):
        assert (tmp_path / f"t_{f}.json").read_bytes() == (tmp_path / f"j_{f}.json").read_bytes()
    assert repr(TA.load_proof4test(str(tmp_path / "j_p4t.json"))) == \
        repr(JA.load_proof4test(str(tmp_path / "j_p4t.json")))
    tsv = TA.load_sigma_verify(str(tmp_path / "j_sv.json"))
    jsv = JA.load_sigma_verify(str(tmp_path / "j_sv.json"))
    assert (tsv.G, tsv.H, tsv.lagrange_KL, tsv.sigma_1.x, tsv.sigma_1.y, vars(tsv.sigma_2)) == \
        (jsv.G, jsv.H, jsv.lagrange_KL, jsv.sigma_1.x, jsv.sigma_1.y, vars(jsv.sigma_2))

    path = str(tmp_path / "combined_sigma.rkyv")
    TR.write_combined_sigma(sigma, fx.params, path)
    buf = open(path, "rb").read()
    assert TO.decode_combined_sigma(buf) == JO.decode_combined_sigma(buf)
    assert TO.parse_payload(TO.decode_combined_sigma(buf)) == \
        JO.parse_payload(JO.decode_combined_sigma(buf))
    assert (TO.G1, TO.G2, TO.SIGMA1_SIZE, TO.SIGMA_SIZE) == (JO.G1, JO.G2, JO.SIGMA1_SIZE,
                                                            JO.SIGMA_SIZE)

    assert TL.resolve_library_path(lib) == JL.resolve_library_path(lib)
    monkeypatch.setenv("TZK_SUBCIRCUIT_LIBRARY", lib)
    assert TL.resolve_library_path(None) == JL.resolve_library_path(None)
    monkeypatch.delenv("TZK_SUBCIRCUIT_LIBRARY")
    assert TL.embedded_library_path() is None and JL.embedded_library_path() is None
    with pytest.raises(FileNotFoundError):
        TL.resolve_library_path(str(tmp_path))

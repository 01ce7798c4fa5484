"""The port's CLI (`python -m tokamak_zk_evm_tpu_torch`) against the JAX CLI.

Mirrors `tests/test_cli.py`'s toy-fixture flows but the MPC one: library
round trip, setup -> preprocess -> prove -> verify through files, a
tampered proof, doctor, library resolution, the `sigma_verify.json` round
trip and the proof bundle.  Then the two packages side by side on one staged
toy dir: every file the port's CLI writes (`combined_sigma.rkyv`,
`sigma_preprocess.rkyv`, each `*.npy`, `sigma_meta.json`,
`sigma_verify.json`, `preprocess.json`, the deterministic `proof.json`, the
install provenance) is the JAX CLI's byte for byte, and each package loads
the other's CRS dir.  The port runs with `--device cpu`.  Tolerance: exact.
"""

import contextlib
import hashlib
import io
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu.cli import main as jmain
from tokamak_zk_evm_tpu.io import artifacts as JA
from tokamak_zk_evm_tpu.io import crs as JCRS
from tokamak_zk_evm_tpu.io import rkyv_crs as JRK
from tokamak_zk_evm_tpu.models.setup import Tau as JTau, generate_sigma as j_generate_sigma
from tokamak_zk_evm_tpu.testing.fixtures import build_fixture as j_build_fixture
from tokamak_zk_evm_tpu_torch.cli import main
from tokamak_zk_evm_tpu_torch.io import artifacts as art
from tokamak_zk_evm_tpu_torch.io import crs as TCRS
from tokamak_zk_evm_tpu_torch.io import rkyv_crs as RK
from tokamak_zk_evm_tpu_torch.models.convert import sigma_from_arrays
from tokamak_zk_evm_tpu_torch.testing.fixtures import GOLDEN_PROOF_SHA256, build_fixture

# The plain versions issue many small ops; one intra-op thread per test
# process keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

CPU = ["--device", "cpu"]
FAMILIES = ("xy_powers", "gamma_inv_o_inst", "eta_inv_li_o_inter_alpha4_kj",
            "delta_inv_li_o_prv")
CRS_FILES = (["combined_sigma.rkyv", "sigma_preprocess.rkyv", "sigma_meta.json",
              "sigma_verify.json"]
             + [f"{f}_{s}.npy" for f in FAMILIES for s in ("x", "y", "inf")])


def run(fn, argv):
    """(exit code, last stdout line) of one CLI call."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    lines = out.getvalue().strip().splitlines()
    return rc, (lines[-1] if lines else "")


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    fx = build_fixture()
    lib, synth = str(root / "library"), str(root / "synthesizer")
    os.makedirs(synth, exist_ok=True)
    art.save_library(lib, fx.params, fx.infos, fx.library)
    art.save_placement_variables(fx.placements, os.path.join(synth, "placementVariables.json"))
    art.save_instance(fx.instance, os.path.join(synth, "instance.json"))
    art.save_permutation(fx.permutation, os.path.join(synth, "permutation.json"))
    return root, lib, synth, fx


def pipeline(fn, pre, root, tag, lib, synth):
    """setup -> preprocess -> prove (deterministic) -> verify into
    root/<tag>{crs,pre,proof}; -> (exit codes, verify's stdout line)."""
    crs, pdir, prf = (str(root / f"{tag}{d}") for d in ("crs", "pre", "proof"))
    rcs = [fn(pre + ["setup", "--library", lib, "--output", crs, "--fixed-tau"]),
           fn(pre + ["preprocess", "--crs", crs, "--library", lib, "--synthesizer", synth,
                     "--output", pdir]),
           fn(pre + ["prove", "--crs", crs, "--library", lib, "--synthesizer", synth,
                     "--output", prf, "--deterministic"])]
    rc, out = run(fn, pre + ["verify", "--crs", crs, "--library", lib, "--preprocess", pdir,
                             "--proof", prf, "--synthesizer", synth])
    return rcs + [rc], out


@pytest.fixture(scope="module")
def both(staged):
    """The JAX CLI's and the port CLI's pipelines on the same staged dir."""
    root, lib, synth, _fx = staged
    return {"jax": pipeline(jmain, [], root, "j", lib, synth),
            "port": pipeline(main, CPU, root, "t", lib, synth)}


def test_library_round_trip(staged, tmp_path):
    _root, lib, _synth, fx = staged
    params, infos, library = art.load_library(lib)
    assert params == fx.params
    assert [i.flattenMap for i in infos] == [i.flattenMap for i in fx.infos]
    for orig, rt in zip(fx.library, library):
        for a, b in ((orig.A_cols, rt.A_cols), (orig.B_cols, rt.B_cols),
                     (orig.C_cols, rt.C_cols)):
            assert {w: sorted(c) for w, c in a.items() if c} == \
                   {w: sorted(c) for w, c in b.items() if c}
    jfx = j_build_fixture()
    jlib = str(tmp_path / "jlib")
    JA.save_library(jlib, jfx.params, jfx.infos, jfx.library)
    for d, _dirs, files in os.walk(jlib):
        for name in files:
            rel = os.path.relpath(os.path.join(d, name), jlib)
            assert open(os.path.join(lib, rel), "rb").read() == \
                open(os.path.join(jlib, rel), "rb").read(), rel


def test_cli_pipeline(both):
    rcs, out = both["port"]
    assert rcs == [0, 0, 0, 0] and out == "true"
    assert both["jax"] == ([0, 0, 0, 0], "true")


@pytest.mark.parametrize("name", CRS_FILES + ["preprocess.json", "proof.json"])
def test_cli_files_equal_jax(staged, both, name):
    root = staged[0]
    sub = {"preprocess.json": "pre", "proof.json": "proof"}.get(name, "crs")
    got = open(root / f"t{sub}" / name, "rb").read()
    assert got == open(root / f"j{sub}" / name, "rb").read()
    assert sorted(os.listdir(root / f"t{sub}")) == sorted(os.listdir(root / f"j{sub}"))


def test_cli_proof_is_the_golden_proof(staged, both):
    proof = art.load_proof_solidity(str(staged[0] / "tproof" / "proof.json"))
    assert hashlib.sha256(art.canonical_proof_bytes(proof)).hexdigest() == GOLDEN_PROOF_SHA256


@pytest.mark.parametrize("part", ["scalar", "point"])
def test_cli_verify_rejects_tampered(staged, both, part):
    """One limb of proof.json changed: the last scalar evaluation (V_eval) or
    a point's coordinate swapped for another valid point's (U's for V's)."""
    root, lib, synth, _fx = staged
    with open(root / "tproof" / "proof.json") as f:
        d = json.load(f)
    bad = {k: list(v) for k, v in d.items()}
    if part == "scalar":
        bad["proof_entries_part2"][-1] = "0x" + "01".rjust(64, "0")
    else:
        for k in bad:
            bad[k][0:2], bad[k][2:4] = d[k][2:4], d[k][0:2]
    bad_dir = root / f"tproof_bad_{part}"
    os.makedirs(bad_dir, exist_ok=True)
    with open(bad_dir / "proof.json", "w") as f:
        json.dump(bad, f)
    rc, out = run(main, CPU + ["verify", "--crs", str(root / "tcrs"), "--library", lib,
                               "--preprocess", str(root / "tpre"), "--proof", str(bad_dir),
                               "--synthesizer", synth])
    assert rc == 1 and out == "false"


def test_cli_doctor():
    assert run(main, CPU + ["doctor"]) == (0, "true")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["doctor"])  # the default device is the card: no CPU on its own


def test_library_resolution(staged, monkeypatch):
    """Embedded-library resolution chain (reference subcircuit_library.rs)."""
    from tokamak_zk_evm_tpu_torch.io.subcircuit_library import (
        embedded_library_path, resolve_library_path,
    )

    _root, lib, _synth, _fx = staged
    assert resolve_library_path(lib) == os.path.realpath(lib)
    monkeypatch.setenv("TZK_SUBCIRCUIT_LIBRARY", lib)
    assert resolve_library_path(None) == os.path.realpath(lib)
    monkeypatch.delenv("TZK_SUBCIRCUIT_LIBRARY")
    assert embedded_library_path() is None  # no embedded library in the repo build
    with pytest.raises(SystemExit):
        resolve_library_path(None)
    with pytest.raises(FileNotFoundError):
        resolve_library_path("/tmp")


def test_sigma_verify_roundtrip(staged, both, tmp_path):
    sigma = TCRS.load_sigma(str(staged[0] / "tcrs"), "cpu")
    path = str(tmp_path / "sigma_verify.json")
    art.save_sigma_verify(sigma, path)
    got = art.load_sigma_verify(path)
    assert got.G == sigma.G and got.H == sigma.H
    assert got.lagrange_KL == sigma.lagrange_KL
    assert got.sigma_1.x == sigma.sigma_1.x and got.sigma_1.y == sigma.sigma_1.y
    assert got.sigma_1.xy_powers is None
    for k in art._S2_FIELDS:
        assert getattr(got.sigma_2, k) == getattr(sigma.sigma_2, k), k


def test_extract_proof_bundle(tmp_path):
    sdir, pdir, vdir = tmp_path / "s", tmp_path / "p", tmp_path / "v"
    for d, name in ((sdir, "instance.json"), (pdir, "preprocess.json"),
                    (vdir, "proof.json")):
        d.mkdir(exist_ok=True)
        (d / name).write_text(json.dumps({"name": name}))
    out = tmp_path / "bundle.zip"
    rc = main(["extract-proof", "--synthesizer", str(sdir), "--preprocess", str(pdir),
               "--prove", str(vdir), "--output", str(out)])
    assert rc == 0
    with zipfile.ZipFile(out) as z:
        assert sorted(z.namelist()) == ["instance.json", "preprocess.json", "proof.json"]
    os.remove(vdir / "proof.json")
    assert main(["extract-proof", "--synthesizer", str(sdir), "--preprocess", str(pdir),
                 "--prove", str(vdir), "--output", str(out)]) == 1


def test_each_package_loads_the_others_crs(staged, both, tmp_path):
    """The port proves the golden proof from the JAX CLI's CRS dir (its rkyv
    archive, which `load_sigma_any` prefers); the port's npy and rkyv loads
    of that dir equal `sigma_from_arrays` of the JAX Sigma, and the JAX
    loads of the port's dir equal the JAX Sigma."""
    root, lib, synth, fx = staged
    jcrs, tcrs = str(root / "jcrs"), str(root / "tcrs")
    prf = str(tmp_path / "proof")
    assert main(CPU + ["prove", "--crs", jcrs, "--library", lib, "--synthesizer", synth,
                       "--output", prf, "--deterministic"]) == 0
    proof = art.load_proof_solidity(os.path.join(prf, "proof.json"))
    assert hashlib.sha256(art.canonical_proof_bytes(proof)).hexdigest() == GOLDEN_PROOF_SHA256

    jfx = j_build_fixture()
    jsigma = j_generate_sigma(jfx.params, JTau.fixed(), jfx.library, jfx.infos)
    want = sigma_from_arrays(jsigma, "cpu")

    def same(a, b):
        for name in FAMILIES:
            for x, y in zip(getattr(a.sigma_1, name), getattr(b.sigma_1, name)):
                assert np.array_equal(np.asarray(x).astype(np.uint32),
                                      np.asarray(y).astype(np.uint32)), name
        for name in ("x", "y", "delta", "eta", "delta_inv_alphak_xh_tx",
                     "delta_inv_alpha4_xj_tx", "delta_inv_alphak_yi_ty"):
            assert getattr(a.sigma_1, name) == getattr(b.sigma_1, name), name
        assert (a.G, a.H, a.lagrange_KL, a.sigma_2) == (b.G, b.H, b.lagrange_KL, b.sigma_2)

    same(TCRS.load_sigma(jcrs, "cpu"), want)
    same(RK.read_combined_sigma(os.path.join(jcrs, "combined_sigma.rkyv"), fx.params,
                                device="cpu"), want)
    same(sigma_from_arrays(JCRS.load_sigma(tcrs), "cpu"), want)
    same(sigma_from_arrays(JRK.read_combined_sigma(os.path.join(tcrs, "combined_sigma.rkyv"),
                                                   jfx.params), "cpu"), want)


def test_cli_testing_mode(staged, both, tmp_path):
    """`prove --testing-mode` writes proof4_test.json and the same proof;
    `verify` then also runs the decomposed arith / copy / binding checks."""
    root, lib, synth, _fx = staged
    prf = str(tmp_path / "proof")
    assert main(CPU + ["prove", "--crs", str(root / "tcrs"), "--library", lib,
                       "--synthesizer", synth, "--output", prf, "--deterministic",
                       "--testing-mode"]) == 0
    assert open(os.path.join(prf, "proof.json"), "rb").read() == \
        open(root / "tproof" / "proof.json", "rb").read()
    p4t = art.load_proof4test(os.path.join(prf, "proof4_test.json"))
    assert all(getattr(p4t, n) is not None for n in art._P4T_FIELDS)
    assert run(main, CPU + ["verify", "--crs", str(root / "tcrs"), "--library", lib,
                            "--preprocess", str(root / "tpre"), "--proof", prf,
                            "--synthesizer", synth]) == (0, "true")


def test_cli_install_provenance_equals_jax(staged, tmp_path):
    """`install --fixed-tau` copies the library, runs setup in both formats
    and records the SHA-256 of every CRS file: the JAX CLI's digests."""
    lib = staged[1]
    tws, jws = str(tmp_path / "t"), str(tmp_path / "j")
    assert main(CPU + ["install", "--workspace", tws, "--library", lib, "--fixed-tau"]) == 0
    assert jmain(["install", "--workspace", jws, "--library", lib, "--fixed-tau"]) == 0
    got = open(os.path.join(tws, "crs_provenance.json"), "rb").read()
    assert got == open(os.path.join(jws, "crs_provenance.json"), "rb").read()
    assert len(json.loads(got)["artifacts"]) == len(CRS_FILES)
    assert os.path.isfile(os.path.join(tws, "subcircuit-library", "setupParams.json"))


@pytest.mark.parametrize("command", ["synthesize", "mpc"])
def test_commands_still_to_come_are_absent(command):
    """`synthesize` (frontend) and `mpc` (ceremony) wait for their slices."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as e:
        main(CPU + [command])
    assert e.value.code == 2 and "invalid choice" in err.getvalue()

"""The port's `mpc` subcommand against the JAX CLI's, on the toy library,
with `--device cpu`: phase1-init writes the JAX package's file byte for
byte; each package's phase1-verify accepts the other's phase1-contribute
file (and rejects it against the wrong previous accumulator);
phase2-prepare writes the JAX package's CRS files byte for byte from the
same accumulator; phase2-contribute writes a CRS and a proof that
`phase2_verify` accepts.  Contributions draw from the OS's rng, as the
reference's flows do."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu.cli import main as jmain
from tokamak_zk_evm_tpu_torch.cli import main
from tokamak_zk_evm_tpu_torch.io import artifacts as art
from tokamak_zk_evm_tpu_torch.io import crs as TCRS
from tokamak_zk_evm_tpu_torch.models import mpc_setup as M
from tokamak_zk_evm_tpu_torch.testing.fixtures import build_fixture

torch.set_num_threads(1)
CPU = ["--device", "cpu"]


def run(fn, argv):
    """(exit code, last stdout line) of one CLI call."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    lines = out.getvalue().strip().splitlines()
    return rc, (lines[-1] if lines else "")


@pytest.fixture(scope="module")
def phase1(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_mpc_cli")
    fx = build_fixture()
    lib = str(root / "library")
    art.save_library(lib, fx.params, fx.infos, fx.library)
    f = lambda name: str(root / name)  # noqa: E731
    assert run(main, CPU + ["mpc", "phase1-init", "--library", lib, "--output", f("acc0.json")]) \
        == (0, "")
    assert run(jmain, ["mpc", "phase1-init", "--library", lib, "--output", f("jacc0.json")]) \
        == (0, "")
    assert run(main, CPU + ["mpc", "phase1-contribute", "--acc", f("acc0.json"), "--output",
                            f("acc1.json"), "--proof", f("p1.json")])[0] == 0
    assert run(jmain, ["mpc", "phase1-contribute", "--acc", f("jacc0.json"), "--output",
                       f("jacc1.json"), "--proof", f("jp1.json")])[0] == 0
    return root, lib, f


def test_phase1_init_bytes_match_jax(phase1):
    _, _, f = phase1
    assert open(f("acc0.json"), "rb").read() == open(f("jacc0.json"), "rb").read()


def test_phase1_verify_accepts_the_other_package(phase1):
    _, _, f = phase1
    assert run(main, CPU + ["mpc", "phase1-verify", "--prev", f("jacc0.json"), "--cur",
                            f("jacc1.json"), "--proof", f("jp1.json")]) == (0, "true")
    assert run(jmain, ["mpc", "phase1-verify", "--prev", f("acc0.json"), "--cur",
                       f("acc1.json"), "--proof", f("p1.json")]) == (0, "true")
    # a contribution does not verify over an accumulator it did not follow
    assert run(main, CPU + ["mpc", "phase1-verify", "--prev", f("acc1.json"), "--cur",
                            f("jacc1.json"), "--proof", f("jp1.json")]) == (1, "false")


def test_phase2_prepare_and_contribute(phase1):
    root, lib, f = phase1
    for fn, pre, out in ((main, CPU, "crs0"), (jmain, [], "jcrs0")):
        assert run(fn, pre + ["mpc", "phase2-prepare", "--library", lib, "--acc",
                              f("jacc1.json"), "--y-hex", "beef", "--output", f(out)])[0] == 0
    names = sorted(os.listdir(f("crs0")))
    assert names == sorted(os.listdir(f("jcrs0"))) and len(names) == 13
    for name in names:
        assert open(os.path.join(f("crs0"), name), "rb").read() == \
            open(os.path.join(f("jcrs0"), name), "rb").read(), name
    assert run(main, CPU + ["mpc", "phase2-contribute", "--crs", f("crs0"), "--output",
                            f("crs1")])[0] == 0
    with open(os.path.join(f("crs1"), "phase2_proof.json")) as fh:
        d = json.load(fh)
    proof = M.Phase2Proof(d["contributor_index"],
                          *(M.SchnorrProof.from_json(d[k], "cpu")
                            for k in ("proof_gamma", "proof_delta", "proof_eta")))
    prev, cur = TCRS.load_sigma(f("crs0"), "cpu"), TCRS.load_sigma(f("crs1"), "cpu")
    assert M.phase2_verify(prev, cur, proof, np.random.default_rng(4))

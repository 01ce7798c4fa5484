"""The port stands alone: no JAX, no JAX package, no silent CPU fallback.

* a subprocess blocks `jax` (and the JAX package) in `sys.modules`, imports
  the port and proves the toy fixture on the CPU, reproducing the golden
  digest;
* no file of the port and not `chip_smoke.py` names `jax` or
  `tokamak_zk_evm_tpu` in an import;
* the entry points raise without a CUDA device unless given device="cpu";
* the port's copies of the JAX-free host modules agree with the originals.
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

    fx = build_fixture()
    return {
        "generate_sigma": lambda: generate_sigma(fx.params, Tau.fixed(), fx.library, fx.infos),
        "Prover": lambda: Prover(fx.params, None, fx.library, fx.infos, fx.placements,
                                 fx.permutation, fx.instance),
        "preprocess": lambda: preprocess(None, fx.permutation, fx.instance, fx.params),
        "Verifier": lambda: Verifier(fx.params, None, None, fx.instance, None),
    }


@pytest.mark.parametrize("name", ["generate_sigma", "Prover", "preprocess", "Verifier"])
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

"""Port prover, setup, preprocess and verifier vs the JAX package.

Both packages prove the toy fixture (`build_fixture`) under `Tau.fixed()`;
the port either runs its own setup or takes the JAX CRS through
`sigma_from_arrays`.  Proofs are compared as their Solidity-format dicts
(exact), the golden digest is the one `tests/test_golden_proof.py` pins, and
each package's verifier must accept the other's proofs and agree on tampered
ones.  The port runs on the CPU (plain versions of its kernels).
"""

import copy
import hashlib

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu.io import artifacts as JA
from tokamak_zk_evm_tpu.models.preprocess import preprocess as j_preprocess
from tokamak_zk_evm_tpu.models.protocol import Mixer as JMixer
from tokamak_zk_evm_tpu.models.prover import Prover as JProver
from tokamak_zk_evm_tpu.models.setup import Tau as JTau, generate_sigma as j_generate_sigma
from tokamak_zk_evm_tpu.models.verifier import Verifier as JVerifier
from tokamak_zk_evm_tpu.testing.fixtures import build_fixture as j_build_fixture
from tokamak_zk_evm_tpu_torch.io import artifacts as TA
from tokamak_zk_evm_tpu_torch.models.convert import proof_from_fields, sigma_from_arrays
from tokamak_zk_evm_tpu_torch.models.preprocess import preprocess as t_preprocess
from tokamak_zk_evm_tpu_torch.models.protocol import Mixer as TMixer
from tokamak_zk_evm_tpu_torch.models.prover import Prover as TProver
from tokamak_zk_evm_tpu_torch.models.setup import Tau as TTau, generate_sigma as t_generate_sigma
from tokamak_zk_evm_tpu_torch.models.verifier import Verifier as TVerifier
from tokamak_zk_evm_tpu_torch.testing.fixtures import GOLDEN_PROOF_SHA256
from tokamak_zk_evm_tpu_torch.testing.fixtures import build_fixture as t_build_fixture

# The plain versions issue many small ops; one intra-op thread per test
# process keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


def mixers(kind):
    if kind == "zero":
        return JMixer.zero(), TMixer.zero()
    return (JMixer.random(np.random.default_rng(99)), TMixer.random(np.random.default_rng(99)))


@pytest.fixture(scope="module")
def world():
    jfx, tfx = j_build_fixture(), t_build_fixture()
    jsigma = j_generate_sigma(jfx.params, JTau.fixed(), jfx.library, jfx.infos)
    tsigma = sigma_from_arrays(jsigma, "cpu")
    jpre = j_preprocess(jsigma, jfx.permutation, jfx.instance, jfx.params)
    tpre = t_preprocess(tsigma, tfx.permutation, tfx.instance, tfx.params, device="cpu")
    return {"jfx": jfx, "tfx": tfx, "jsigma": jsigma, "tsigma": tsigma, "jpre": jpre,
            "tpre": tpre, "proofs": {}}


def proofs(world, kind):
    """(jax proof, port proof) for a mixer kind, proved once per module."""
    hit = world["proofs"].get(kind)
    if hit is None:
        jm, tm = mixers(kind)
        jfx, tfx = world["jfx"], world["tfx"]
        jp, _ = JProver(jfx.params, world["jsigma"], jfx.library, jfx.infos, jfx.placements,
                        jfx.permutation, jfx.instance, mixer=jm).prove()
        tp, _ = TProver(tfx.params, world["tsigma"], tfx.library, tfx.infos, tfx.placements,
                        tfx.permutation, tfx.instance, mixer=tm, device="cpu").prove()
        hit = world["proofs"][kind] = (jp, tp)
    return hit


def test_port_setup_matches_jax(world):
    tfx, jsigma = world["tfx"], world["jsigma"]
    own = t_generate_sigma(tfx.params, TTau.fixed(), tfx.library, tfx.infos, device="cpu")
    for name in ("xy_powers", "gamma_inv_o_inst", "eta_inv_li_o_inter_alpha4_kj",
                 "delta_inv_li_o_prv"):
        for a, b in zip(getattr(own.sigma_1, name), getattr(jsigma.sigma_1, name)):
            assert np.array_equal(a.numpy().astype(np.uint32), np.asarray(b).astype(np.uint32))
    for name in ("x", "y", "delta", "eta", "delta_inv_alphak_xh_tx", "delta_inv_alpha4_xj_tx",
                 "delta_inv_alphak_yi_ty"):
        assert getattr(own.sigma_1, name) == getattr(jsigma.sigma_1, name)
    assert own.sigma_2.__dict__ == jsigma.sigma_2.__dict__
    assert own.lagrange_KL == jsigma.lagrange_KL


def test_golden_digest_through_port():
    tfx = t_build_fixture()
    sigma = t_generate_sigma(tfx.params, TTau.fixed(), tfx.library, tfx.infos, device="cpu")
    proof, _ = TProver(tfx.params, sigma, tfx.library, tfx.infos, tfx.placements,
                       tfx.permutation, tfx.instance, mixer=TMixer.zero(), device="cpu").prove()
    assert hashlib.sha256(TA.canonical_proof_bytes(proof)).hexdigest() == GOLDEN_PROOF_SHA256
    pre = t_preprocess(sigma, tfx.permutation, tfx.instance, tfx.params, device="cpu")
    assert TVerifier(tfx.params, sigma, pre, tfx.instance, proof,
                     rng=np.random.default_rng(7), device="cpu").verify_snark()


def test_preprocess_matches_jax(world):
    assert TA.preprocess_to_solidity(world["tpre"]) == JA.preprocess_to_solidity(world["jpre"])


@pytest.mark.parametrize("kind", ["zero", "random"])
def test_port_proof_equals_jax_proof(world, kind):
    jp, tp = proofs(world, kind)
    assert TA.proof_to_solidity(tp) == JA.proof_to_solidity(jp)


@pytest.mark.parametrize("kind", ["zero", "random"])
def test_jax_verifier_accepts_port_proof(world, kind):
    _, tp = proofs(world, kind)
    jfx = world["jfx"]
    assert JVerifier(jfx.params, world["jsigma"], world["jpre"], jfx.instance, tp,
                     rng=np.random.default_rng(7)).verify_snark()


def test_port_verifier_accepts_jax_proof(world):
    jp, _ = proofs(world, "random")
    tfx = world["tfx"]
    assert TVerifier(tfx.params, world["tsigma"], world["tpre"], tfx.instance,
                     proof_from_fields(jp), rng=np.random.default_rng(7),
                     device="cpu").verify_snark()


def _tamper(proof, how):
    bad = copy.deepcopy(proof)
    if how == "V_eval":
        bad.proof3.V_eval = (bad.proof3.V_eval + 1) % 2**64
    elif how == "swap_U_V":
        bad.proof0.U, bad.proof0.V = bad.proof0.V, bad.proof0.U
    else:
        bad.proof4.Pi_X = bad.proof4.Pi_Y
    return bad


@pytest.mark.parametrize("how", ["V_eval", "swap_U_V", "Pi_X"])
def test_verdicts_agree_on_tampered_proof(world, how):
    _, tp = proofs(world, "random")
    bad = _tamper(tp, how)
    jfx, tfx = world["jfx"], world["tfx"]
    j_ok = JVerifier(jfx.params, world["jsigma"], world["jpre"], jfx.instance, bad,
                     rng=np.random.default_rng(7)).verify_snark()
    t_ok = TVerifier(tfx.params, world["tsigma"], world["tpre"], tfx.instance, bad,
                     rng=np.random.default_rng(7), device="cpu").verify_snark()
    assert j_ok is False and t_ok is False


def test_testing_mode_passes(world, capsys):
    tfx = world["tfx"]
    _, tm = mixers("random")
    proof, p4t = TProver(tfx.params, world["tsigma"], tfx.library, tfx.infos, tfx.placements,
                         tfx.permutation, tfx.instance, mixer=tm, device="cpu",
                         testing_mode=True).prove()
    err = capsys.readouterr().err
    assert "satisfy R1CS" in err and "well constructed" in err and "Ruffini" in err
    _, tp = proofs(world, "random")
    assert TA.proof_to_solidity(proof) == TA.proof_to_solidity(tp)
    v = TVerifier(tfx.params, world["tsigma"], world["tpre"], tfx.instance, proof,
                  rng=np.random.default_rng(7), device="cpu")
    assert v.verify_arith(p4t) and v.verify_copy(p4t) and v.verify_binding(p4t)


SMALL = dict(n=256, s_max=32, m_i=256, n_synth_kinds=2, priv_per_synth=120)


@pytest.fixture(scope="module")
def small_fixtures():
    from tokamak_zk_evm_tpu.testing.synthetic import build_synthetic as j_build
    from tokamak_zk_evm_tpu_torch.testing.synthetic import build_synthetic as t_build

    return j_build(**SMALL), t_build(**SMALL)


@pytest.mark.parametrize("builder", ["bXY", "uXY", "vXY", "wXY", "perm", "a_free"])
def test_witness_grids_match_jax_at_small_synthetic_shape(small_fixtures, builder):
    """bench.py's "small" synthetic shape (n=256, s_max=32, m_i=256)."""
    from tokamak_zk_evm_tpu.models import witness as JW
    from tokamak_zk_evm_tpu_torch.models import witness as TW

    jfx, tfx = small_fixtures
    p = jfx.params
    if builder == "bXY":
        j = [JW.gen_bXY(jfx.placements, jfx.infos, p)]
        t = [TW.gen_bXY(tfx.placements, tfx.infos, tfx.params, "cpu")]
    elif builder == "perm":
        j = JW.permutation_to_polys(jfx.permutation, p.m_i, p.s_max)
        t = TW.permutation_to_polys(tfx.permutation, p.m_i, p.s_max, "cpu")
    elif builder == "a_free":
        j = [JW.gen_a_free_X(jfx.instance, p)]
        t = [TW.gen_a_free_X(tfx.instance, tfx.params, "cpu")]
    else:
        j = [getattr(JW, f"gen_{builder}")(jfx.placements, jfx.library, p)]
        t = [getattr(TW, f"gen_{builder}")(tfx.placements, tfx.library, tfx.params, "cpu")]
    for a, b in zip(j, t):
        assert np.array_equal(b.coeffs.numpy().astype(np.uint32),
                              np.asarray(a.coeffs).astype(np.uint32))

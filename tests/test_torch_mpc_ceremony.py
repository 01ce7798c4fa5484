"""The port's MPC ceremony against the JAX package's, phase 2, on the toy
fixture, exact: the seeded ceremony of `tests/test_mpc_setup.py`'s end gate
(two phase-1 contributions, phase-2 prepare with a beacon y, two phase-2
contributions) run by both packages from the same rngs.

Every family of the prepared Sigma and of each contribution equals the JAX
package's (limb arrays and inf masks, bit for bit), so do the host points,
the proofs, the transcript hash and the files `crs.save_sigma` writes; each
contribution verifies; and the result equals the port's `generate_sigma`
for the combined secrets (the ceremony and the trusted setup are two paths
to one CRS).  The port runs on the CPU (the plain versions of B13's
kernels and of K1, K2 and K4).
"""

import os

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu.io import crs as JCRS
from tokamak_zk_evm_tpu.models import mpc_setup as JM
from tokamak_zk_evm_tpu.testing.fixtures import build_fixture as j_build_fixture
from tokamak_zk_evm_tpu_torch.fields import R_MOD
from tokamak_zk_evm_tpu_torch.io import crs as TCRS
from tokamak_zk_evm_tpu_torch.models import mpc_setup as M
from tokamak_zk_evm_tpu_torch.models.setup import Tau, generate_sigma
from tokamak_zk_evm_tpu_torch.testing.fixtures import build_fixture

torch.set_num_threads(1)
CPU = torch.device("cpu")
Y = 0x1234567
HOST_S1 = ("x", "y", "delta", "eta", "delta_inv_alphak_xh_tx", "delta_inv_alpha4_xj_tx",
           "delta_inv_alphak_yi_ty", "h_max", "rs_y")


class SeqRng:
    """Deterministic scalar feed so the combined trapdoor is known."""

    def __init__(self, seed):
        self._rng = np.random.default_rng(seed)

    def bytes(self, n):
        return self._rng.bytes(n)


@pytest.fixture(scope="module")
def ceremony():
    """Both packages' ceremonies from the same seeds, and the combined
    secrets replayed from a third copy of each rng."""
    fx, jfx = build_fixture(), j_build_fixture()
    out = {"fx": fx, "acc": [], "jacc": [], "sigma": [], "jsigma": [], "proof": [],
           "jproof": [], "ok": []}
    acc, jacc = M.Phase1Accumulator.initial(fx.params), JM.Phase1Accumulator.initial(jfx.params)
    rng, jrng, shadow = SeqRng(7), SeqRng(7), SeqRng(7)
    alpha = x = 1
    for _ in range(2):
        acc, _ = acc.compute(rng, CPU)
        jacc, _ = jacc.compute(jrng)
        out["acc"].append(acc)
        out["jacc"].append(jacc)
        a_u, x_u = M._rand_fr(shadow), M._rand_fr(shadow)
        M._rand_fr(shadow), M._rand_fr(shadow)  # the two Schnorr nonces
        alpha, x = alpha * a_u % R_MOD, x * x_u % R_MOD
    sigma = M.phase2_prepare(acc, Y, fx.params, fx.library, fx.infos, CPU)
    jsigma = JM.phase2_prepare(jacc, Y, jfx.params, jfx.library, jfx.infos)
    out["sigma"].append(sigma)
    out["jsigma"].append(jsigma)
    rng, jrng, shadow = SeqRng(9), SeqRng(9), SeqRng(9)
    gamma = delta = eta = 1
    for i in range(2):
        prev = sigma
        sigma, proof = M.phase2_contribute(prev, rng)
        jsigma, jproof = JM.phase2_contribute(jsigma, jrng)
        out["ok"].append(M.phase2_verify(prev, sigma, proof, np.random.default_rng(20 + i)))
        for key, v in (("sigma", sigma), ("jsigma", jsigma), ("proof", proof),
                       ("jproof", jproof)):
            out[key].append(v)
        g_u, d_u, e_u = (M._rand_fr(shadow) for _ in range(3))
        for _ in range(3):  # the Schnorr nonces
            M._rand_fr(shadow)
        gamma, delta, eta = gamma * g_u % R_MOD, delta * d_u % R_MOD, eta * e_u % R_MOD
    out["tau"] = Tau(x=x, y=Y, alpha=alpha, gamma=gamma, delta=delta, eta=eta)
    return out


def same_sigma(port, jax_sigma) -> bool:
    """Every family's x, y and inf equal to the JAX package's arrays bit for
    bit, and every host point equal."""
    for name in M._FAMILIES:
        for t, j in zip(getattr(port.sigma_1, name), getattr(jax_sigma.sigma_1, name)):
            j = np.asarray(j)
            if t.shape != j.shape or not np.array_equal(t.numpy().view(np.uint32), j):
                return False
    return (all(getattr(port.sigma_1, k) == getattr(jax_sigma.sigma_1, k) for k in HOST_S1)
            and vars(port.sigma_2) == vars(jax_sigma.sigma_2)
            and (port.G, port.H, port.lagrange_KL)
            == (jax_sigma.G, jax_sigma.H, jax_sigma.lagrange_KL))


def test_phase1_chain_matches_jax(ceremony):
    for acc, jacc in zip(ceremony["acc"], ceremony["jacc"]):
        assert acc.to_json() == jacc.to_json()
        assert acc.hash() == jacc.hash()


@pytest.mark.parametrize("step", [0, 1, 2])
def test_sigma_matches_jax(ceremony, step):
    """Step 0: phase2_prepare; steps 1, 2: after each contribution (its
    proof and the transcript hash too)."""
    sigma, jsigma = ceremony["sigma"][step], ceremony["jsigma"][step]
    assert same_sigma(sigma, jsigma)
    assert M._sigma_hash(sigma) == JM._sigma_hash(jsigma)
    if step:
        assert ceremony["proof"][step - 1].to_json() == ceremony["jproof"][step - 1].to_json()


def test_save_sigma_bytes_match_jax(ceremony, tmp_path):
    """The prepared and the final Sigma written by both packages'
    `crs.save_sigma`: the same files, byte for byte."""
    for step in (0, 2):
        t, j = tmp_path / f"t{step}", tmp_path / f"j{step}"
        TCRS.save_sigma(ceremony["sigma"][step], str(t))
        JCRS.save_sigma(ceremony["jsigma"][step], str(j))
        names = sorted(os.listdir(t))
        assert names == sorted(os.listdir(j)) and len(names) == 13
        for name in names:
            assert (t / name).read_bytes() == (j / name).read_bytes(), name


def test_contributions_verify(ceremony):
    assert ceremony["ok"] == [True, True]


def test_ceremony_equals_generate_sigma(ceremony):
    """End gate: the ceremony's CRS == generate_sigma(combined trapdoor)."""
    fx = ceremony["fx"]
    want = generate_sigma(fx.params, ceremony["tau"], fx.library, fx.infos, device="cpu")
    got = ceremony["sigma"][-1]
    for name in M._FAMILIES:
        for t, w in zip(getattr(got.sigma_1, name), getattr(want.sigma_1, name)):
            assert torch.equal(t, w), name
    assert all(getattr(got.sigma_1, k) == getattr(want.sigma_1, k) for k in HOST_S1)
    assert vars(got.sigma_2) == vars(want.sigma_2)
    assert (got.G, got.H, got.lagrange_KL) == (want.G, want.H, want.lagrange_KL)

"""The port's `phase2_verify` against the JAX package's on the four
tampering cases of `tests/test_mpc_setup.py::test_phase2_verify_rejects_tampering`,
on the toy fixture: the same seeded phase-1 contribution, prepare and
phase-2 contribution in both packages (equal, bit for bit), the honest
contribution accepted, and each tampered Sigma rejected by both: one point
of a large packed family, an "immutable" xy_powers row swap, one point of a
small delta-inverse list, and sigma_1.delta without its G2 side.  The port
runs on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu.models import mpc_setup as JM
from tokamak_zk_evm_tpu.ops import curve as jcv
from tokamak_zk_evm_tpu.testing.fixtures import build_fixture as j_build_fixture
from tokamak_zk_evm_tpu_torch.models import mpc_setup as M
from tokamak_zk_evm_tpu_torch.ops import curve as cv
from tokamak_zk_evm_tpu_torch.testing.fixtures import build_fixture

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def contributed():
    fx, jfx = build_fixture(), j_build_fixture()
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    acc, _ = M.Phase1Accumulator.initial(fx.params).compute(rng, CPU)
    jacc, _ = JM.Phase1Accumulator.initial(jfx.params).compute(jrng)
    sigma = M.phase2_prepare(acc, 0xBEEF, fx.params, fx.library, fx.infos, CPU)
    jsigma = JM.phase2_prepare(jacc, 0xBEEF, jfx.params, jfx.library, jfx.infos)
    cur, proof = M.phase2_contribute(sigma, rng)
    jcur, jproof = JM.phase2_contribute(jsigma, jrng)
    return sigma, cur, proof, jsigma, jcur, jproof


def test_contribution_matches_jax_and_verifies(contributed):
    sigma, cur, proof, jsigma, jcur, jproof = contributed
    assert proof.to_json() == jproof.to_json()
    assert M._sigma_hash(cur) == JM._sigma_hash(jcur)
    assert M.phase2_verify(sigma, cur, proof, np.random.default_rng(1))


def _replace_s1(sigma, **kw):
    return dataclasses.replace(sigma, sigma_1=dataclasses.replace(sigma.sigma_1, **kw))


def _tamper(case, cur, unpack, pack, gen):
    """The JAX test's tampered copy of `cur`, made with either package's
    family packing."""
    s1 = cur.sigma_1
    if case == "packed_point":
        pts = unpack(s1.delta_inv_li_o_prv)
        k = next(i for i, p in enumerate(pts) if p is not None)
        pts[k] = gen  # valid curve point, wrong value
        return _replace_s1(cur, delta_inv_li_o_prv=pack(pts))
    if case == "xy_row_swap":
        xp = unpack(s1.xy_powers)
        xp[0], xp[1] = xp[1], xp[0]
        return _replace_s1(cur, xy_powers=pack(xp))
    if case == "small_list":
        rows = [list(r) for r in s1.delta_inv_alphak_yi_ty]
        rows[0][0] = gen
        return _replace_s1(cur, delta_inv_alphak_yi_ty=rows)
    return _replace_s1(cur, delta=gen)  # sigma_1.delta without the G2 side


@pytest.mark.parametrize("case", ["packed_point", "xy_row_swap", "small_list", "delta"])
def test_phase2_verify_rejects_tampering(contributed, case):
    sigma, cur, proof, jsigma, jcur, jproof = contributed
    bad = _tamper(case, cur, cv.unpack_affine, lambda p: cv.pack_affine(p, CPU), M.G1.gen)
    jbad = _tamper(case, jcur, jcv.unpack_affine, jcv.pack_affine, JM.G1.gen)
    assert M._sigma_hash(bad) == JM._sigma_hash(jbad)
    assert not JM.phase2_verify(jsigma, jbad, jproof, np.random.default_rng(2))
    assert not M.phase2_verify(sigma, bad, proof, np.random.default_rng(2))

"""The port's MPC ceremony (`models/mpc_setup.py`) against the JAX
package's: the primitives and phase 1, on the toy fixture, exact.

The same seeded rng feeds both packages, so the draws (exponents, Schnorr
nonces, the verifier's weights) line up draw for draw.  The port's group
work runs here on the CPU through the plain versions of B13's kernels: the
multiplier (`_g1_mul_many`, fixed 4-bit windows over `g1_dbl` / `g1_add`)
and the inverse group NTT (`_group_lagrange_points`) are held to the JAX
package's host loops at sizes 1, 2, 8 and 16, with scalars 0, 1, r-1 and r
and infinite lanes.  Phase 2 is in `test_torch_mpc_ceremony.py` and
`test_torch_mpc_tamper.py`, the CLI in `test_torch_mpc_cli.py`.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu.models import mpc_setup as JM
from tokamak_zk_evm_tpu.testing.fixtures import build_fixture as j_build_fixture
from tokamak_zk_evm_tpu_torch.fields import Q_MOD, R_MOD
from tokamak_zk_evm_tpu_torch.host import curve as C
from tokamak_zk_evm_tpu_torch.models import mpc_setup as M
from tokamak_zk_evm_tpu_torch.ops import curve as cv
from tokamak_zk_evm_tpu_torch.testing.fixtures import build_fixture

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def fx():
    return build_fixture(), j_build_fixture()


def _points(n, seed, inf=()):
    rng = np.random.default_rng(seed)
    pts = [C.g1_scalar_mul_affine(C.G1.gen, int(k)) for k in rng.integers(1, 1 << 60, size=n)]
    for i in inf:
        pts[i] = None
    return pts


def _off_subgroup_point(seed):
    """A point of E(Fq) outside the r-order subgroup (the cofactor is not 1,
    so a random curve point is almost never in it)."""
    x = seed
    while True:
        x += 1
        rhs = (pow(x, 3, Q_MOD) + 4) % Q_MOD
        y = pow(rhs, (Q_MOD + 1) // 4, Q_MOD)
        if y * y % Q_MOD == rhs and not M._r_times_is_infinity(C.G1, (x, y)):
            return (x, y)


def test_rand_fr_limbs_matches_draws():
    """The bulk draw gives `_rand_fr`'s values in order and leaves the rng
    where the single draws leave it."""
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    got = M._rand_fr_limbs(a, 300, CPU)
    want = [M._rand_fr(b) for _ in range(300)]
    assert [int.from_bytes(got[:, i].numpy().astype("<u2").tobytes(), "little")
            for i in range(300)] == want
    assert a.bytes(8) == b.bytes(8)


def test_schnorr_matches_jax():
    th = b"t" * 64
    p = M.schnorr_prove(12345, b"tag", th, np.random.default_rng(0))
    jp = JM.schnorr_prove(12345, b"tag", th, np.random.default_rng(0))
    assert p.to_json() == jp.to_json()
    assert M.schnorr_verify(p, b"tag", th) and JM.schnorr_verify(jp, b"tag", th)
    assert not M.schnorr_verify(p, b"other", th)
    bad = dataclasses.replace(p, s=(p.s + 1) % R_MOD)
    assert not M.schnorr_verify(bad, b"tag", th)
    assert M.SchnorrProof.from_json(jp.to_json(), CPU) == p


@pytest.mark.parametrize("size", [1, 2, 8, 16])
def test_ladder_matches_host(size):
    """Scalars 0, 1, r-1, r, random; infinite points; one scalar a lane and
    one for all lanes."""
    pts = _points(size, size, inf=[size // 2] if size > 1 else [])
    rng = np.random.default_rng(size)
    ks = [0, 1, R_MOD - 1, R_MOD] + [int.from_bytes(rng.bytes(32), "little")
                                    for _ in range(size)]
    ks = ks[:size]
    got = cv.unpack_affine(M._g1_mul_many(cv.pack_affine(pts, CPU), ks))
    assert got == [JM._g1_mul(p, k) for p, k in zip(pts, ks)]
    k = int.from_bytes(rng.bytes(32), "little")
    assert cv.unpack_affine(M._g1_mul_many(cv.pack_affine(pts, CPU), k)) == \
        [JM._g1_mul(p, k) for p in pts]


@pytest.mark.parametrize("size", [1, 2, 8, 16])
def test_group_lagrange_matches_jax(size):
    pts = _points(size, 100 + size, inf=[1] if size > 1 else [])
    got = cv.unpack_affine(M._group_lagrange_points(cv.pack_affine(pts, CPU), size))
    assert got == JM._group_lagrange_points(pts, size)


def test_group_lagrange_sizes_side_by_side():
    """Transforms of different sizes and two of one size in one call."""
    a, b, c = _points(8, 1), _points(8, 2), _points(4, 3, inf=[0])
    outs = M._group_lagrange([(M._jac(cv.pack_affine(a + b, CPU)), 8),
                              (M._jac(cv.pack_affine(c, CPU)), 4)])
    got = [cv.unpack_affine(M.K.g1_to_affine(o)) for o in outs]
    assert got[0] == JM._group_lagrange_points(a, 8) + JM._group_lagrange_points(b, 8)
    assert got[1] == JM._group_lagrange_points(c, 4)


def test_checked_deserialization_matches_jax():
    """Off-curve points are rejected with the JAX package's error, at the
    first bad point of a file.  A point on the curve but outside the
    r-order subgroup is rejected too, with the error the JAX package means
    to raise: its own test computes r P as 0 P (the host curve reduces the
    scalar mod r) and passes every such point."""
    def checked(s):
        return M._points_checked([("g1", s)], CPU)[0]

    good = M._ser_g1(C.G1.gen)
    assert checked(good) == JM._de_g1_checked(good) == C.G1.gen
    gx, gy = C.G1.gen
    off = M._ser_g1((gx, (gy + 1) % Q_MOD))
    with pytest.raises(JM.CeremonyFormatError) as want:
        JM._de_g1_checked(off)
    with pytest.raises(M.CeremonyFormatError) as got:
        checked(off)
    assert str(got.value) == str(want.value)
    small = _off_subgroup_point(7)
    sub = M._ser_g1(small)
    assert JM._de_g1_checked(sub) == small  # the JAX package's test passes it
    with pytest.raises(M.CeremonyFormatError) as got:
        checked(sub)
    assert str(got.value) == f"G1 point outside r-subgroup: {sub[:32]}..."
    good2 = M._ser_g2(C.G2.gen)
    assert M._de_g2_checked(good2) == JM._de_g2_checked(good2)
    ((xa, xb), (ya, yb)) = C.G2.gen
    off2 = M._ser_g2(((xa, xb), ((ya + 1) % Q_MOD, yb)))
    with pytest.raises(M.CeremonyFormatError, match="G2 point off-curve"):
        M._de_g2_checked(off2)

    d = M.Phase1Accumulator.initial(build_fixture().params).to_json()
    for bad in ({"x_g1": {3: off, 5: off}}, {"x_g1": {5: off}, "alpha_x_g1": {0: off}},
                {"x_g2": off2, "alpha_g1": {1: off}}, {"alpha_x_g1": {7: "inf"}}):
        e = json.loads(json.dumps(d))
        for key, edits in bad.items():
            if isinstance(edits, str):
                e[key] = edits
            elif key == "alpha_x_g1":
                for i, v in edits.items():
                    e[key][2][i] = v
            else:
                for i, v in edits.items():
                    e[key][i] = v
        try:
            want = JM.Phase1Accumulator.from_json(e)
        except JM.CeremonyFormatError as err:
            with pytest.raises(M.CeremonyFormatError) as got:
                M.Phase1Accumulator.from_json(e, CPU)
            assert str(got.value) == str(err)
        else:
            got = M.Phase1Accumulator.from_json(e, CPU)
            assert json.dumps(got.to_json()) == json.dumps(want.to_json())
    # the first bad point of a file decides, off the subgroup or off the curve
    for edits, first in (({3: sub, 5: off}, sub), ({3: off, 5: sub}, off)):
        e = json.loads(json.dumps(d))
        for i, v in edits.items():
            e["x_g1"][i] = v
        with pytest.raises(M.CeremonyFormatError) as got:
            M.Phase1Accumulator.from_json(e, CPU)
        assert first[:32] in str(got.value)


def test_phase1_matches_jax(fx, tmp_path):
    """initial and compute: the JSON bytes, the proof and the hash chain of
    the JAX package; verify true for the next link, false for a link it
    does not follow and for a tampered power; the file round trip."""
    tfx, jfx = fx
    acc0, jacc0 = M.Phase1Accumulator.initial(tfx.params), JM.Phase1Accumulator.initial(jfx.params)
    assert json.dumps(acc0.to_json()) == json.dumps(jacc0.to_json())
    assert acc0.hash() == jacc0.hash()
    acc1, proof1 = acc0.compute(np.random.default_rng(1), CPU)
    jacc1, jproof1 = jacc0.compute(np.random.default_rng(1))
    assert json.dumps(acc1.to_json()) == json.dumps(jacc1.to_json())
    assert json.dumps(proof1.to_json()) == json.dumps(jproof1.to_json())
    assert acc1.hash() == jacc1.hash()
    assert acc0.verify(acc1, proof1, np.random.default_rng(5), CPU)
    assert jacc0.verify(jacc1, jproof1, np.random.default_rng(5))
    # proofs do not transfer between links, and a tampered power fails
    assert not acc1.verify(acc1, proof1, np.random.default_rng(6), CPU)
    bad = dataclasses.replace(acc1, x_g1=[acc1.x_g1[1]] + acc1.x_g1[1:])
    assert not acc0.verify(bad, proof1, np.random.default_rng(7), CPU)
    assert not jacc0.verify(bad, jproof1, np.random.default_rng(7))
    path = str(tmp_path / "acc.json")
    acc1.save(path)
    jpath = str(tmp_path / "jacc.json")
    jacc1.save(jpath)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    assert M.Phase1Accumulator.load(path, CPU).hash() == acc1.hash()
    assert M.Phase1Proof.from_json(jproof1.to_json(), CPU) == proof1

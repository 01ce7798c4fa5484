"""The port's op surface against the JAX package's, on seeded inputs.

`ops.field.fr_one`, `ops.curve.jac_infinity` / `affine_to_jac` /
`jac_sum_tree` / `unpack_jac` and `ops.poly.BiPoly.from_coeffs` / `to_ints`
(JAX `ops/field.py:103`, `ops/curve.py:24,35,69,124`, `ops/poly.py:74,87`):
limb arrays byte-equal, curve points equal as host affine points.  The port
runs on the CPU (plain versions of its kernels).  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokamak_zk_evm_tpu.ops import curve as JC
from tokamak_zk_evm_tpu.ops import field as JF
from tokamak_zk_evm_tpu.ops.poly import BiPoly as JBiPoly
from tokamak_zk_evm_tpu_torch.fields import Q_MOD, R_MOD
from tokamak_zk_evm_tpu_torch.host.curve import G1, g1_scalar_mul_affine
from tokamak_zk_evm_tpu_torch.ops import curve as TC
from tokamak_zk_evm_tpu_torch.ops import field as TF
from tokamak_zk_evm_tpu_torch.ops.poly import BiPoly as TBiPoly

# The plain versions issue many small ops; one intra-op thread per test
# process keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def u32(t):
    return np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t).astype(np.uint32)


def points(n, seed, inf_every=0):
    """n host affine points k_i G from a seed; every `inf_every`-th lane is
    infinity (None)."""
    rng = np.random.default_rng(seed)
    ks = [int(rng.integers(1, 1 << 62)) for _ in range(n)]
    return [None if inf_every and i % inf_every == 0 else g1_scalar_mul_affine(G1.gen, k)
            for i, k in enumerate(ks)]


@pytest.mark.parametrize("shape", [(), (1,), (3, 2)])
def test_fr_one_matches_jax(shape):
    got = TF.fr_one(shape, CPU)
    assert got.shape == (16,) + shape and got.dtype == torch.int32
    assert np.array_equal(u32(got), u32(JF.fr_one(shape)))


@pytest.mark.parametrize("shape", [(), (5,), (2, 3)])
def test_jac_infinity_matches_jax(shape):
    got, want = TC.jac_infinity(shape, CPU), JC.jac_infinity(shape)
    for g, w in zip(got, want):
        assert np.array_equal(u32(g), u32(w))
    assert TC.unpack_jac(got) == ([None] * int(np.prod(shape)) if shape else None)


def test_affine_to_jac_matches_jax():
    pts = points(7, 1, inf_every=3)
    got = TC.affine_to_jac(*TC.pack_affine(pts, CPU))
    want = JC.affine_to_jac(*JC.pack_affine(pts))
    for g, w in zip(got, want):
        assert np.array_equal(u32(g), u32(w))
    assert TC.unpack_jac(got) == pts


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_jac_sum_tree_matches_jax(n):
    """Odd and even widths, infinity lanes, a point and its negative, and a
    repeated point (the add's doubling lane)."""
    pts = points(n, 10 + n, inf_every=4)
    h = (n + 1) // 2  # the first level adds lane i to lane i + h
    P, Q = points(2, 99)
    if 1 + h < n:
        pts[1], pts[1 + h] = P, (P[0], (-P[1]) % Q_MOD)  # P + (-P)
    if 2 + h < n:
        pts[2], pts[2 + h] = Q, Q  # P + P
    want_host = None
    for p in pts:
        want_host = G1.add(want_host or G1.infinity, G1.from_affine(p)) if p else want_host
    want_host = None if want_host is None else G1.to_affine(want_host)
    got = TC.jac_sum_tree(TC.affine_to_jac(*TC.pack_affine(pts, CPU)))
    want = JC.jac_sum_tree(JC.affine_to_jac(*JC.pack_affine(pts)))
    assert TC.unpack_jac(got) == JC.unpack_jac(want) == want_host


def test_jac_sum_tree_over_a_trailing_batch_axis():
    """Points [24, n, m]: sums along axis 1, one per trailing lane."""
    pts = points(12, 3, inf_every=5)
    grid = lambda P: tuple(c.reshape(24, 4, 3) for c in P)  # noqa: E731
    got = TC.jac_sum_tree(grid(TC.affine_to_jac(*TC.pack_affine(pts, CPU))))
    want = JC.jac_sum_tree(grid(JC.affine_to_jac(*JC.pack_affine(pts))))
    assert TC.unpack_jac(got) == JC.unpack_jac(want)


def test_unpack_jac_on_infinities():
    """Z = 0 lanes (whatever X and Y hold) come home as None, in a batch and
    as a single point, as the JAX `unpack_jac` gives them."""
    pts = points(4, 5)
    X, Y, Z = TC.affine_to_jac(*TC.pack_affine(pts, CPU))
    Z = Z.clone()
    Z[:, 1] = 0
    Z[:, 3] = 0
    jZ = jnp.asarray(u32(Z))
    want = JC.unpack_jac((jnp.asarray(u32(X)), jnp.asarray(u32(Y)), jZ))
    got = TC.unpack_jac((X, Y, Z))
    assert got == want == [pts[0], None, pts[2], None]
    assert TC.unpack_jac((X[:, 1], Y[:, 1], Z[:, 1])) is None
    assert TC.unpack_jac((X[:, 0], Y[:, 0], Z[:, 0])) == pts[0]


@pytest.mark.parametrize("shape", [(1, 1), (4, 8), (16, 2)])
def test_bipoly_coeffs_round_trip_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    grid = [[int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(shape[1])]
            for _ in range(shape[0])]
    coeffs = TF.pack_fr(grid)
    t = TBiPoly.from_coeffs(torch.as_tensor(coeffs))
    j = JBiPoly.from_coeffs(jnp.asarray(coeffs.astype(np.uint32)))
    assert (t.x_size, t.y_size, t.x_degree, t.y_degree) == \
        (j.x_size, j.y_size, j.x_degree, j.y_degree)
    ints = t.to_ints()
    assert ints.shape == shape and np.array_equal(ints, j.to_ints())
    assert ints.tolist() == grid
    back = TBiPoly.from_ints(ints.tolist(), CPU)
    assert torch.equal(back.coeffs, t.coeffs)

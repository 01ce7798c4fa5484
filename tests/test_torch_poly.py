"""Port `BiPoly` vs the JAX package's: byte-equal coefficient grids.

Ring ops, NTT products, monomial shifts, coefficient scalings, evaluation,
and both divisions (by the vanishing polynomials, and Ruffini with and
without the lazy remainder), on random grids made from a numpy seed.
Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu.ops import poly as JP
from tokamak_zk_evm_tpu_torch.fields import R_MOD
from tokamak_zk_evm_tpu_torch.ops import poly as TP

# The plain versions issue many small ops; one intra-op thread per test
# process keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


def ints_grid(x, y, seed):
    rng = np.random.default_rng(seed)
    return [[int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(y)]
            for _ in range(x)]


def pair(x, y, seed):
    g = ints_grid(x, y, seed)
    return JP.BiPoly.from_ints(g), TP.BiPoly.from_ints(g, "cpu")


def same(jp, tp):
    a = np.asarray(jp.coeffs).astype(np.uint32)
    b = tp.coeffs.numpy().astype(np.uint32)
    return a.shape == b.shape and np.array_equal(a, b)


OPS = {
    "add": lambda p, q: p + q,
    "sub": lambda p, q: p - q,
    "mul": lambda p, q: p * q,
    "neg": lambda p, q: -p,
    "add_scalar": lambda p, q: p + 12345,
    "sub_scalar": lambda p, q: p - 777,
    "mul_scalar": lambda p, q: p.mul_scalar(R_MOD - 3),
    "mul_monomial": lambda p, q: p.mul_monomial(3, 2),
    "scale_x": lambda p, q: p.scale_coeffs_x(5),
    "scale_y": lambda p, q: p.scale_coeffs_y(9),
    "resized": lambda p, q: p.resized(3, 17),
    "optimized": lambda p, q: p.mul_monomial(0, 1).optimized(),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_bipoly_op_matches_jax(name):
    jp, tp = pair(8, 4, 1)
    jq, tq = pair(4, 8, 2)
    assert same(OPS[name](jp, jq), OPS[name](tp, tq))


def test_eval_and_eval_many_match_jax():
    jp, tp = pair(8, 16, 3)
    jq, tq = pair(4, 4, 4)
    assert tp.eval(11, 13) == jp.eval(11, 13)
    items_j = [(jp, 3, 5), (jq, 7, 9)]
    items_t = [(tp, 3, 5), (tq, 7, 9)]
    assert TP.eval_many(items_t) == JP.eval_many(items_j)


def _vanishing_numerator(lib, c, d, device=None):
    """qx*(X^c - 1) + qy*(Y^d - 1) for random qx, qy: exactly divisible."""
    kw = {} if device is None else {"device": device}
    qx = lib.BiPoly.from_ints(ints_grid(c, 2 * d, 5), **kw)
    qy = lib.BiPoly.from_ints(ints_grid(c, d, 6), **kw)
    tx = lib.BiPoly.from_ints([[R_MOD - 1]] + [[0]] * (c - 1) + [[1]], **kw)
    ty = lib.BiPoly.from_ints([[R_MOD - 1] + [0] * (d - 1) + [1]], **kw)
    return qx * tx + qy * ty


def test_div_by_vanishing_matches_jax():
    jnum = _vanishing_numerator(JP, 4, 4)
    tnum = _vanishing_numerator(TP, 4, 4, "cpu")
    assert same(jnum, tnum)
    jqx, jqy = jnum.div_by_vanishing_opt(4, 4)
    tqx, tqy = tnum.div_by_vanishing_opt(4, 4)
    assert same(jqx, tqx) and same(jqy, tqy)
    assert (tqx.x_degree, tqx.y_degree, tqy.x_degree, tqy.y_degree) == \
        (jqx.x_degree, jqx.y_degree, jqy.x_degree, jqy.y_degree)


@pytest.mark.parametrize("point", [(3, 5), (0, 7), (6, 0), (0, 0)])
@pytest.mark.parametrize("lazy", [False, True])
def test_div_by_ruffini_matches_jax(point, lazy):
    jp, tp = pair(8, 8, 7)
    jx, jy, jr = jp.div_by_ruffini(*point, lazy_rem=lazy)
    tx, ty, tr = tp.div_by_ruffini(*point, lazy_rem=lazy)
    assert same(jx, tx) and same(jy, ty)
    if lazy:
        assert np.array_equal(tr.numpy().astype(np.uint32), np.asarray(jr).astype(np.uint32))
    else:
        assert tr == jr


def test_low_degree_helpers_match_jax():
    coeffs = [5, 6, 7, 0]
    assert same(JP.low_degree_x_times_vanishing(coeffs, 8),
                TP.low_degree_x_times_vanishing(coeffs, 8, "cpu"))
    assert same(JP.low_degree_y_times_vanishing(coeffs, 4),
                TP.low_degree_y_times_vanishing(coeffs, 4, "cpu"))

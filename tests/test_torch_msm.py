"""Port MSM and curve ops vs the JAX package: the same affine points.

Every MSM at 2^4..2^10 points and at two non-power-of-two counts mixes
infinities, zero scalars, the scalar r-1 and heavily repeated points (so
buckets double and cancel), and must give the same host point as the JAX
package's MSM; so must MSMs with one hot bucket (an eighth of the lanes on
one scalar and one point) and the small sums (all zero scalars, a
cancelling pair, r-1 times one point).  The plan's digits recombine to
their scalars at every window width `msm_window_bits` picks, that width
stays in [4, 16], and its chunks match a plain model at the chunk edges.
`fixed_base_msm_points` and the jacobian ops must give the same affine
points too, and the plain fixed-base op on a 12-bit window table the same
points as host scalar muls.  Tolerance: exact (points are compared as
integers).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokamak_zk_evm_tpu.ops import curve as JC
from tokamak_zk_evm_tpu.ops import msm as JM
from tokamak_zk_evm_tpu_torch.backend import kernels as K
from tokamak_zk_evm_tpu_torch.fields import Q_MOD, R_MOD
from tokamak_zk_evm_tpu_torch.host.curve import G1, g1_scalar_mul_affine
from tokamak_zk_evm_tpu_torch.ops import curve as TC
from tokamak_zk_evm_tpu_torch.ops import msm as TM

# The plain versions issue many small ops; one intra-op thread per test
# process keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

_BASE = [g1_scalar_mul_affine(G1.gen, k) for k in (1, 2, 3, 5, 8, 13, R_MOD - 1)]


def msm_inputs(n, seed):
    rng = np.random.default_rng(seed)
    pts = [_BASE[int(i)] for i in rng.integers(0, len(_BASE), size=n)]
    ks = [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(n)]
    for i in rng.integers(0, n, size=max(1, n // 8)):
        pts[int(i)] = None
    for i in rng.integers(0, n, size=max(1, n // 8)):
        ks[int(i)] = 0
    ks[0] = R_MOD - 1
    ks[-1] = 1
    if n > 2:
        pts[1] = pts[2]  # one doubling in the same bucket for sure
        ks[1] = ks[2]
    return ks, pts


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256, 512, 1024, 100, 777])
def test_msm_matches_jax(n):
    ks, pts = msm_inputs(n, n)
    jx, jy, ji = JC.pack_affine(pts)
    want = JM.msm(JM.scalars_from_ints(ks), jx, jy, ji)
    tx, ty, ti = TC.pack_affine(pts, "cpu")
    got = TM.msm(TM.scalars_from_ints(ks, "cpu"), tx, ty, ti)
    assert got == want


def hot_bucket_inputs(n, seed):
    """Repeated points, zero scalars, infinities, the scalar r-1, and a hot
    bucket: an eighth of the lanes share one scalar (so one digit per
    window) and one point."""
    rng = np.random.default_rng(seed)
    pts = [_BASE[int(i)] for i in rng.integers(0, len(_BASE), size=n)]
    ks = [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(n)]
    for i in rng.integers(0, n, size=max(1, n // 8)):
        pts[int(i)] = None
    for i in rng.integers(0, n, size=max(1, n // 8)):
        ks[int(i)] = 0
    hot = int.from_bytes(rng.bytes(32), "little") % R_MOD
    for i in rng.integers(0, n, size=max(2, n // 8)):
        ks[int(i)], pts[int(i)] = hot, _BASE[3]
    ks[0] = R_MOD - 1
    return ks, pts


@pytest.mark.parametrize("n", [1 << 8, (1 << 10) + 3])
def test_msm_hot_bucket_matches_jax(n):
    ks, pts = hot_bucket_inputs(n, n)
    want = JM.msm(JM.scalars_from_ints(ks), *JC.pack_affine(pts))
    tx, ty, ti = TC.pack_affine(pts, "cpu")
    assert TM.msm(TM.scalars_from_ints(ks, "cpu"), tx, ty, ti) == want


@pytest.mark.parametrize("case", ["all zero scalars", "cancelling pair", "one point"])
def test_msm_small_sums(case):
    p = _BASE[2]
    ks, pts, want = {
        "all zero scalars": ([0, 0, 0], [_BASE[0], _BASE[1], None], None),
        "cancelling pair": ([9, 9], [p, (p[0], (-p[1]) % Q_MOD)], None),
        "one point": ([R_MOD - 1], [p], (p[0], (-p[1]) % Q_MOD)),
    }[case]
    tx, ty, ti = TC.pack_affine(pts, "cpu")
    assert TM.msm(TM.scalars_from_ints(ks, "cpu"), tx, ty, ti) == want


@pytest.mark.parametrize("c", range(4, 17))
def test_digits_recombine_at_every_window_width(c):
    """`_digits` at each width `msm_window_bits` can pick: every digit is
    below 2^c and sum_w d_w 2^(c w) is the scalar (0, 1, r - 1, all-ones
    and seeded scalars)."""
    n = 1 << (c + 2)
    assert K.msm_window_bits(n) == c
    rng = np.random.default_rng(c)
    ks = [0, 1, R_MOD - 1, (1 << 254) - 1, 1 << 254, (1 << c) - 1, 1 << c]
    ks += [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(9)]
    nwin = -(-255 // c)
    d = K._digits(TM.scalars_from_ints(ks, "cpu"), c, nwin)
    assert d.dtype == torch.int64 and d.shape == (nwin, len(ks))
    assert int(d.min()) >= 0 and int(d.max()) < 1 << c
    assert [sum(int(d[w, i]) << (c * w) for w in range(nwin)) for i in range(len(ks))] == ks


@pytest.mark.parametrize("n,c", [(1, 4), (127, 4), (1 << 19, 16), (10_815_960, 16)])
def test_window_bits_stay_in_the_digit_range(n, c):
    """`msm_window_bits` clamps to [4, 16]: `_digits` reads three 16-bit
    limbs a digit, so no width past 16 may reach it, even at the CRS's
    10,815,960 points."""
    assert K.msm_window_bits(n) == c


@pytest.mark.parametrize("counts", [[1], [32], [33], [64], [31, 32, 33, 64, 65],
                                    [1, 95, 96, 97, 1], [1025]])
def test_chunk_segments_match_a_plain_model(counts):
    """Segment k (counts[k] entries, laid end to end) is cut into chunks of
    at most MSM_CHUNK entries, in order: (start, length) of every chunk and
    the chunks of every segment."""
    starts, lengths, nch, first = [], [], [], 0
    for n in counts:
        cuts = list(range(0, n, K.MSM_CHUNK))
        starts += [first + c for c in cuts]
        lengths += [min(K.MSM_CHUNK, n - c) for c in cuts]
        nch.append(len(cuts))
        first += n
    start, length, per_seg = K.chunk_segments(torch.as_tensor(counts, dtype=torch.int64))
    assert all(t.dtype == torch.int64 for t in (start, length, per_seg))
    assert (start.tolist(), length.tolist(), per_seg.tolist()) == (starts, lengths, nch)


def test_msm_of_nothing_is_infinity():
    ks, pts = [0, 0, 5], [_BASE[0], _BASE[1], None]
    tx, ty, ti = TC.pack_affine(pts, "cpu")
    assert TM.msm(TM.scalars_from_ints(ks, "cpu"), tx, ty, ti) is None


def test_msm_cancellation_gives_infinity():
    p = _BASE[3]
    neg = (p[0], (-p[1]) % Q_MOD)
    tx, ty, ti = TC.pack_affine([p, neg], "cpu")
    assert TM.msm(TM.scalars_from_ints([9, 9], "cpu"), tx, ty, ti) is None


def test_plain_stages_agree_with_msm_plan():
    ks, pts = msm_inputs(300, 3)
    tx, ty, ti = TC.pack_affine(pts, "cpu")
    s = TM.scalars_from_ints(ks, "cpu")
    rows = K.g1_msm_finish(K.plain_g1_msm_start(s, tx, ty, ti))
    assert TM.msm_finish(K.g1_msm_start(s, tx, ty, ti)) == TM.msm(s, tx, ty, ti)
    assert rows.shape == (3, 24)


def test_scalars_from_mont_matches_jax():
    rng = np.random.default_rng(4)
    vals = [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(9)]
    from tokamak_zk_evm_tpu.ops import field as JF
    from tokamak_zk_evm_tpu_torch.ops import field as TF

    want = np.asarray(JM.scalars_from_mont(jnp.asarray(JF.pack_fr(vals))))
    got = TM.scalars_from_mont(torch.as_tensor(TF.pack_fr(vals)))
    assert np.array_equal(got.numpy().astype(np.uint32), want.astype(np.uint32))


@pytest.mark.parametrize("n", [5, 40])
def test_fixed_base_points_match_jax(n):
    rng = np.random.default_rng(n)
    ks = [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(n)]
    ks[0] = 0
    ks[1] = 1
    want = JC.unpack_affine(JM.fixed_base_msm_points(ks, G1.gen))
    got = TC.unpack_affine(TM.fixed_base_msm_points(ks, G1.gen, "cpu"))
    assert got == want
    assert got[2] == g1_scalar_mul_affine(G1.gen, ks[2])


def test_window_scalars_are_the_table_multiples():
    """Column (w << 12) + d of the wide table's build scalars is d 2^(12 w)
    mod r, canonical limbs (the top window reaches past r)."""
    from tokamak_zk_evm_tpu_torch.fields import FR

    sc = K._window_scalars(12)
    assert sc.shape == (16, 22 * 4096)
    for w, d in [(0, 0), (0, 4095), (1, 1), (10, 2049), (20, 4095), (21, 7), (21, 8), (21, 4095)]:
        assert FR.from_limbs(sc[:, (w << 12) + d].tolist()) == (d << (12 * w)) % R_MOD


@pytest.mark.parametrize("bits", [8, 12])
def test_plain_fixed_base_window_width(bits):
    """plain_g1_fixed_base at 8 and 12 bits against host scalar muls, on a
    table that holds host multiples at the digits these scalars use (zeros
    elsewhere): 0, 1, r - 1, all-ones 12-bit digits, a nonzero top window
    alone, repeated and random scalars."""
    from tokamak_zk_evm_tpu_torch.fields import FR

    rng = np.random.default_rng(bits)
    ks = [0, 1, R_MOD - 1, (1 << 252) - 1, 1 << 252, 7 << 252, 5, 5]
    ks += [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(4)]
    nwin, size = K.fixed_base_windows(bits), 1 << bits
    xs, ys = [0] * (nwin * size), [0] * (nwin * size)
    for k in ks:
        for w in range(nwin):
            d = (k >> (bits * w)) & (size - 1)
            if d:
                xs[w * size + d], ys[w * size + d] = g1_scalar_mul_affine(G1.gen, d << (bits * w))
    from tokamak_zk_evm_tpu_torch.ops import field as TF

    table = K.pack_points(torch.as_tensor(TF.pack_fq(xs)), torch.as_tensor(TF.pack_fq(ys)))
    sc = torch.as_tensor(np.array([FR.to_limbs(k) for k in ks], np.int32).T.copy())
    got = TC.unpack_affine(TC.jac_to_affine(K.g1_fixed_base(sc, table)))
    assert got == [g1_scalar_mul_affine(G1.gen, k) if k else None for k in ks]


def jax_jac(pts):
    return JC.affine_to_jac(*JC.pack_affine(pts))


def port_jac(pts):
    """Host affine points -> port jacobian tensors (Z = 1, or 0 at infinity)."""
    from tokamak_zk_evm_tpu_torch.ops import field as TF

    x, y, inf = TC.pack_affine(pts, "cpu")
    one = torch.as_tensor(TF.pack_fq([1])).expand_as(x)
    z = torch.where(inf[None].bool(), torch.zeros_like(one), one)
    return x, y, z.contiguous()


@pytest.mark.parametrize("op", ["add", "double"])
def test_jacobian_ops_match_jax(op):
    a = [_BASE[0], _BASE[1], None, _BASE[2], _BASE[3], None]
    b = [_BASE[0], _BASE[4], _BASE[5], None, (_BASE[3][0], (-_BASE[3][1]) % Q_MOD), None]
    if op == "add":
        want = JC.jac_to_affine(JC.jac_add(jax_jac(a), jax_jac(b)))
        got = TC.jac_to_affine(TC.jac_add(port_jac(a), port_jac(b)))
    else:
        want = JC.jac_to_affine(JC.jac_double(jax_jac(a)))
        got = TC.jac_to_affine(TC.jac_double(port_jac(a)))
    assert TC.unpack_affine(got) == JC.unpack_affine(want)


"""K4's MSM stages in their plain versions, against host-integer curve sums
and against the JAX package's MSM.

The stages take points packed point-major (`kernels.pack_points`).  The
bucket sums (bounded chunks, then the chunk partials again) and every
level of the window reduce are held against sums of host points with every
hard case planted: one hot bucket of many chunks, a point added to itself,
P and -P in one bucket, infinity bases and zero digits (which the plan
drops), empty buckets and infinite bucket sums.  Tolerance: exact (points
are compared as affine integers).
"""

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu.ops import curve as JC
from tokamak_zk_evm_tpu.ops import msm as JM
from tokamak_zk_evm_tpu_torch.backend import kernels as K
from tokamak_zk_evm_tpu_torch.fields import FQ, Q_MOD, R_MOD
from tokamak_zk_evm_tpu_torch.host.curve import G1, g1_scalar_mul_affine
from tokamak_zk_evm_tpu_torch.ops import curve as TC
from tokamak_zk_evm_tpu_torch.ops import msm as TM

torch.set_num_threads(1)

_BASE = [g1_scalar_mul_affine(G1.gen, k) for k in (1, 2, 3, 5, 8, 13, 21, R_MOD - 1)]


def neg(p):
    return (p[0], (-p[1]) % Q_MOD)


def host_sum(pts):
    acc = G1.infinity
    for p in pts:
        if p is not None:
            acc = G1.add(acc, G1.from_affine(p))
    return G1.to_affine(acc)


def host_mul(k, p):
    return None if p is None or k == 0 else G1.to_affine(G1.scalar_mul(G1.from_affine(p), k))


def packed_jac(pts):
    """Host affine points (None = infinity) -> packed jacobian [n, 36]."""
    x, y, inf = TC.pack_affine(pts, "cpu")
    one = torch.as_tensor(np.asarray(FQ.to_limbs(FQ.R_mod), np.int32)[:, None]).expand_as(x)
    z = torch.where(inf[None].bool(), torch.zeros_like(one), one)
    return K.pack_points(x, y, z.contiguous())


def host_points(packed):
    """Packed jacobian [n, 36] -> host affine points."""
    X, Y, Z = K.unpack_points(packed, 3)
    f = lambda c, i: FQ.from_mont(FQ.from_limbs(c[:, i].tolist()))  # noqa: E731
    return [G1.to_affine((f(X, i), f(Y, i), f(Z, i))) for i in range(X.shape[1])]


def test_pack_round_trip():
    rng = np.random.default_rng(0)
    cols = [torch.as_tensor(rng.integers(0, 1 << 16, size=(24, 7)).astype(np.int32))
            for _ in range(3)]
    packed = K.pack_points(*cols)
    assert packed.shape == (7, 36) and packed.dtype == torch.int32
    assert all(torch.equal(a, b) for a, b in zip(K.unpack_points(packed, 3), cols))


def planted_buckets():
    """Bucket contents (host affine points, all finite): a hot bucket of 150
    entries (five chunks, so a second pass sums the partials), P + P, P + (-P),
    P + P + (-P), 2P - P - P, a single point and two distinct points."""
    rng = np.random.default_rng(1)
    P, Q = _BASE[2], _BASE[4]
    hot = [_BASE[int(i)] for i in rng.integers(0, len(_BASE), size=150)]
    return [hot, [P, P], [P, neg(P)], [P, P, neg(P)], [Q, Q, neg(Q), neg(Q), Q],
            [P], [P, Q], [neg(Q)] * 33]


@pytest.mark.parametrize("chunk", [32, 4])
def test_bucket_sums_match_host(chunk, monkeypatch):
    monkeypatch.setattr(K, "MSM_CHUNK", chunk)
    buckets = planted_buckets()
    flat = [p for b in buckets for p in b]
    x, y, _ = TC.pack_affine(flat[::-1], "cpu")  # entries point at reversed rows
    pts = K.pack_points(x, y)
    pidx = torch.arange(len(flat) - 1, -1, -1, dtype=torch.int64)
    counts = torch.as_tensor([len(b) for b in buckets], dtype=torch.int64)
    sums = K.segment_sums(K.plain_msm_bucket_sum, 0, pts, pidx, counts)
    assert host_points(sums) == [host_sum(b) for b in buckets]
    start, length, _ = K.chunk_segments(counts)
    assert int(length.max()) <= chunk and int(length.min()) >= 1
    part = K.plain_msm_bucket_sum(0, pts, pidx, start, length)
    want = [host_sum(flat[s:s + n]) for s, n in zip(start.tolist(), length.tolist())]
    assert host_points(part) == want


def window_inputs(nwin, nb, seed):
    """Sparse bucket sums under ascending keys, with empty buckets, equal
    neighbours (the running total doubles), P and -P, and infinite sums."""
    rng = np.random.default_rng(seed)
    keys = sorted(rng.choice(nwin * nb, size=nwin * nb // 2, replace=False).tolist())
    keys = [k for k in keys if k % nb]  # digit 0 never has a bucket
    pts = [_BASE[int(i)] for i in rng.integers(0, len(_BASE), size=len(keys))]
    for i in range(0, len(pts) - 1, 7):
        pts[i + 1] = pts[i]
    for i in range(3, len(pts) - 1, 11):
        pts[i + 1] = neg(pts[i])
    for i in range(5, len(pts), 13):
        pts[i] = None
    return keys, pts


@pytest.mark.parametrize("nwin,nb", [(3, 16), (2, 64), (2, 256)])
def test_window_reduce_levels_match_host(nwin, nb):
    keys, pts = window_inputs(nwin, nb, nb)
    want = []
    for w in range(nwin):
        acc = G1.infinity
        for k, p in zip(keys, pts):
            if k // nb == w and p is not None:
                acc = G1.add(acc, G1.scalar_mul(G1.from_affine(p), k % nb))
        want.append(G1.to_affine(acc))
    kt = torch.as_tensor(keys, dtype=torch.int64)
    got = K.window_sums(K.plain_msm_window_reduce, packed_jac(pts), kt, nwin, nb)
    assert host_points(got) == want
    # one level with a lower level's R and a shift: R = sum rsum +
    # sum (b - lo) B_b, S = 2^shift sum B_b per segment of 8 keys
    rng = np.random.default_rng(nb + 1)
    rs = [_BASE[int(i)] for i in rng.integers(0, len(_BASE), size=len(keys))]
    r, s = K.plain_msm_window_reduce(packed_jac(pts), packed_jac(rs), kt, nwin * nb // 8, 8, 3)
    want_r, want_s = [], []
    for t in range(nwin * nb // 8):
        mine = [(k - 8 * t, p, q) for k, p, q in zip(keys, pts, rs) if k // 8 == t]
        want_s.append(host_sum([host_mul(8, p) for _, p, _ in mine]))
        want_r.append(host_sum([host_mul(b, p) for b, p, _ in mine] + [q for _, _, q in mine]))
    assert host_points(s) == want_s
    assert host_points(r) == want_r


@pytest.mark.parametrize("seg,seg_up", [(8, 2), (4, 4)])
def test_window_sums_segment_choices(seg, seg_up):
    """Every choice of buckets a thread gives the same window sums."""
    nwin, nb = 2, 64
    keys, pts = window_inputs(nwin, nb, 5)
    want = [host_sum([host_mul(k % nb, p) for k, p in zip(keys, pts) if k // nb == w])
            for w in range(nwin)]
    kt = torch.as_tensor(keys, dtype=torch.int64)
    got = K.window_sums(K.plain_msm_window_reduce, packed_jac(pts), kt, nwin, nb, seg, seg_up)
    assert host_points(got) == want


def stage_inputs(n, seed, skew):
    """MSM inputs with infinity bases, zero scalars, r - 1, P + P and P + (-P)
    under equal scalars; skew: 80% of the scalars are 1 (one hot bucket),
    the rest small."""
    rng = np.random.default_rng(seed)
    pts = [_BASE[int(i)] for i in rng.integers(0, len(_BASE), size=n)]
    if skew:
        ks = [1 if rng.random() < 0.8 else int(rng.integers(0, 1 << 12)) for _ in range(n)]
    else:
        ks = [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(n)]
    for i in rng.integers(0, n, size=max(1, n // 8)):
        pts[int(i)] = None
    for i in rng.integers(0, n, size=max(1, n // 8)):
        ks[int(i)] = 0
    ks[0] = R_MOD - 1
    pts[1] = pts[2] = pts[3] = _BASE[5]
    pts[4] = neg(_BASE[5])
    ks[2] = ks[1]
    ks[4] = ks[3]
    return ks, pts


@pytest.mark.parametrize("n,skew", [(64, False), (300, True), (515, False), (1024, True)])
def test_plain_stages_match_jax_and_host(n, skew):
    ks, pts = stage_inputs(n, n, skew)
    tx, ty, ti = TC.pack_affine(pts, "cpu")
    s = TM.scalars_from_ints(ks, "cpu")
    c, nwin, pidx, bucket, counts = K.msm_plan(s, ti)
    live = {i for i, (k, p) in enumerate(zip(ks, pts)) if k and p is not None}
    assert set(pidx.tolist()) <= live  # zero digits and infinity bases dropped
    got = TM.msm_finish(K.plain_g1_msm_start(s, tx, ty, ti))
    jx, jy, ji = JC.pack_affine(pts)
    assert got == JM.msm(JM.scalars_from_ints(ks), jx, jy, ji)
    want = G1.infinity
    for k, p in zip(ks, pts):
        if p is not None:
            want = G1.add(want, G1.scalar_mul(G1.from_affine(p), k))
    assert got == G1.to_affine(want)

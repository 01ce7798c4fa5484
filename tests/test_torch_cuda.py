"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Each test launches a kernel through its wrapper on CUDA tensors and
compares it with the plain version on the same tensors (exact).  Without an
NVIDIA GPU every test here skips; run them on one with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest`: the repository's conftest imports JAX, which the GPU
machine need not have; the `cuda` marker is not registered there, so pytest
warns about it).  `python3 chip_smoke.py` runs the same checks at the main
path's shapes.
"""

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu_torch.backend import kernels as K
from tokamak_zk_evm_tpu_torch.fields import FQ, FR
from tokamak_zk_evm_tpu_torch.host.curve import G1
from tokamak_zk_evm_tpu_torch.ops import ntt as NT

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def rand(spec, n, seed, dev):
    rng = np.random.default_rng(seed)
    L = spec.n_limbs
    lim = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    lim[L - 1] = rng.integers(0, spec.modulus >> (16 * (L - 1)), size=n)
    lim[:, 0] = 0
    return torch.as_tensor(lim.astype(np.int32), device=dev)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg"])
@pytest.mark.parametrize("field", [0, 1])
def test_field_ew_kernel(dev, field, op):
    spec = (FR, FQ)[field]
    a, b = rand(spec, 1000, 1, dev), rand(spec, 10, 2, dev)
    if op == "neg":
        assert torch.equal(K._field_ew(field, op, a), K.plain_field_ew(field, op, a))
    else:
        assert torch.equal(K._field_ew(field, op, a, b, 100),
                           K.plain_field_ew(field, op, a, b, 100))


@pytest.mark.parametrize("field", [0, 1])
def test_inversion_kernels(dev, field):
    spec = (FR, FQ)[field]
    a = rand(spec, 70000, 3, dev)
    assert torch.equal(K.field_inv(field, a[:, :500].contiguous()),
                       K.plain_field_inv(field, a[:, :500].contiguous()))
    assert torch.equal(K.batch_inv(field, a), K.plain_batch_inv(field, a))


@pytest.mark.parametrize("width", ["1", "2", "each", "each+1", "each+tile+1"])
@pytest.mark.parametrize("field", [0, 1])
def test_batch_inversion_widths(dev, field, width):
    """Either side of the one-launch width and past a tile, zeros at tile
    and warp edges: kernel == plain, one launch or three."""
    spec = (FR, FQ)[field]
    each = K.BINV_EACH[field]
    tile = K.BINV_THREADS * K.binv_per_thread(field, each + 1)
    n = {"1": 1, "2": 2, "each": each, "each+1": each + 1, "each+tile+1": each + tile + 1}[width]
    a = rand(spec, n + 1, 4, dev)[:, 1:].contiguous()
    if n > 2:
        edges = [e for b in range(0, n, tile) for e in (b, b + tile - 1, b + 31, b + 32) if e < n]
        a[:, edges] = 0
    before = K.BATCH_INV.launches + K.FIELD_INV.launches
    got = K.batch_inv(field, a)
    assert K.BATCH_INV.launches + K.FIELD_INV.launches - before == (1 if n <= each else 3)
    assert torch.equal(got, K.plain_batch_inv(field, a))


@pytest.mark.parametrize("width", ["1", "tile-1", "tile", "tile+1", "2^20"])
@pytest.mark.parametrize("reverse", [False, True])
def test_fr_scan_kernel(dev, reverse, width):
    """B6 prefix and suffix against the plain scan, exact, one launch up to
    a tile and three past it, with zeros at thread, warp and tile edges in
    the second half of the scan order (the first half's outputs stay
    nonzero)."""
    tile = K.SCAN_TILE
    n = {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1, "2^20": 1 << 20}[width]
    a = rand(FR, n + 1, 5, dev)[:, 1:].contiguous()
    for b in range(0, n, tile):
        for e in (b + 7, b + 8, b + 255, b + 256, b + tile - 1):
            if e < n and (e >= n // 2) != reverse:
                a[:, e] = 0
    before = K.FR_SCAN.launches
    got = K.fr_scan(a, reverse)
    assert K.FR_SCAN.launches - before == (1 if n <= tile else 3)
    assert torch.equal(got, K.plain_fr_scan(a, reverse))


def test_dist_ops_nccl_world_one(dev, tmp_path):
    """`bintt_dist` and `msm_dist` on a one-rank NCCL group (the real
    collectives) against `ops.ntt.bintt` and the MSM."""
    import torch.distributed as dist

    from tokamak_zk_evm_tpu_torch.ops import msm as TM
    from tokamak_zk_evm_tpu_torch.parallel import mesh as PM
    from tokamak_zk_evm_tpu_torch.parallel import msm_dist, ntt_dist

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = PM.make_mesh()
        PM.reset_counts()
        grid = rand(FR, 256 * 64, 9, dev).reshape(16, 256, 64)
        for inverse in (False, True):
            assert torch.equal(ntt_dist.bintt_dist(grid, mesh, inverse),
                               NT.bintt(grid, inverse=inverse))
        k = rand(FR, 4096, 10, dev)
        fam = TM.fixed_base_msm_points(list(range(1, 4097)), G1.gen, dev)
        assert msm_dist.msm_dist(k, *fam, mesh) == TM.msm(k, *fam)
        assert PM.counts()["bintt_dist"] == 2 and PM.counts()["msm_dist"] == 1
    finally:
        dist.destroy_process_group()


def plain_ntt_axis(data, axis, inverse, coset):
    """`ops.ntt.ntt_axis` through the plain versions of K1 and K3."""
    n = data.shape[axis]
    rep = data.shape[2] if axis == 1 else 1

    def times(g, c):
        flat = g.reshape(16, -1)
        return K.plain_field_ew(0, "mul", flat, NT._coset_table(n, c, g.device), rep).reshape(g.shape)

    if coset is not None and not inverse:
        data = times(data, coset)
    out = K.plain_ntt(data, *NT._tables(n, inverse, data.device), axis)
    return times(out, pow(coset, -1, FR.modulus)) if coset is not None and inverse else out


@pytest.mark.parametrize("coset", [None, 7])
@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("logn", range(1, 15))
def test_ntt_kernel(dev, logn, axis, coset):
    """K3 along either axis of [16, X, Y], one pass or two, forward and
    inverse, into a new grid and in place, against `plain_ntt`; with a
    coset, `ops.ntt.ntt_axis` (K1 and K3) against the plain versions of
    both.  The other axis cycles through 1 (a univariate grid), 5, 64 and
    512."""
    n, other = 1 << logn, (1, 5, 64, 512)[logn % 4]
    shape = (other, n) if axis == 2 else (n, other)
    data = rand(FR, shape[0] * shape[1], 4 + logn, dev).reshape((16,) + shape)
    for inverse in (False, True):
        want = plain_ntt_axis(data, axis, inverse, coset)
        assert torch.equal(NT.ntt_axis(data, axis, inverse, coset), want)
        if coset is None:
            pows, scale = NT._tables(n, inverse, dev)
            over = data.clone()
            assert K.fr_ntt(over, pows, scale, axis, inplace=True) is over
            assert torch.equal(over, want)


@pytest.mark.parametrize("shape,axis", [((4, 1 << 20), 2), ((1 << 22, 1), 1),
                                        ((1 << 16, 64), 1), ((1 << 18, 16), 1)])
def test_ntt_kernel_long(dev, shape, axis):
    """Transforms past 16384 points, to the ceiling of 2^22: rows whose
    second pass takes more than 256 points, and columns whose tiles span
    fewer than 16 columns."""
    data = rand(FR, shape[0] * shape[1], 40, dev).reshape((16,) + shape)
    for inverse in (False, True):
        pows, scale = NT._tables(data.shape[axis], inverse, dev)
        assert torch.equal(K.fr_ntt(data, pows, scale, axis), K.plain_ntt(data, pows, scale, axis))


def _affine_cols(packed):
    """Packed jacobian [n, 36] -> host affine points (None = infinity)."""
    X, Y, Z = (c.cpu() for c in K.unpack_points(packed, 3))
    return [G1.to_affine(tuple(FQ.from_mont(FQ.from_limbs(c[:, i].tolist())) for c in (X, Y, Z)))
            for i in range(X.shape[1])]


def _affine_jac(P):
    """Jacobian [24, B] x 3 -> host affine points (None = infinity)."""
    X, Y, Z = (c.cpu() for c in P)
    return [G1.to_affine(tuple(FQ.from_mont(FQ.from_limbs(c[:, i].tolist())) for c in (X, Y, Z)))
            for i in range(X.shape[1])]


def test_fixed_base_kernel(dev):
    """The fixed-base kernel on the 12-bit table built on the card == the
    plain version on the 8-bit table == host scalar muls (affine points),
    with planted scalars: 0, 1, r - 1, all-ones digits, a nonzero top (3-bit)
    window alone, repeated scalars; and the wide table's entries == host
    scalar muls on a sample."""
    from tokamak_zk_evm_tpu_torch.fields import R_MOD
    from tokamak_zk_evm_tpu_torch.host.curve import g1_scalar_mul_affine

    rng = np.random.default_rng(10)
    ks = [0, 1, R_MOD - 1, (1 << 252) - 1] + [d << 252 for d in range(1, 8)]
    ks += [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(300)]
    ks += ks[5:60] + [ks[20]] * 9
    sc = torch.as_tensor(np.array([FR.to_limbs(k) for k in ks], np.int32).T.copy(), device=dev)
    wide = K.fixed_base_table(*G1.gen, dev)
    got = _affine_jac(K.g1_fixed_base(sc, wide))
    assert got == _affine_jac(K.plain_g1_fixed_base(sc, K.fixed_base_table(*G1.gen, dev, 8), 8))
    assert got[:40] == [g1_scalar_mul_affine(G1.gen, k) if k else None for k in ks[:40]]
    X, Y = (c.cpu() for c in K.unpack_points(wide, 2))
    for e in [0, 1, 4095, 4096, 21 * 4096, 21 * 4096 + 7] + rng.integers(0, 22 * 4096, 24).tolist():
        w, d = divmod(int(e), 4096)
        x, y = (FQ.from_mont(FQ.from_limbs(c[:, e].tolist())) for c in (X, Y))
        want = g1_scalar_mul_affine(G1.gen, (d << (12 * w)) % R_MOD) if d else None
        assert (None if x == y == 0 else (x, y)) == want


@pytest.mark.parametrize("scalars", ["uniform", "skewed"])
def test_g1_kernels(dev, scalars):
    """Fixed-base kernel against the plain version (affine points: the
    jacobian representatives may differ) and the MSM against the plain
    versions, and each MSM stage kernel against its plain version.
    "skewed": small witness-like scalars (most of them 1), so one bucket
    holds most entries and the bucket sum runs a second pass over its
    chunks."""
    table = K.fixed_base_table(*G1.gen, dev)
    sc = rand(FR, 300, 5, dev)
    jac = K.g1_fixed_base(sc, table)
    assert _affine_jac(jac) == _affine_jac(K.plain_g1_fixed_base(sc, table, K.FIXED_BASE_BITS))
    px, py, pinf = K.g1_to_affine(jac)
    if scalars == "skewed":
        rng = np.random.default_rng(9)
        small = np.where(rng.random(300) < 0.8, 1, rng.integers(0, 1 << 12, size=300))
        sc = torch.zeros_like(sc)
        sc[0] = torch.as_tensor(small.astype(np.int32), device=dev)
    got = K.g1_msm(sc, px, py, pinf)
    want = K.g1_msm_finish(K.plain_g1_msm_start(sc, px, py, pinf))
    def aff(rows):
        X, Y, Z = (FQ.from_mont(FQ.from_limbs(r.tolist())) for r in rows)
        return G1.to_affine((X, Y, Z))
    assert aff(got) == aff(want)
    c, nwin, pidx, bucket, counts = K.msm_plan(sc, pinf)
    pts = K.pack_points(px, py)
    start, length, _ = K.chunk_segments(counts)
    assert (_affine_cols(K.msm_bucket_sum(0, pts, pidx, start, length))
            == _affine_cols(K.plain_msm_bucket_sum(0, pts, pidx, start, length)))
    sums = K.segment_sums(K.msm_bucket_sum, 0, pts, pidx, counts)
    nb = 1 << c
    rsum, keys, seg = None, bucket, K.MSM_SEG
    while True:  # every level of the window reduce, each from the same inputs
        seg = min(seg, nb)
        nseg = nwin * nb // seg
        shift = 0 if nseg == nwin else seg.bit_length() - 1
        r, s = K.msm_window_reduce(sums, rsum, keys, nseg, seg, shift)
        pr, ps = K.plain_msm_window_reduce(sums, rsum, keys, nseg, seg, shift)
        assert _affine_cols(r) == _affine_cols(pr) and _affine_cols(s) == _affine_cols(ps)
        if nseg == nwin:
            break
        rsum, sums, keys = r, s, torch.arange(nseg, device=dev)
        nb //= seg
        seg = K.MSM_SEG_UP


def planted_affine(n, seed, dev):
    """Two [24, n] affine operand batches cycling through P+Q, P+P, P+(-P),
    inf+Q, P+inf and inf+inf ((0, 0) = infinity), points k G for small k."""
    from tokamak_zk_evm_tpu_torch.fields import Q_MOD
    from tokamak_zk_evm_tpu_torch.host.curve import g1_scalar_mul_affine
    from tokamak_zk_evm_tpu_torch.ops import curve as TC

    rng = np.random.default_rng(seed)
    base = [g1_scalar_mul_affine(G1.gen, k) for k in range(1, 40)]
    a, b = [], []
    for i in range(n):
        P, Q = (base[int(j)] for j in rng.choice(len(base), size=2, replace=False))
        case = i % 6
        a.append(None if case in (3, 5) else P)
        b.append({0: Q, 1: P, 2: (P[0], (-P[1]) % Q_MOD), 3: Q}.get(case))
    x1, y1, _ = TC.pack_affine(a, dev)
    x2, y2, _ = TC.pack_affine(b, dev)
    return x1, y1, x2, y2


def test_affine_add_kernels(dev):
    x1, y1, x2, y2 = planted_affine(3000, 6, dev)
    den = K.aff_pre(x1, y1, x2, y2)
    assert torch.equal(den, K.plain_aff_pre(x1, y1, x2, y2))
    dinv = K.fq_batch_inv(den)
    got = K.aff_post(x1, y1, x2, y2, dinv)
    want = K.plain_aff_post(x1, y1, x2, y2, dinv)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_affine_tree_matches_pippenger(dev):
    from tokamak_zk_evm_tpu_torch.ops import msm as TM

    n = 1 << 16
    table = K.fixed_base_table(*G1.gen, dev)
    c = rand(FR, n, 7, dev)
    c[1:] = 0
    c[0] %= 997  # few distinct points: repeats and a few infinities
    px, py, pinf = K.g1_to_affine(K.g1_fixed_base(c, table))
    sc = rand(FR, n, 8, dev)
    want = TM.msm(sc, px, py, pinf)
    with TM.use_core("affine_tree"):
        assert TM.msm(sc, px, py, pinf) == want


@pytest.mark.parametrize("shape,axis", [((3, 1 << 12), 2), ((1 << 12, 5), 1)])
def test_ntt_past_two_passes(dev, shape, axis, monkeypatch):
    """`fr_ntt` past `NTT_MAX_N` runs the four-step split (two K3 calls and
    a K1 twiddle product), here at 2^12 points with the ceiling lowered to
    2^10 so that the split runs on a small grid (`chip_smoke.py` phase 3
    runs it at 2^23)."""
    n = shape[axis - 1]
    monkeypatch.setattr(K, "NTT_MAX_N", 1 << 10)
    data = rand(FR, shape[0] * shape[1], 41, dev).reshape((16,) + shape)
    for inverse in (False, True):
        pows, scale = NT._tables.__wrapped__(n, inverse, dev)
        before = K.NTT.launches
        got = K.fr_ntt(data, pows, scale, axis)
        assert K.NTT.launches - before >= 2
        assert torch.equal(got, K.plain_ntt(data, pows, scale, axis))
        assert torch.equal(K.ntt_split(data, pows, scale, axis, 8), got)


@pytest.mark.parametrize("rep", [1, 3])
def test_curve_ops_planted(dev, rep):
    """g1_add / g1_dbl / g1_to_affine on the card == their plain versions,
    with P+Q, P+P, P+(-P), inf+Q, P+inf, inf+inf lanes, jacobian inputs with
    Z != 1, and (rep 3) the second operand broadcast."""
    from tokamak_zk_evm_tpu_torch.fields import Q_MOD
    from tokamak_zk_evm_tpu_torch.host.curve import g1_scalar_mul_affine
    from tokamak_zk_evm_tpu_torch.ops import curve as TC

    rng = np.random.default_rng(8 + rep)
    base = [g1_scalar_mul_affine(G1.gen, int(k)) for k in rng.integers(1, 1 << 40, size=12)]
    a, b = [], []
    for i in range(36):
        p, q = base[i % 12], base[(i * 5 + 1) % 12]
        case = i % 6
        a.append(None if case in (3, 5) else p)
        b.append({1: p, 2: (p[0], (-p[1]) % Q_MOD), 4: None, 5: None}.get(case, q))
    P = K.plain_g1_dbl(TC.affine_to_jac(*TC.pack_affine(a, dev)))
    Q = K.plain_g1_dbl(TC.affine_to_jac(*TC.pack_affine(b, dev)))
    if rep > 1:
        Q = tuple(c[:, : 36 // rep].contiguous() for c in Q)
    got, want = K.g1_add(P, Q, rep=rep), K.plain_g1_add(P, Q, rep=rep)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(K.g1_dbl(P), K.plain_g1_dbl(P)))
    assert all(torch.equal(g, w) for g, w in zip(K.g1_to_affine(got), K.plain_g1_to_affine(got)))
    if rep == 1:
        want = [G1.to_affine(G1.add(G1.double(G1.from_affine(p)), G1.double(G1.from_affine(q))))
                for p, q in zip(a, b)]
        assert _affine_jac(got) == want


def test_b13_kernels_one_launch_raw_infinity(dev):
    """B13's add, doubling and affine kernels: one launch each, and equal to
    the plain versions on raw `affine_to_jac` inputs, whose infinities are
    (0, 0, 0) (inf + inf with two representations, P + inf, inf + Q, P + P
    and P + (-P) at Z = 1), and at 5000 lanes (past one block)."""
    from tokamak_zk_evm_tpu_torch.fields import Q_MOD
    from tokamak_zk_evm_tpu_torch.host.curve import g1_scalar_mul_affine
    from tokamak_zk_evm_tpu_torch.ops import curve as TC

    rng = np.random.default_rng(21)
    base = [g1_scalar_mul_affine(G1.gen, int(k)) for k in rng.integers(1, 1 << 40, size=16)]
    a, b = [], []
    for i in range(5000):
        p, q = base[i % 16], base[(i * 7 + 3) % 16]
        case = i % 6
        a.append(None if case in (3, 5) else p)
        b.append({1: p, 2: (p[0], (-p[1]) % Q_MOD), 4: None, 5: None}.get(case, q))
    P = TC.affine_to_jac(*TC.pack_affine(a, dev))
    Q = TC.affine_to_jac(*TC.pack_affine(b, dev))
    Q2 = K.g1_dbl(Q)  # infinities now (1, 1, 0)
    counts = {k: k.launches for k in (K.G1_ADD, K.G1_DBL, K.G1_TO_AFFINE)}
    for q in (Q, Q2):
        got = K.g1_add(P, q)
        assert all(torch.equal(g, w) for g, w in zip(got, K.plain_g1_add(P, q)))
        assert all(torch.equal(g, w) for g, w in zip(K.g1_to_affine(got), K.plain_g1_to_affine(got)))
    assert all(torch.equal(g, w) for g, w in zip(K.g1_dbl(P), K.plain_g1_dbl(P)))
    assert {k: k.launches - n for k, n in counts.items()} == {K.G1_ADD: 2, K.G1_DBL: 1,
                                                               K.G1_TO_AFFINE: 2}
    want = [G1.to_affine(G1.add(G1.from_affine(p), G1.double(G1.from_affine(q))))
            for p, q in zip(a[:60], b[:60])]
    assert _affine_jac(tuple(c[:, :60] for c in K.g1_add(P, Q2))) == want


def _mpc_points(n, seed, dev):
    from tokamak_zk_evm_tpu_torch.host.curve import g1_scalar_mul_affine
    from tokamak_zk_evm_tpu_torch.ops import curve as TC

    rng = np.random.default_rng(seed)
    pts = [g1_scalar_mul_affine(G1.gen, int(k)) for k in rng.integers(1, 1 << 50, size=n)]
    pts[1] = None
    return TC.pack_affine(pts, dev)


@pytest.mark.parametrize("windows", ["4-bit", "1-bit"])
def test_ceremony_multiplier_on_card(dev, windows, monkeypatch):
    """The ceremony's multiplier (B13's kernels) on the card == the CPU
    port: one scalar a lane (0, 1, r-1, r planted), one shared scalar, and
    the outer layout of xy_powers (a point for each run of lanes, the scalar
    table cycling), at 4-bit windows and, with the table limit lowered, at
    1-bit ones (every window gathered)."""
    from tokamak_zk_evm_tpu_torch.fields import R_MOD
    from tokamak_zk_evm_tpu_torch.models import mpc_setup as M

    if windows == "1-bit":
        monkeypatch.setattr(M, "_WINDOW_POINTS", 1)
    rng = np.random.default_rng(33)
    n = 64
    ks = [0, 1, R_MOD - 1, R_MOD] + [int.from_bytes(rng.bytes(32), "little") % R_MOD
                                    for _ in range(n - 4)]
    pts = {d: _mpc_points(n, 34, d) for d in ("cpu", dev)}

    def run(d):
        per_lane = M._g1_mul_many(pts[d], ks)
        shared = M._g1_mul_many(pts[d], ks[7])
        lanes = torch.arange(16 * 8, device=d)
        outer = M._mul_jobs([(M._jac(tuple(c[..., :16] for c in pts[d])), ks[4:12], lanes % 8,
                              lanes // 8)])[0]
        return per_lane + shared + tuple(outer)

    for got, want in zip(run(dev), run("cpu")):
        assert torch.equal(got.cpu(), want)


def test_group_lagrange_on_card(dev):
    """Inverse group NTTs of sizes 8 (two side by side) and 32 on the card
    == the CPU port."""
    from tokamak_zk_evm_tpu_torch.models import mpc_setup as M

    def run(d):
        a, b = _mpc_points(16, 35, d), _mpc_points(32, 36, d)
        outs = M._group_lagrange([(M._jac(a), 8), (M._jac(b), 32)])
        return [c for o in outs for c in K.g1_to_affine(o)]

    for got, want in zip(run(dev), run("cpu")):
        assert torch.equal(got.cpu(), want)


def test_toy_ceremony_on_card_matches_cpu(dev):
    """The seeded toy ceremony (one phase-1 contribution, phase-2 prepare,
    one phase-2 contribution) on the card == on the CPU: accumulator JSON,
    every family and host point; each step verifies on the card."""
    import dataclasses
    import json

    from tokamak_zk_evm_tpu_torch.models import mpc_setup as M
    from tokamak_zk_evm_tpu_torch.testing.fixtures import build_fixture

    fx = build_fixture()

    def run(d):
        rng = np.random.default_rng(3)
        acc0 = M.Phase1Accumulator.initial(fx.params)
        acc, proof1 = acc0.compute(rng, d)
        sigma = M.phase2_prepare(acc, 0xBEEF, fx.params, fx.library, fx.infos, d)
        cur, proof2 = M.phase2_contribute(sigma, rng)
        return acc0, acc, proof1, sigma, cur, proof2

    acc0, acc, proof1, sigma, cur, proof2 = run(dev)
    c_acc0, c_acc, _, c_sigma, c_cur, c_proof2 = run("cpu")
    assert json.dumps(acc.to_json()) == json.dumps(c_acc.to_json())
    assert proof2.to_json() == c_proof2.to_json()
    for s, c in ((sigma, c_sigma), (cur, c_cur)):
        for name in M._FAMILIES:
            assert all(torch.equal(a.cpu(), b) for a, b in
                       zip(getattr(s.sigma_1, name), getattr(c.sigma_1, name))), name
        s1, c1 = (dataclasses.replace(x.sigma_1, **{f: None for f in M._FAMILIES})
                  for x in (s, c))
        assert s1 == c1 and s.sigma_2 == c.sigma_2 and s.lagrange_KL == c.lagrange_KL
    assert acc0.verify(acc, proof1, np.random.default_rng(1), dev)
    assert M.phase2_verify(sigma, cur, proof2, np.random.default_rng(2))

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

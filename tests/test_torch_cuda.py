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


def test_ntt_kernel(dev):
    data = rand(FR, 64 * 256, 4, dev).reshape(16, 64, 256)
    for inverse in (False, True):
        pows, scale = NT._tables(256, inverse, dev)
        assert torch.equal(K.fr_ntt(data, pows, scale), K.plain_ntt(data, pows, scale))


def _affine_cols(packed):
    """Packed jacobian [n, 36] -> host affine points (None = infinity)."""
    X, Y, Z = (c.cpu() for c in K.unpack_points(packed, 3))
    return [G1.to_affine(tuple(FQ.from_mont(FQ.from_limbs(c[:, i].tolist())) for c in (X, Y, Z)))
            for i in range(X.shape[1])]


@pytest.mark.parametrize("scalars", ["uniform", "skewed"])
def test_g1_kernels(dev, scalars):
    """Fixed-base kernel and the MSM against the plain versions, and each
    MSM stage kernel against its plain version.  "skewed": small
    witness-like scalars (most of them 1), so one bucket holds most
    entries and the bucket sum runs a second pass over its chunks."""
    tx, ty, tinf = K.fixed_base_table(*G1.gen, dev)
    sc = rand(FR, 300, 5, dev)
    jac = K.g1_fixed_base(sc, tx, ty, tinf)
    assert all(torch.equal(a, b) for a, b in zip(jac, K.plain_g1_fixed_base(sc, tx, ty, tinf)))
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
    tx, ty, tinf = K.fixed_base_table(*G1.gen, dev)
    c = rand(FR, n, 7, dev)
    c[1:] = 0
    c[0] %= 997  # few distinct points: repeats and a few infinities
    px, py, pinf = K.g1_to_affine(K.g1_fixed_base(c, tx, ty, tinf))
    sc = rand(FR, n, 8, dev)
    want = TM.msm(sc, px, py, pinf)
    with TM.use_core("affine_tree"):
        assert TM.msm(sc, px, py, pinf) == want

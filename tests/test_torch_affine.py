"""The port's affine MSM configuration vs the JAX package, on the CPU.

* K5's batched affine add (`g1_aff_add_batch`, plain versions here) against
  the JAX package's host curve (`host/curve.py` G1.add / G1.to_affine) on a
  seeded batch with every planted case: P+Q, P+P, P+(-P), inf+Q, P+inf,
  inf+inf.  The JAX `g1_aff_add_batch` is a Pallas pair that the
  interpreter runs too slowly for a test, so its host reference stands in,
  as in `tests/test_pallas_msm.py`.
* The "affine_tree" MSM core against the JAX package's MSM (native backend)
  and the port's Pippenger, with repeated points, zero scalars, infinities
  and one hot bucket; its (c, wb) model and power-of-two split against the
  JAX package's own functions.
* The toy proof under `use_core("affine_tree")` reproduces the golden
  digest.

Tolerance: exact (points are compared as integers, proofs as bytes).
"""

import hashlib

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu.backend import pallas_kernels as JP
from tokamak_zk_evm_tpu.host.curve import G1 as JG1
from tokamak_zk_evm_tpu.ops import curve as JC
from tokamak_zk_evm_tpu.ops import msm as JM
from tokamak_zk_evm_tpu_torch.backend import kernels as K
from tokamak_zk_evm_tpu_torch.backend import msm_affine as MA
from tokamak_zk_evm_tpu_torch.fields import FQ, Q_MOD, R_MOD
from tokamak_zk_evm_tpu_torch.host.curve import G1, g1_scalar_mul_affine
from tokamak_zk_evm_tpu_torch.ops import curve as TC
from tokamak_zk_evm_tpu_torch.ops import msm as TM

# The plain versions issue many small ops; one intra-op thread per test
# process keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

_BASE = [g1_scalar_mul_affine(G1.gen, k) for k in (1, 2, 3, 5, 8, 13, 21, R_MOD - 1)]
CASES = ("P+Q", "P+P", "P+(-P)", "inf+Q", "P+inf", "inf+inf")


def planted_pairs(n, seed):
    """n lane pairs (host affine points, None = infinity) cycling through
    CASES, points drawn from _BASE."""
    rng = np.random.default_rng(seed)
    a, b = [], []
    for i in range(n):
        case = CASES[i % len(CASES)]
        p, q = rng.choice(len(_BASE), size=2, replace=False)
        P, Q = _BASE[int(p)], _BASE[int(q)]
        a.append(None if case.startswith("inf") else P)
        b.append({"P+Q": Q, "P+P": P, "P+(-P)": (P[0], (-P[1]) % Q_MOD)}.get(case))
    return a, b


def test_affine_add_matches_jax_host_curve():
    a, b = planted_pairs(72, 11)
    x1, y1, _ = TC.pack_affine(a, "cpu")
    x2, y2, _ = TC.pack_affine(b, "cpu")
    ox, oy = K.g1_aff_add_batch((x1, y1), (x2, y2))
    got = TC.unpack_affine((ox, oy, ((ox == 0).all(0) & (oy == 0).all(0)).to(torch.int32)))
    want = [JG1.to_affine(JG1.add(JG1.from_affine(p), JG1.from_affine(q))) for p, q in zip(a, b)]
    assert got == want
    assert got[2::6] == [None] * 12  # every P + (-P) cancels


def test_denominators_are_never_zero():
    """aff_pre: 2 y1 on doubling lanes, x2 - x1 on add lanes, one on bypass
    lanes, so the batch inversion between the halves never meets a zero."""
    a, b = planted_pairs(36, 12)
    x1, y1, _ = TC.pack_affine(a, "cpu")
    x2, y2, _ = TC.pack_affine(b, "cpu")
    den = [FQ.from_mont(FQ.from_limbs(c.tolist())) for c in K.aff_pre(x1, y1, x2, y2).T]
    for i, (p, q) in enumerate(zip(a, b)):
        case = CASES[i % len(CASES)]
        want = {"P+Q": (q or (0, 0))[0] - (p or (0, 0))[0], "P+P": 2 * (p or (0, 0))[1]}.get(case, 1)
        assert den[i] == want % Q_MOD != 0, case


def msm_inputs(n, seed):
    """Repeated points, zero scalars, infinities, the scalar r-1, and a hot
    bucket: an eighth of the lanes share one scalar (so one digit per
    window) and one point, so that bucket doubles in the merge tree."""
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
def test_affine_tree_msm_matches_jax_and_pippenger(n):
    ks, pts = msm_inputs(n, n)
    want = JM.msm(JM.scalars_from_ints(ks), *JC.pack_affine(pts))
    s = TM.scalars_from_ints(ks, "cpu")
    tx, ty, ti = TC.pack_affine(pts, "cpu")
    with TM.use_core("affine_tree"):
        got = TM.msm(s, tx, ty, ti)
    assert got == want
    assert TM.msm(s, tx, ty, ti) == want  # pippenger, the default


@pytest.mark.parametrize("case", ["all zero scalars", "cancelling pair", "one point"])
def test_affine_tree_small_sums(case):
    p = _BASE[2]
    ks, pts, want = {
        "all zero scalars": ([0, 0, 0], [_BASE[0], _BASE[1], None], None),
        "cancelling pair": ([9, 9], [p, (p[0], (-p[1]) % Q_MOD)], None),
        "one point": ([R_MOD - 1], [p], (p[0], (-p[1]) % Q_MOD)),
    }[case]
    tx, ty, ti = TC.pack_affine(pts, "cpu")
    with TM.use_core("affine_tree"):
        assert TM.msm(TM.scalars_from_ints(ks, "cpu"), tx, ty, ti) == want


@pytest.mark.parametrize("n", [2, 16, 256, 1 << 12, 1 << 16, 1 << 18, 1 << 20, 1 << 22,
                               1 << 23])
def test_window_model_matches_jax(n):
    c = MA.msm_c(n)
    W = -(-255 // c)
    assert c == JP._msm_c(n)
    assert MA.msm_wb(n, c, W) == JP._msm_wb(n, c, W)


@pytest.mark.parametrize("N", [5, 1 << 16, (1 << 16) + 1, (1 << 20) + (1 << 13) + 7,
                               4097 * 257, (1 << 21) - 1])
def test_pow2_chunks_match_jax(N):
    assert MA.pow2_chunks(N) == JP._pow2_chunks(N)


def test_use_core_selects_and_restores():
    ks, pts = [3, 5], [_BASE[0], _BASE[1]]
    s = TM.scalars_from_ints(ks, "cpu")
    tx, ty, ti = TC.pack_affine(pts, "cpu")
    with TM.use_core("affine_tree"):
        h = TM.msm_start(s, tx, ty, ti)
    assert isinstance(h, MA.Handle) and not isinstance(TM.msm_start(s, tx, ty, ti), MA.Handle)
    assert TM.msm_finish(h) == g1_scalar_mul_affine(G1.gen, 3 * 1 + 5 * 2)
    with pytest.raises(ValueError, match="unknown MSM core"):
        with TM.use_core("packed"):
            pass


def test_golden_digest_under_affine_tree():
    from tokamak_zk_evm_tpu_torch.io.artifacts import canonical_proof_bytes
    from tokamak_zk_evm_tpu_torch.models.protocol import Mixer
    from tokamak_zk_evm_tpu_torch.models.prover import Prover
    from tokamak_zk_evm_tpu_torch.models.setup import Tau, generate_sigma
    from tokamak_zk_evm_tpu_torch.testing.fixtures import GOLDEN_PROOF_SHA256, build_fixture

    fx = build_fixture()
    sigma = generate_sigma(fx.params, Tau.fixed(), fx.library, fx.infos, device="cpu")
    with TM.use_core("affine_tree"):
        proof, _ = Prover(fx.params, sigma, fx.library, fx.infos, fx.placements,
                          fx.permutation, fx.instance, mixer=Mixer.zero(), device="cpu").prove()
    assert hashlib.sha256(canonical_proof_bytes(proof)).hexdigest() == GOLDEN_PROOF_SHA256

"""K5, the port's batched affine add, vs the JAX package, on the CPU.

* K5's batched affine add (`g1_aff_add_batch`, plain versions here) against
  the JAX package's host curve (`host/curve.py` G1.add / G1.to_affine) on a
  seeded batch with every planted case: P+Q, P+P, P+(-P), inf+Q, P+inf,
  inf+inf.  The JAX `g1_aff_add_batch` is a Pallas pair that the
  interpreter runs too slowly for a test, so its host reference stands in,
  as in `tests/test_pallas_msm.py`.
* `aff_pre` never hands the batch inversion a zero denominator.

Tolerance: exact (points are compared as integers).
"""

import numpy as np
import torch

from tokamak_zk_evm_tpu.host.curve import G1 as JG1
from tokamak_zk_evm_tpu_torch.backend import kernels as K
from tokamak_zk_evm_tpu_torch.fields import FQ, Q_MOD, R_MOD
from tokamak_zk_evm_tpu_torch.host.curve import G1, g1_scalar_mul_affine
from tokamak_zk_evm_tpu_torch.ops import curve as TC

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

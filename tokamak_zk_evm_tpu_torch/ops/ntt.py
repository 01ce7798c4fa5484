"""Batched radix-2 NTT over Fr (limb-major, kernel-dispatched).

Layout: tensors are `[16, batch, n]` int32 Fr Montgomery; the transform runs
along the last axis, as one call of the NTT kernel (K3).  Twiddles are exact
host tables moved to the device once per (n, direction, device).

Semantics (natural order in and out, as ICICLE's kNN):
  forward:  evals[i]  = sum_j coeffs[j] * omega^(i*j),  omega = fr_root_of_unity(n)
  inverse:  coeffs[j] = (1/n) * sum_i evals[i] * omega^(-i*j)
  coset c:  forward evaluates at c*omega^i (coefficients pre-scaled by c^j);
            inverse undoes it (post-scaling by c^(-j)).

The JAX package's mesh branch (a sharded transform) waits for the
multi-device slice of the port.
"""

from __future__ import annotations

import functools

from ..backend import kernels as K
from ..fields import R_MOD, fr_root_of_unity
from . import field as F


@functools.lru_cache(maxsize=None)
def _tables(n: int, inverse: bool, device):
    omega = fr_root_of_unity(n)
    if inverse:
        omega = pow(omega, -1, R_MOD)
    pows = F.tensor(F.fr_powers(omega, n), device)
    scale = F.tensor(F.fr_mont(pow(n, -1, R_MOD) if inverse else 1), device)
    return pows, scale


def ntt_batched(a, inverse: bool = False, coset: int | None = None):
    """NTT along the last axis of `a` ([16, ..., n])."""
    n = a.shape[-1]
    if n == 1:
        return a
    shape = a.shape
    a = a.reshape(shape[0], -1, n)
    scaled = coset is not None and coset % R_MOD != 1
    if scaled and not inverse:
        a = F.fr_mul(a, F.fr_powers(coset, n))
    pows, scale = _tables(n, inverse, a.device)
    a = K.fr_ntt(a.contiguous(), pows, scale)
    if scaled and inverse:
        a = F.fr_mul(a, F.fr_powers(pow(coset, -1, R_MOD), n))
    return a.reshape(shape)


def bintt(grid, inverse: bool = False, coset_x: int | None = None,
          coset_y: int | None = None):
    """Bivariate NTT of a `[16, x_size, y_size]` grid: along Y (rows batched
    over X), then along X (batched over Y) -- the reference's `_biNTT`."""
    L, x_size, y_size = grid.shape
    if y_size > 1:
        grid = ntt_batched(grid, inverse=inverse, coset=coset_y)
    if x_size > 1:
        g = grid.transpose(1, 2).contiguous()
        g = ntt_batched(g, inverse=inverse, coset=coset_x)
        grid = g.transpose(1, 2).contiguous()
    return grid

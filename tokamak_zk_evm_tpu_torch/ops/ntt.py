"""NTT over Fr along one axis of a limb-major grid (kernel-dispatched).

Layout: tensors are `[16, ..., n]` (`ntt_batched`) or `[16, x, y]` grids
(`bintt`) of int32 Fr Montgomery limbs; each transform is one call of the
NTT kernel (K3) along the grid's axis, with no transpose copy.  Twiddle,
scale and coset tables are exact host tables moved to the device once per
(n, direction or coset, device) and kept there.

Semantics (natural order in and out, as ICICLE's kNN):
  forward:  evals[i]  = sum_j coeffs[j] * omega^(i*j),  omega = fr_root_of_unity(n)
  inverse:  coeffs[j] = (1/n) * sum_i evals[i] * omega^(-i*j)
  coset c:  forward evaluates at c*omega^i (coefficients pre-scaled by c^j);
            inverse undoes it (post-scaling by c^(-j)).
The 1/n is applied inside the kernel as it stores; a coset is one
elementwise Fr product (K1) by the table of c^j before a forward transform,
or of c^-j after an inverse one.

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
    """(pows, scale) device tables of one transform, for `K.fr_ntt`."""
    omega = fr_root_of_unity(n)
    if inverse:
        omega = pow(omega, -1, R_MOD)
    pows = F.tensor(F.fr_powers(omega, n), device)
    scale = F.tensor(F.fr_mont(pow(n, -1, R_MOD)), device) if inverse else None
    return pows, scale


@functools.lru_cache(maxsize=None)
def _coset_table(n: int, c: int, device):
    """[16, n] device table of c^j."""
    return F.tensor(F.fr_powers(c, n), device)


def ntt_axis(grid, axis: int, inverse: bool = False, coset: int | None = None,
             inplace: bool = False):
    """NTT along `axis` (1 or 2) of a `[16, X, Y]` grid, on the coset
    c * <omega> when `coset` is given.  `inplace`: `grid` is scratch the
    transform may write over."""
    n = grid.shape[axis]
    c = None if coset is None or coset % R_MOD == 1 else coset % R_MOD
    rep = grid.shape[2] if axis == 1 else 1  # element (x, y) takes entry x, or y

    def times(g, v):
        table = _coset_table(n, v, g.device)
        return K.fr_mul(g.reshape(g.shape[0], -1), table, rep).reshape(g.shape)

    if c is not None and not inverse:
        grid, inplace = times(grid, c), True
    out = K.fr_ntt(grid, *_tables(n, inverse, grid.device), axis=axis, inplace=inplace)
    if c is not None and inverse:
        out = times(out, pow(c, -1, R_MOD))
    return out


def ntt_batched(a, inverse: bool = False, coset: int | None = None):
    """NTT along the last axis of `a` ([16, ..., n])."""
    n = a.shape[-1]
    if n == 1:
        return a
    shape = a.shape
    out = ntt_axis(a.reshape(shape[0], -1, n).contiguous(), 2, inverse, coset)
    return out.reshape(shape)


def bintt(grid, inverse: bool = False, coset_x: int | None = None,
          coset_y: int | None = None):
    """Bivariate NTT of a `[16, x_size, y_size]` grid: along Y (rows batched
    over X), then along X (columns batched over Y) -- the reference's
    `_biNTT`."""
    _, x_size, y_size = grid.shape
    grid = grid.contiguous()
    if y_size > 1:
        grid = ntt_axis(grid, 2, inverse, coset_y)
    if x_size > 1:  # over the Y pass's own output, if there was one
        grid = ntt_axis(grid, 1, inverse, coset_x, inplace=y_size > 1)
    return grid

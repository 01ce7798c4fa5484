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

Under a mesh (`parallel.context.use_mesh`) of more than one rank, `bintt`
of a grid whose axes both divide by the mesh size runs sharded
(`parallel.ntt_dist`), with the coset scalings as K1 products of the whole
grid outside the dist transform.
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
    `_biNTT`.  Under an active mesh that splits the grid evenly, the
    transform runs on `parallel.ntt_dist` from this rank's rows, and every
    rank gets the whole grid back."""
    _, x_size, y_size = grid.shape
    mesh = _active_mesh(x_size, y_size)
    if mesh is not None:
        from ..parallel import ntt_dist
        from ..parallel.mesh import row_slice

        cx = coset_x if (coset_x is not None and coset_x % R_MOD != 1) else None
        cy = coset_y if (coset_y is not None and coset_y % R_MOD != 1) else None
        if not inverse:
            grid = _coset_scale(grid, cx, cy, inverse=False)
        grid = ntt_dist.bintt_dist(grid[:, row_slice(mesh, x_size)], mesh, inverse=inverse)
        if inverse:
            grid = _coset_scale(grid, cx, cy, inverse=True)
        return grid
    grid = grid.contiguous()
    if y_size > 1:
        grid = ntt_axis(grid, 2, inverse, coset_y)
    if x_size > 1:  # over the Y pass's own output, if there was one
        grid = ntt_axis(grid, 1, inverse, coset_x, inplace=y_size > 1)
    return grid


def _active_mesh(x_size: int, y_size: int):
    """The context mesh, if it has more than one rank and the grid can be
    split by rows and by columns on it."""
    from ..parallel import context

    mesh = context.get_mesh()
    if mesh is None or mesh.size <= 1 or x_size % mesh.size or y_size % mesh.size:
        return None
    return mesh


def _coset_scale(grid, coset_x, coset_y, inverse: bool):
    """Coset pre- (forward) or post-scaling (inverse) of a [16, x, y] grid:
    element (i, j) times c_x^i c_y^j, or their inverses; the same products
    as `ntt_axis`'s per-pass scaling."""
    L, x_size, y_size = grid.shape
    flat = grid.reshape(L, -1).contiguous()
    if coset_y is not None:
        cy = pow(coset_y, -1, R_MOD) if inverse else coset_y % R_MOD
        flat = K.fr_mul(flat, _coset_table(y_size, cy, grid.device))
    if coset_x is not None:
        cx = pow(coset_x, -1, R_MOD) if inverse else coset_x % R_MOD
        flat = K.fr_mul(flat, _coset_table(x_size, cx, grid.device), rep=y_size)
    return flat.reshape(grid.shape)

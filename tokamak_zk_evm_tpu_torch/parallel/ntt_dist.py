"""Mesh-sharded bivariate NTT.

The reference's `_biNTT` (a Y pass, then an X pass) is the transpose-based
distributed FFT: the grid's X rows are split across the ranks, each runs
the Y pass on its rows, an all-to-all re-splits the grid by Y columns, and
each runs the X pass on its columns.  Each pass is one K3 call
(`ops.ntt.ntt_axis`).

Every rank runs the whole prover (SPMD), where the JAX package has one
controller that keeps the result sharded by columns (GSPMD): so here an
all-gather ends the transform, and every rank gets the whole grid back.
That is one collective more than the JAX package's.
"""

from __future__ import annotations

from ..ops.ntt import ntt_axis
from .mesh import COUNTS


def bintt_dist(rows, mesh, inverse: bool = False):
    """Distributed bivariate NTT of a [16, x, y] grid from this rank's rows
    `rows` [16, x/n, y] (`mesh.row_slice`) on a mesh of n ranks; returns the
    whole transformed grid [16, x, y] on every rank.  Byte-equal to
    `ops.ntt.bintt` of the whole grid."""
    n = mesh.size
    L, xr, y = rows.shape
    if y % n:
        raise ValueError(f"bintt_dist: y_size {y} does not divide by the mesh size {n}")
    x, yc = xr * n, y // n
    COUNTS["bintt_dist"] += 1
    rows = rows.contiguous()
    if y > 1:
        rows = ntt_axis(rows, 2, inverse)
    # [16, x/n, n, y/n] -> [n, 16, x/n, y/n]: block j holds rank j's columns
    recv = mesh.all_to_all(rows.reshape(L, xr, n, yc).permute(2, 0, 1, 3))
    cols = recv.permute(1, 0, 2, 3).reshape(L, x, yc).contiguous()  # rows of rank j at j x/n
    if x > 1:
        cols = ntt_axis(cols, 1, inverse, inplace=True)
    return mesh.all_gather(cols).permute(1, 2, 0, 3).reshape(L, x, y).contiguous()

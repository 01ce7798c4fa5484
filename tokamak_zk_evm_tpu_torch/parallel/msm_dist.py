"""Mesh-sharded MSM.

The points (and their scalars) are split across the ranks; each rank runs
a whole local MSM over its block on the current core (`ops.msm.use_core`:
K4's Pippenger, or the affine tree on K5), and the partial results (one
jacobian point each) are all-gathered and combined exactly on the host, in
rank order: sum_i k_i P_i = sum over ranks of the local MSMs.
Communication is one point a rank.
"""

from __future__ import annotations

from .mesh import COUNTS, col_slice


def msm_dist(scalars_canonical, px, py, pinf, mesh):
    """Distributed MSM; the contract of `ops.msm.msm` (canonical scalars
    [16, N], affine Montgomery points [24, N] x 2, infinity flags [N],
    N a multiple of the mesh size) -> host affine point or None."""
    from ..host.curve import G1
    from ..ops import msm as M

    cols = col_slice(mesh, px.shape[1])
    COUNTS["msm_dist"] += 1
    handle = M.start_local(scalars_canonical[:, cols], px[:, cols].contiguous(),
                           py[:, cols].contiguous(), pinf[cols].contiguous())
    parts = mesh.all_gather(M.finish_rows(handle)).cpu()  # [n, 3, 24]
    acc = G1.infinity
    for d in range(mesh.size):
        acc = G1.add(acc, M.rows_jacobian(parts[d]))
    return G1.to_affine(acc)

"""Active-mesh context: route the prover's heavy ops through the mesh.

Rather than threading a mesh argument through every BiPoly/encode call
site, the prover runs inside a mesh context and the two hot ops consult
it:

  * `ops.ntt.bintt`   -> `parallel.ntt_dist.bintt_dist` (local Y pass,
    all-to-all transpose, local X pass, all-gather) when the grid divides
    evenly;
  * `ops.msm.msm_start` -> `parallel.msm_dist.msm_dist` (points split
    across the ranks, one partial each, exact host combine), padding the
    point count to a multiple of the mesh size with infinities.

A mesh of one rank engages neither.  Every rank of the mesh must enter the
same context and make the same calls in the same order: the dist ops are
collectives.
"""

from __future__ import annotations

from contextlib import contextmanager

_MESH = None


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


@contextmanager
def use_mesh(mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev

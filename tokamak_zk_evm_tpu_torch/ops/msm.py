"""Multi-scalar multiplication (limb-major, kernel-dispatched).

Scalars are canonical (non-Montgomery) [16, N] limb tensors; points are
affine Montgomery ([24, N], [24, N], [N]).  Two device cores compute the
same sum, chosen by `use_core`:

  * "pippenger" (the default): K4's bucket sums and window reduce
    (`backend/kernels.py` g1_msm_start), one jacobian point per window;
  * "affine_tree": the JAX package's unpacked configuration, a sorted merge
    tree on K5's batched affine adds (`backend/msm_affine.py`), affine
    singles per window and level.

`msm_start` runs the current core; `msm_finish` knows an affine-tree
handle by its type (`msm_affine.Handle`), pulls the core's points and
combines them on the host.  Result: host affine point ((x, y) ints) or None.
Under a mesh of more than one rank (`parallel.context.use_mesh`) the points
are split across the ranks (`parallel.msm_dist`), each running the current
core on its block.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..backend import kernels as K
from ..backend import msm_affine as MA
from ..fields import R_MOD
from . import field as F

CORES = ("pippenger", "affine_tree")
_core = "pippenger"


@contextlib.contextmanager
def use_core(name: str):
    """Start every MSM inside the block on core `name` (see the module
    docstring); the previous core is restored on exit."""
    global _core
    if name not in CORES:
        raise ValueError(f"unknown MSM core {name!r}; cores: {list(CORES)}")
    prev, _core = _core, name
    try:
        yield
    finally:
        _core = prev


class Done(NamedTuple):
    """The handle of an MSM already finished (a sharded one): its point."""

    point: object


def start_local(scalars_canonical, px, py, pinf):
    """Enqueue the device part of an MSM on this device's current core."""
    start = MA.g1_msm_start if _core == "affine_tree" else K.g1_msm_start
    return start(scalars_canonical.contiguous(), px, py, pinf)


def msm_start(scalars_canonical, px, py, pinf):
    """Enqueue the device part of an MSM on the current core; `msm_finish`
    brings the point home.  A round starts all its commitments before
    finishing any.

    Under a mesh of more than one rank the points are padded to a multiple
    of the mesh size (zero scalars on infinities) and split across the
    ranks (`parallel.msm_dist`), eagerly: the partials' combine is its own
    sync, and the handle holds the point."""
    from ..parallel import context

    mesh = context.get_mesh()
    if mesh is None or mesh.size <= 1:
        return start_local(scalars_canonical, px, py, pinf)
    from ..parallel import msm_dist

    pad = -px.shape[1] % mesh.size
    if pad:
        scalars_canonical = torch.cat([scalars_canonical,
                                       scalars_canonical.new_zeros(F.FR_L, pad)], 1)
        px = torch.cat([px, px.new_zeros(px.shape[0], pad)], 1)
        py = torch.cat([py, py.new_zeros(py.shape[0], pad)], 1)
        pinf = torch.cat([pinf, pinf.new_ones(pad)])
    return Done(msm_dist.msm_dist(scalars_canonical, px, py, pinf, mesh))


def finish_rows(handle):
    """The jacobian [3, 24] rows (Montgomery limbs, CPU) of a local MSM."""
    finish = MA.g1_msm_finish if isinstance(handle, MA.Handle) else K.g1_msm_finish
    return finish(handle)


def rows_jacobian(rows):
    """[3, 24] jacobian Montgomery rows -> host jacobian (X, Y, Z) ints."""
    return tuple(int(F.unpack_fq(rows[i].reshape(24, 1))[0]) for i in range(3))


def msm_finish(handle):
    from ..host.curve import G1

    if isinstance(handle, Done):
        return handle.point
    return G1.to_affine(rows_jacobian(finish_rows(handle)))


def msm(scalars_canonical, px, py, pinf):
    """MSM -> host affine ((x, y) ints) or None for the identity."""
    return msm_finish(msm_start(scalars_canonical, px, py, pinf))


def scalars_from_ints(ints, device):
    """Host ints -> canonical limb tensor [16, N]."""
    return F.tensor(F.pack_fr(ints, mont=False), device)


def scalars_from_mont(mont_arr):
    """Montgomery Fr tensor [16, ...] -> canonical limbs (on its device).
    A Montgomery product with the plain integer 1 applies R^-1."""
    one = F.pack_fr([1], mont=False)
    flat = mont_arr.reshape(16, -1)
    return F.fr_mul(flat, one).reshape(mont_arr.shape)


def fixed_base_msm_points(scalars, gen, device):
    """[k_i * G] for a shared affine generator -> affine device family.

    `scalars`: host ints, or a canonical [16, N] tensor already on the
    device.  CRS-generation workhorse (trusted setup xy_powers etc.)."""
    if not hasattr(scalars, "device"):
        scalars = scalars_from_ints([int(s) % R_MOD for s in scalars], device)
    table = K.fixed_base_table(gen[0], gen[1], scalars.device)
    jac = K.g1_fixed_base(scalars.contiguous(), table)
    from . import curve as cv

    return cv.jac_to_affine(jac)

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
The JAX package's mesh branch (points sharded across chips) waits for the
multi-device slice.
"""

from __future__ import annotations

import contextlib

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


def msm_start(scalars_canonical, px, py, pinf):
    """Enqueue the device part of an MSM on the current core; `msm_finish`
    brings the point home.  A round starts all its commitments before
    finishing any."""
    start = MA.g1_msm_start if _core == "affine_tree" else K.g1_msm_start
    return start(scalars_canonical.contiguous(), px, py, pinf)


def msm_finish(handle):
    from ..host.curve import G1

    finish = MA.g1_msm_finish if isinstance(handle, MA.Handle) else K.g1_msm_finish
    rows = finish(handle)  # [3, 24]
    X, Y, Z = (int(F.unpack_fq(rows[i].reshape(24, 1))[0]) for i in range(3))
    return G1.to_affine((X, Y, Z))


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

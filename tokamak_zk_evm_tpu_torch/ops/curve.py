"""Device BLS12-381 G1 arithmetic (limb-major, kernel-dispatched).

Points are triples (X, Y, Z) of limb-major Fq tensors `[24, ...batch]` in
jacobian coordinates; Z == 0 encodes infinity.  Affine batches are
(x, y, inf) with inf an int32 {0, 1} mask of the batch shape.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import kernels as K
from . import field as F

LQ = F.FQ_L


def _flat(p):
    return tuple(c.reshape(LQ, -1).contiguous() for c in p)


def jac_add(p, q):
    shape = p[0].shape
    return tuple(c.reshape(shape) for c in K.g1_add(_flat(p), _flat(q), rep=1))


def jac_double(p):
    shape = p[0].shape
    return tuple(c.reshape(shape) for c in K.g1_dbl(_flat(p)))


def jac_to_affine(p):
    """Batched jacobian -> affine (x, y, inf) via one shared inversion."""
    shape = p[0].shape
    x, y, inf = K.g1_to_affine(_flat(p))
    return x.reshape(shape), y.reshape(shape), inf.reshape(shape[1:])


def pack_affine(points, device):
    """List of host affine points ((x, y) ints or None) -> device tensors."""
    n = len(points)
    xs, ys = [], []
    infs = np.zeros(n, dtype=np.int32)
    for i, p in enumerate(points):
        if p is None:
            xs.append(0)
            ys.append(0)
            infs[i] = 1
        else:
            xs.append(p[0])
            ys.append(p[1])
    return (F.tensor(F.pack_fq(xs), device), F.tensor(F.pack_fq(ys), device),
            torch.as_tensor(infs, device=device))


def unpack_affine(aff):
    """Device affine (x, y, inf) -> list of host ((x, y) ints or None)."""
    x, y, inf = aff
    xs = np.reshape(F.unpack_fq(x), (-1,))
    ys = np.reshape(F.unpack_fq(y), (-1,))
    infs = F._host(inf).reshape(-1).astype(bool)
    return [None if i else (int(a), int(b)) for a, b, i in zip(xs, ys, infs)]

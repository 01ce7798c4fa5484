"""Limb-major field layer over the kernel wrappers.

Field elements are little-endian 16-bit limbs held in int32 (the bit pattern
of the JAX package's uint32 arrays), **limb-major**: an array of elements with
batch shape S is a tensor `[L, *S]`, L = 16 (Fr) or 24 (Fq), Montgomery form
with R = 2^256 (Fr) / 2^384 (Fq).  The layout is the JAX package's, so the
two packages exchange arrays byte for byte.

Host constants (powers tables, Montgomery scalars) are numpy int32 arrays;
the ops move them to the device of the tensor they meet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..backend import kernels as K
from ..fields import FQ, FR, FieldSpec, R_MOD

FR_L = FR.n_limbs  # 16
FQ_L = FQ.n_limbs  # 24


# ---------------------------------------------------------------------------
# Host <-> limb packing
# ---------------------------------------------------------------------------


def _pack(spec: FieldSpec, ints, mont: bool) -> np.ndarray:
    arr = np.asarray(ints, dtype=object)
    flat = arr.reshape(-1)
    nbytes = spec.n_limbs * 2
    mod = spec.modulus
    if mont:
        rmod = spec.R_mod
        buf = b"".join(
            ((int(v) % mod) * rmod % mod).to_bytes(nbytes, "little") for v in flat)
    else:
        buf = b"".join((int(v) % mod).to_bytes(nbytes, "little") for v in flat)
    out = np.frombuffer(buf, dtype="<u2").astype(np.int32)
    out = out.reshape(arr.shape + (spec.n_limbs,))
    return np.ascontiguousarray(np.moveaxis(out, -1, 0))


def _host(limbs) -> np.ndarray:
    if isinstance(limbs, torch.Tensor):
        return limbs.detach().cpu().numpy()
    return np.asarray(limbs)


def _unpack(spec: FieldSpec, limbs, mont: bool):
    arr = _host(limbs)
    if arr.shape[0] != spec.n_limbs:
        raise ValueError(f"want {spec.n_limbs} limb rows, got {arr.shape}")
    shape = arr.shape[1:]
    buf = np.ascontiguousarray(np.moveaxis(arr, 0, -1).astype("<u2")).tobytes()
    nbytes = spec.n_limbs * 2
    n = int(np.prod(shape)) if shape else 1
    out = np.empty(n, dtype=object)
    rinv = spec.Rinv
    mod = spec.modulus
    for i in range(n):
        x = int.from_bytes(buf[i * nbytes : (i + 1) * nbytes], "little")
        out[i] = (x * rinv % mod) if mont else (x % mod)
    return out.reshape(shape) if shape else out[0]


def pack_fr(ints, mont: bool = True) -> np.ndarray:
    return _pack(FR, ints, mont)


def unpack_fr(limbs, mont: bool = True):
    return _unpack(FR, limbs, mont)


def pack_fq(ints, mont: bool = True) -> np.ndarray:
    return _pack(FQ, ints, mont)


def unpack_fq(limbs, mont: bool = True):
    return _unpack(FQ, limbs, mont)


@functools.lru_cache(maxsize=None)
def fr_mont(x: int) -> np.ndarray:
    """One scalar as a [16, 1] Montgomery column (cached host constant)."""
    return pack_fr([x % R_MOD])


@functools.lru_cache(maxsize=None)
def fr_powers(x: int, n: int) -> np.ndarray:
    """[16, n] table of x^0..x^(n-1), Montgomery (host-exact, cached)."""
    pows = []
    acc = 1
    x = x % R_MOD
    for _ in range(n):
        pows.append(acc)
        acc = acc * x % R_MOD
    return pack_fr(pows)


def tensor(x, device) -> torch.Tensor:
    """A host array or a tensor as an int32 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x, dtype=np.int32), device=device)


def fr_one(shape, device) -> torch.Tensor:
    """[16, *shape] Montgomery ones on `device`."""
    one = tensor(pack_fr([1]).reshape((FR_L,) + (1,) * len(shape)), device)
    return one.expand((FR_L,) + tuple(shape)).contiguous()


def fr_zero(shape, device) -> torch.Tensor:
    return torch.zeros((FR_L,) + tuple(shape), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Broadcast resolution: numpy-style batch broadcasting mapped onto the
# kernels' single (rep, Bb) stride model.  Supported: equal shapes, scalar b,
# suffix match (cyclic tiling), prefix match (block broadcast) -- in this
# order, as in the JAX package (a square grid takes the suffix reading).
# ---------------------------------------------------------------------------


def _resolve(a, b):
    sa, sb = tuple(a.shape[1:]), tuple(b.shape[1:])
    if sa == sb:
        return a, b, 1
    na = int(np.prod(sa)) if sa else 1
    nb = int(np.prod(sb)) if sb else 1
    if nb == 1:
        return a, b, 1
    k = len(sb)
    if sa[-k:] == sb:  # suffix match -> cyclic
        return a, b, 1
    if sa[:k] == sb:  # prefix match -> block broadcast
        return a, b, na // nb
    raise ValueError(f"unsupported broadcast {sa} vs {sb}")


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    raise ValueError("at least one operand must be a tensor")


def _bin(op, a, b):
    dev = _device_of(a, b)
    a = tensor(a, dev)
    b = tensor(b, dev)
    if int(np.prod(a.shape[1:])) < int(np.prod(b.shape[1:])):
        # materialize a to b's batch shape (rare: scalar/vector on the left)
        pad = b.dim() - a.dim()
        a = a.reshape((a.shape[0],) + (1,) * pad + tuple(a.shape[1:]))
        a = a.expand((a.shape[0],) + tuple(b.shape[1:]))
    aa, bb, rep = _resolve(a, b)
    fa = aa.reshape(aa.shape[0], -1).contiguous()
    fb = bb.reshape(bb.shape[0], -1).contiguous()
    return op(fa, fb, rep=rep).reshape(aa.shape)


def fr_add(a, b):
    return _bin(K.fr_add, a, b)


def fr_sub(a, b):
    return _bin(K.fr_sub, a, b)


def fr_mul(a, b):
    return _bin(K.fr_mul, a, b)


def fq_add(a, b):
    return _bin(K.fq_add, a, b)


def fq_sub(a, b):
    return _bin(K.fq_sub, a, b)


def fq_mul(a, b):
    return _bin(K.fq_mul, a, b)


def _un(op, a):
    return op(a.reshape(a.shape[0], -1).contiguous()).reshape(a.shape)


def fr_neg(a):
    return _un(K.fr_neg, a)


def fr_inv(a):
    return _un(K.fr_inv, a)


def fq_neg(a):
    return _un(K.fq_neg, a)


def fq_inv(a):
    return _un(K.fq_inv, a)


def fr_batch_inv(a):
    """Exact batched inversion (0 -> 0), any batch shape."""
    return _un(K.fr_batch_inv, a)


def fr_prefix_prod(a):
    """Inclusive prefix product over the flattened batch axes."""
    return _un(K.fr_prefix_prod, a)


def fr_suffix_prod(a):
    return _un(K.fr_suffix_prod, a)


# ---------------------------------------------------------------------------
# Reductions / scans built from the field ops (log-depth)
# ---------------------------------------------------------------------------


def fr_sum(a, axis: int):
    """Exact modular sum along a batch axis (axis counted w/o the limb axis)."""
    ax = axis + 1 if axis >= 0 else a.dim() + axis
    while a.shape[ax] > 1:
        n = a.shape[ax]
        if n % 2 == 1:
            pad = list(a.shape)
            pad[ax] = 1
            a = torch.cat([a, a.new_zeros(pad)], dim=ax)
            n += 1
        lo = a.narrow(ax, 0, n // 2)
        hi = a.narrow(ax, n // 2, n // 2)
        a = fr_add(lo, hi)
    return a.squeeze(ax)


def fr_suffix_sum(a, axis: int):
    """Inclusive suffix sum along a batch axis (log-depth shifted adds)."""
    ax = axis + 1 if axis >= 0 else axis
    n = a.shape[ax]
    d = 1
    while d < n:
        shifted = torch.zeros_like(a)
        shifted.narrow(ax, 0, n - d).copy_(a.narrow(ax, d, n - d))
        a = fr_add(a, shifted)
        d *= 2
    return a

"""Plain PyTorch Montgomery arithmetic on 16-bit limbs (any device).

The arithmetic under the plain versions in `kernels.py`: tensors are int64
limb-major `[L, N]`, little-endian 16-bit limbs, every value fully reduced
into [0, p), Montgomery form with R = 2^(16 L) -- the interchange layout with
the limbs widened so that column sums of 16 x 16-bit products never overflow.
The operations are written limb by limb with whole-tensor ops, so one call
costs a fixed number of PyTorch ops whatever the batch size.
"""

from __future__ import annotations

import functools

import torch

from ..fields import FQ, FR, FieldSpec, LIMB_MASK

_CHUNK = 1 << 17  # columns per Montgomery product (bounds the [L, L, N] temp)


class LimbField:
    """Limb constants of one prime field, cached per device."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.L = spec.n_limbs
        self.n0 = spec.n0_inv  # -p^-1 mod 2^16
        self._p = spec.to_limbs(spec.modulus)
        self._one = spec.to_limbs(spec.R_mod)

    @functools.lru_cache(maxsize=None)
    def p(self, device) -> torch.Tensor:
        """[L + 1, 1] modulus limbs (top limb 0)."""
        return torch.tensor(self._p + [0], dtype=torch.int64, device=device)[:, None]

    @functools.lru_cache(maxsize=None)
    def one(self, device) -> torch.Tensor:
        """[L, 1] Montgomery one."""
        return torch.tensor(self._one, dtype=torch.int64, device=device)[:, None]


FR_LIMBS = LimbField(FR)
FQ_LIMBS = LimbField(FQ)


def normalize(t: torch.Tensor) -> torch.Tensor:
    """Propagate carries and borrows in place so that limbs 0..K-2 of
    t [K, N] lie in [0, 2^16); the top limb keeps the rest (its sign says
    whether the value is negative)."""
    while True:
        c = t[:-1] >> 16  # floor shift: -1 for a borrow
        if not bool(c.any()):
            return t
        t[:-1] &= LIMB_MASK
        t[1:] += c


def _cond_sub(F: LimbField, t: torch.Tensor) -> torch.Tensor:
    """t [L + 1, N] normalized, value < 2p -> t mod p as [L, N]."""
    d = normalize(t - F.p(t.device))
    keep = d[-1:] < 0
    return torch.where(keep, t, d)[:-1].contiguous()


def add(F: LimbField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    t = torch.cat([a + b, torch.zeros_like(a[:1])])
    return _cond_sub(F, normalize(t))


def sub(F: LimbField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = normalize(torch.cat([a - b, torch.zeros_like(a[:1])]))
    neg = d[-1:] < 0
    if not bool(neg.any()):
        return d[:-1].contiguous()
    e = normalize(d + F.p(d.device))
    return torch.where(neg, e, d)[:-1].contiguous()


def neg(F: LimbField, a: torch.Tensor) -> torch.Tensor:
    d = normalize(F.p(a.device)[:-1] - a)
    return torch.where((a == 0).all(0, keepdim=True), torch.zeros_like(a), d)


def _mul_cols(F: LimbField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    L = F.L
    n = a.shape[1]
    prod = a[:, None, :] * b[None, :, :]  # [L, L, n], each < 2^32
    # anti-diagonal sums: pad rows to 2L and re-view with row length 2L-1,
    # which puts a_i * b_j in column i + j of row i
    padded = torch.nn.functional.pad(prod, (0, 0, 0, L)).reshape(2 * L * L, n)
    cols = padded[: L * (2 * L - 1)].reshape(L, 2 * L - 1, n).sum(0)
    t = torch.cat([cols, cols.new_zeros(2, n)])  # [2L + 1, n]
    P = F.p(a.device)[:-1]
    for i in range(L):  # word-by-word Montgomery reduction (SOS)
        m = ((t[i] & LIMB_MASK) * F.n0) & LIMB_MASK
        t[i : i + L] += m * P
        t[i + 1] += t[i] >> 16
    return _cond_sub(F, normalize(t[L:].clone()))


def mul(F: LimbField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p (exact for a < R, b < p)."""
    n = a.shape[1]
    if n <= _CHUNK:
        return _mul_cols(F, a, b)
    return torch.cat([_mul_cols(F, a[:, i : i + _CHUNK], b[:, i : i + _CHUNK])
                      for i in range(0, n, _CHUNK)], dim=1)


def inv(F: LimbField, a: torch.Tensor) -> torch.Tensor:
    """Montgomery inverse, 0 maps to 0: the value of the Fermat power
    a^(p-2) taken with Montgomery products, which is R^2 / a mod p.

    Each column becomes one host integer and is inverted by Python's
    extended Euclid: a square-and-multiply over tensors costs ~570
    dependent products whatever the batch, and the affine MSM runs hundreds
    of small inversions one after another."""
    p, L = F.spec.modulus, F.L
    r2 = F.spec.R2_mod
    cols = a.to(torch.int64).T.cpu().numpy().astype("<u2").tobytes()
    step = 2 * L
    out = bytearray()
    for i in range(0, len(cols), step):
        v = int.from_bytes(cols[i : i + step], "little")
        out += (pow(v, -1, p) * r2 % p if v else 0).to_bytes(step, "little")
    res = torch.frombuffer(out, dtype=torch.int16) if out else torch.zeros(0, dtype=torch.int16)
    res = res.to(torch.int64) & LIMB_MASK
    return res.reshape(-1, L).T.contiguous().to(a.device)


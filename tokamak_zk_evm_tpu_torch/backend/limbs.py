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
        self._n_inv = spec.to_limbs((-pow(spec.modulus, -1, spec.R)) % spec.R)  # -p^-1 mod R

    @functools.lru_cache(maxsize=None)
    def p(self, device) -> torch.Tensor:
        """[L + 1, 1] modulus limbs (top limb 0)."""
        return torch.tensor(self._p + [0], dtype=torch.int64, device=device)[:, None]

    @functools.lru_cache(maxsize=None)
    def n_inv(self, device) -> torch.Tensor:
        """[L, 1] limbs of -p^-1 mod R."""
        return torch.tensor(self._n_inv, dtype=torch.int64, device=device)[:, None]

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


def _columns(a: torch.Tensor, b: torch.Tensor, cols: int) -> torch.Tensor:
    """The first `cols` columns of the schoolbook product of a, b [L, n]
    (column k: sum of a_i b_j over i + j = k, each below L 2^32)."""
    L, n = a.shape
    prod = a[:, None, :] * b[None, :, :]  # [L, L, n], each < 2^32
    # anti-diagonal sums: pad rows to 2L and re-view with row length 2L-1,
    # which puts a_i * b_j in column i + j of row i
    padded = torch.nn.functional.pad(prod, (0, 0, 0, L)).reshape(2 * L * L, n)
    return padded[: L * (2 * L - 1)].reshape(L, 2 * L - 1, n)[:, :cols].sum(0)


def _carry3(t: torch.Tensor) -> torch.Tensor:
    """Three carry passes over column sums t [K, n] below 2^40, in place:
    limbs 1..K-2 end in [0, 2^16] (2^16 itself not carried on), limb 0
    below 2^16, and the top limb keeps the rest."""
    for _ in range(3):
        c = t[:-1] >> 16
        t[:-1] &= LIMB_MASK
        t[1:] += c
    return t


_REDC_COLUMNS = 64  # up to this many columns a product takes `_mul_redc`


def _mul_redc(F: LimbField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product with the reduction on whole columns, T = a b,
    m = (T mod R)(-p^-1) mod R, (T + m p) / R, with no carry ripple: limbs
    in [0, 2^16] after three passes leave a value below 2R, so m is m or
    m + R, the low half of T + m p is 0 or R (it is R unless every limb is
    0) and (T + m p) / R is below 3p.  A fixed number of tensor ops whatever
    L, for narrow batches, where the op count is the cost."""
    L, n = a.shape
    t = _columns(a, b, 2 * L - 1)
    lo = _carry3(t[:L].clone())
    lo[-1] &= LIMB_MASK  # mod R
    m = _carry3(_columns(lo, F.n_inv(a.device).expand(L, n), L))
    m[-1] &= LIMB_MASK
    u = _carry3(torch.cat([t + _columns(m, F.p(a.device)[:-1].expand(L, n), 2 * L - 1),
                           t.new_zeros(2, n)]))
    hi = u[L:].clone()
    hi[0] += (u[:L] != 0).any(0)
    hi = normalize(hi)
    P = F.p(a.device)
    for _ in range(2):  # below 3p -> below p
        d = normalize(hi - P)
        hi = torch.where(d[-1:] < 0, hi, d)
    return hi[:-1].contiguous()


def _mul_cols(F: LimbField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.shape[1] <= _REDC_COLUMNS:
        return _mul_redc(F, a, b)
    L = F.L
    n = a.shape[1]
    t = torch.cat([_columns(a, b, 2 * L - 1), a.new_zeros(2, n)])  # [2L + 1, n]
    P = F.p(a.device)[:-1]
    for i in range(L):  # word-by-word Montgomery reduction (SOS), light on memory
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


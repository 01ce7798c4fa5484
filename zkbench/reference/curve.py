"""BLS12-381 scalars and G1 in plain Python integers.

The constants are the curve's published ones: Fr and Fq moduli, the G1
generator, b = 4, and 7 as Fr's multiplicative generator (roots of unity
omega_n = 7^((r-1)/n)).  Points are affine (x, y) tuples or None for the
identity; sums run in jacobian coordinates.
"""

from __future__ import annotations

R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
B = 4
FR_GENERATOR = 7

INF = (1, 1, 0)


def omega(n: int) -> int:
    """A primitive n-th root of unity in Fr (n a power of two)."""
    return pow(FR_GENERATOR, (R - 1) // n, R)


def lagrange_at(z: int, size: int) -> list[int]:
    """L_i(z) for every i of the size-point domain {omega^i}."""
    w = omega(size)
    zn = pow(z, size, R)
    pows, acc = [], 1
    for _ in range(size):
        pows.append(acc)
        acc = acc * w % R
    if zn == 1:
        return [1 if (z - p) % R == 0 else 0 for p in pows]
    scale = (zn - 1) * pow(size, -1, R) % R
    diffs = [(z - p) % R for p in pows]
    # one inversion for the whole domain (Montgomery's trick)
    prefix, acc = [], 1
    for d in diffs:
        prefix.append(acc)
        acc = acc * d % R
    inv = pow(acc, -1, R)
    out = [0] * size
    for i in range(size - 1, -1, -1):
        out[i] = scale * pows[i] % R * (inv * prefix[i] % R) % R
        inv = inv * diffs[i] % R
    return out


def on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return 0 <= x < Q and 0 <= y < Q and (y * y - x * x * x - B) % Q == 0


def _dbl(p):
    X, Y, Z = p
    if Z == 0 or Y == 0:
        return INF
    A = X * X % Q
    Bq = Y * Y % Q
    C = Bq * Bq % Q
    D = 2 * ((X + Bq) * (X + Bq) - A - C) % Q
    E = 3 * A % Q
    X3 = (E * E - 2 * D) % Q
    Y3 = (E * (D - X3) - 8 * C) % Q
    Z3 = 2 * Y * Z % Q
    return (X3, Y3, Z3)


def _add(p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == 0:
        return q
    if Z2 == 0:
        return p
    Z1Z1 = Z1 * Z1 % Q
    Z2Z2 = Z2 * Z2 % Q
    U1 = X1 * Z2Z2 % Q
    U2 = X2 * Z1Z1 % Q
    S1 = Y1 * Z2 % Q * Z2Z2 % Q
    S2 = Y2 * Z1 % Q * Z1Z1 % Q
    H = (U2 - U1) % Q
    Rr = (S2 - S1) % Q
    if H == 0:
        return _dbl(p) if Rr == 0 else INF
    HH = H * H % Q
    HHH = H * HH % Q
    V = U1 * HH % Q
    X3 = (Rr * Rr - HHH - 2 * V) % Q
    Y3 = (Rr * (V - X3) - S1 * HHH) % Q
    Z3 = Z1 * Z2 % Q * H % Q
    return (X3, Y3, Z3)


def _jac(p):
    return INF if p is None else (p[0], p[1], 1)


def _mul_jac(pj, k: int):
    """k * P by 4-bit windows (k taken as it is, not reduced)."""
    if k == 0 or pj[2] == 0:
        return INF
    table = [INF, pj]
    for _ in range(14):
        table.append(_add(table[-1], pj))
    acc = INF
    for shift in range((k.bit_length() + 3) // 4 * 4 - 4, -4, -4):
        for _ in range(4):
            acc = _dbl(acc)
        d = (k >> shift) & 15
        if d:
            acc = _add(acc, table[d])
    return acc


def affine(pj):
    X, Y, Z = pj
    if Z == 0:
        return None
    zi = pow(Z, -1, Q)
    zi2 = zi * zi % Q
    return (X * zi2 % Q, Y * zi2 % Q * zi % Q)


def mul(p, k: int):
    """k * P for an affine P, k reduced mod r."""
    return affine(_mul_jac(_jac(p), k % R))


def in_subgroup(p) -> bool:
    return p is None or _mul_jac(_jac(p), R)[2] == 0


def lincomb(terms) -> object:
    """sum of k * P over (affine P, scalar k) pairs, affine."""
    acc = INF
    for p, k in terms:
        k %= R
        if k and p is not None:
            acc = _add(acc, _mul_jac(_jac(p), k))
    return affine(acc)

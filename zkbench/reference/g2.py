"""BLS12-381 G2 in plain Python integers.

Fq2 = Fq[u] / (u^2 + 1); an element is a pair (a, b) = a + b u.  G2 is the
curve y^2 = x^3 + 4 (1 + u) over Fq2 with the published generator.  Points
are affine ((x0, x1), (y0, y1)) tuples or None for the identity; sums run
in jacobian coordinates, by the same formulas as `curve.py`'s G1.
"""

from __future__ import annotations

from .curve import Q, R

B2 = (4, 4)
G2_GEN = (
    (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
     0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
    (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
     0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
)

ZERO, ONE = (0, 0), (1, 0)
INF = (ONE, ONE, ZERO)


def add2(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def sub2(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def mul2(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)


def scale2(a, k: int):
    return (a[0] * k % Q, a[1] * k % Q)


def inv2(a):
    n = pow((a[0] * a[0] + a[1] * a[1]) % Q, -1, Q)
    return (a[0] * n % Q, -a[1] * n % Q)


def on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    if not all(0 <= c < Q for c in (*x, *y)):
        return False
    return sub2(mul2(y, y), add2(mul2(mul2(x, x), x), B2)) == ZERO


def _dbl(p):
    X, Y, Z = p
    if Z == ZERO or Y == ZERO:
        return INF
    A = mul2(X, X)
    Bq = mul2(Y, Y)
    C = mul2(Bq, Bq)
    XB = add2(X, Bq)
    D = scale2(sub2(sub2(mul2(XB, XB), A), C), 2)
    E = scale2(A, 3)
    X3 = sub2(mul2(E, E), scale2(D, 2))
    Y3 = sub2(mul2(E, sub2(D, X3)), scale2(C, 8))
    Z3 = scale2(mul2(Y, Z), 2)
    return (X3, Y3, Z3)


def _add(p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == ZERO:
        return q
    if Z2 == ZERO:
        return p
    Z1Z1 = mul2(Z1, Z1)
    Z2Z2 = mul2(Z2, Z2)
    U1 = mul2(X1, Z2Z2)
    U2 = mul2(X2, Z1Z1)
    S1 = mul2(mul2(Y1, Z2), Z2Z2)
    S2 = mul2(mul2(Y2, Z1), Z1Z1)
    H = sub2(U2, U1)
    Rr = sub2(S2, S1)
    if H == ZERO:
        return _dbl(p) if Rr == ZERO else INF
    HH = mul2(H, H)
    HHH = mul2(H, HH)
    V = mul2(U1, HH)
    X3 = sub2(sub2(sub2(mul2(Rr, Rr), HHH), V), V)
    Y3 = sub2(mul2(Rr, sub2(V, X3)), mul2(S1, HHH))
    Z3 = mul2(mul2(Z1, Z2), H)
    return (X3, Y3, Z3)


def _jac(p):
    return INF if p is None else (p[0], p[1], ONE)


def affine(pj):
    X, Y, Z = pj
    if Z == ZERO:
        return None
    zi = inv2(Z)
    zi2 = mul2(zi, zi)
    return (mul2(X, zi2), mul2(mul2(Y, zi2), zi))


def times(p, k: int):
    """k * P for an affine P by double-and-add from the top bit, k taken as
    it is (not reduced mod r)."""
    acc, pj = INF, _jac(p)
    for bit in bin(k)[2:] if k > 0 else "":
        acc = _dbl(acc)
        if bit == "1":
            acc = _add(acc, pj)
    return affine(acc)


def mul(p, k: int):
    """k * P for an affine P, k reduced mod r."""
    return times(p, k % R)


def add(p, q):
    return affine(_add(_jac(p), _jac(q)))

"""Host-side exact BLS12-381 group arithmetic (Python ints).

Used for: the verifier-side group algebra (tiny point counts), the Horner
combination tails of device MSMs, G2 operations for setup, and as the oracle
for the device curve kernels.  Generic over the coordinate field so G1 (Fq)
and G2 (Fq2) share one implementation.
"""

from __future__ import annotations

from ..fields import Q_MOD, R_MOD, G1_GEN_X, G1_GEN_Y, G2_GEN_X, G2_GEN_Y

# ---------------------------------------------------------------------------
# Coordinate fields: Fq and Fq2 with a uniform interface
# ---------------------------------------------------------------------------


class Fq:
    @staticmethod
    def add(a, b):
        return (a + b) % Q_MOD

    @staticmethod
    def sub(a, b):
        return (a - b) % Q_MOD

    @staticmethod
    def mul(a, b):
        return (a * b) % Q_MOD

    @staticmethod
    def inv(a):
        return pow(a, -1, Q_MOD)

    @staticmethod
    def neg(a):
        return (-a) % Q_MOD

    zero = 0
    one = 1

    @staticmethod
    def is_zero(a):
        return a == 0

    @staticmethod
    def eq(a, b):
        return a % Q_MOD == b % Q_MOD


class Fq2:
    """Fq[u]/(u^2 + 1); elements are (c0, c1) tuples."""

    zero = (0, 0)
    one = (1, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % Q_MOD, (a[1] + b[1]) % Q_MOD)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % Q_MOD, (a[1] - b[1]) % Q_MOD)

    @staticmethod
    def mul(a, b):
        a0, a1 = a
        b0, b1 = b
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = (a0 + a1) * (b0 + b1)
        return ((t0 - t1) % Q_MOD, (t2 - t0 - t1) % Q_MOD)

    @staticmethod
    def inv(a):
        a0, a1 = a
        norm = (a0 * a0 + a1 * a1) % Q_MOD
        ninv = pow(norm, -1, Q_MOD)
        return ((a0 * ninv) % Q_MOD, (-a1 * ninv) % Q_MOD)

    @staticmethod
    def neg(a):
        return ((-a[0]) % Q_MOD, (-a[1]) % Q_MOD)

    @staticmethod
    def is_zero(a):
        return a[0] % Q_MOD == 0 and a[1] % Q_MOD == 0

    @staticmethod
    def eq(a, b):
        return (a[0] - b[0]) % Q_MOD == 0 and (a[1] - b[1]) % Q_MOD == 0


# ---------------------------------------------------------------------------
# Short Weierstrass y^2 = x^3 + b in Jacobian coordinates, generic field
# ---------------------------------------------------------------------------


class CurveGroup:
    def __init__(self, field, b, gen_affine, name):
        self.F = field
        self.b = b
        self.gen = gen_affine
        self.name = name

    # Points are (X, Y, Z) jacobian; Z == field.zero means infinity.
    @property
    def infinity(self):
        return (self.F.one, self.F.one, self.F.zero)

    def from_affine(self, p):
        if p is None:
            return self.infinity
        x, y = p
        return (x, y, self.F.one)

    def to_affine(self, p):
        X, Y, Z = p
        if self.F.is_zero(Z):
            return None
        zi = self.F.inv(Z)
        zi2 = self.F.mul(zi, zi)
        return (self.F.mul(X, zi2), self.F.mul(Y, self.F.mul(zi2, zi)))

    def is_on_curve_affine(self, p) -> bool:
        if p is None:
            return True
        x, y = p
        F = self.F
        lhs = F.mul(y, y)
        rhs = F.add(F.mul(F.mul(x, x), x), self.b)
        return F.eq(lhs, rhs)

    def double(self, p):
        F = self.F
        X, Y, Z = p
        if F.is_zero(Z) or F.is_zero(Y):
            return self.infinity
        A = F.mul(X, X)
        B = F.mul(Y, Y)
        C = F.mul(B, B)
        t = F.add(X, B)
        D = F.sub(F.sub(F.mul(t, t), A), C)
        D = F.add(D, D)
        E = F.add(F.add(A, A), A)
        Fv = F.mul(E, E)
        X3 = F.sub(Fv, F.add(D, D))
        C8 = F.add(F.add(C, C), F.add(C, C))
        C8 = F.add(C8, C8)
        Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
        Z3 = F.add(F.mul(Y, Z), F.mul(Y, Z))
        return (X3, Y3, Z3)

    def add(self, p, q):
        F = self.F
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        if F.is_zero(Z1):
            return q
        if F.is_zero(Z2):
            return p
        Z1Z1 = F.mul(Z1, Z1)
        Z2Z2 = F.mul(Z2, Z2)
        U1 = F.mul(X1, Z2Z2)
        U2 = F.mul(X2, Z1Z1)
        S1 = F.mul(Y1, F.mul(Z2, Z2Z2))
        S2 = F.mul(Y2, F.mul(Z1, Z1Z1))
        H = F.sub(U2, U1)
        R = F.sub(S2, S1)
        if F.is_zero(H):
            if F.is_zero(R):
                return self.double(p)
            return self.infinity
        HH = F.mul(H, H)
        HHH = F.mul(H, HH)
        V = F.mul(U1, HH)
        X3 = F.sub(F.sub(F.mul(R, R), HHH), F.add(V, V))
        Y3 = F.sub(F.mul(R, F.sub(V, X3)), F.mul(S1, HHH))
        Z3 = F.mul(F.mul(Z1, Z2), H)
        return (X3, Y3, Z3)

    def neg(self, p):
        X, Y, Z = p
        return (X, self.F.neg(Y), Z)

    def scalar_mul(self, p, k: int):
        k = k % R_MOD
        acc = self.infinity
        base = p
        while k:
            if k & 1:
                acc = self.add(acc, base)
            base = self.double(base)
            k >>= 1
        return acc

    def msm_affine(self, scalars, points_affine):
        """Small-size oracle MSM: sum of k_i * P_i."""
        acc = self.infinity
        for k, pa in zip(scalars, points_affine):
            acc = self.add(acc, self.scalar_mul(self.from_affine(pa), k))
        return self.to_affine(acc)

    def msm_pow2(self, exps, points_affine):
        """sum 2^e_i * P_i -> jacobian point.

        Horner over exponent levels (max(e) doublings + len(points) adds),
        the exact combine the device MSM's weighted window singles need
        (backend/pallas_kernels.py g1_msm): every window weight there is a
        power of two.  Mirrors the reference's host-side window combine in
        ICICLE-CPU msm (the "tiny sequential tail" stays on CPU)."""
        by_exp: dict = {}
        for e, pa in zip(exps, points_affine):
            if pa is None:
                continue
            by_exp.setdefault(int(e), []).append(pa)
        acc = self.infinity
        if not by_exp:
            return acc
        for e in range(max(by_exp), -1, -1):
            acc = self.double(acc)
            for pa in by_exp.get(e, ()):
                acc = self.add(acc, self.from_affine(pa))
        return acc

    def msm_pow2_jac(self, exps, points_jac):
        """msm_pow2 over jacobian input points (Z == 0 means infinity)."""
        by_exp: dict = {}
        for e, p in zip(exps, points_jac):
            if self.F.is_zero(p[2]):
                continue
            by_exp.setdefault(int(e), []).append(p)
        acc = self.infinity
        if not by_exp:
            return acc
        for e in range(max(by_exp), -1, -1):
            acc = self.double(acc)
            for p in by_exp.get(e, ()):
                acc = self.add(acc, p)
        return acc


G1 = CurveGroup(Fq, 4, (G1_GEN_X, G1_GEN_Y), "G1")
G2 = CurveGroup(Fq2, (4, 4), (G2_GEN_X, G2_GEN_Y), "G2")


def g1_scalar_mul_affine(p_affine, k: int):
    return G1.to_affine(G1.scalar_mul(G1.from_affine(p_affine), k))


def g2_scalar_mul_affine(p_affine, k: int):
    return G2.to_affine(G2.scalar_mul(G2.from_affine(p_affine), k))

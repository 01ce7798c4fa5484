"""Bivariate polynomial engine over Fr -- the port of the JAX `BiPoly`.

  * coefficients live on the device as `[16, x_size, y_size]` int32 grids in
    Montgomery form (x = X power, y = Y power, the reference's index
    convention);
  * products go through the batched bivariate NTT;
  * `div_by_vanishing_opt` is block cumulative sums (the block count
    x_size / c is tiny -- 2 or 4 in the protocol);
  * `div_by_ruffini` is suffix sums of p_t * x^t instead of a per-row Horner
    loop.

Degree bookkeeping follows the reference's lazy rule: sizes are powers of two
and `*_degree` defaults to `size - 1` until `find_degree`/`optimized`
tightens it.
"""

from __future__ import annotations

import torch

from ..fields import R_MOD
from . import field as F
from . import ntt as ntt_mod

L = F.FR_L


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def _scalar_of(coeffs) -> int:
    """Host value of the [0, 0] coefficient of a [16, x, y] grid."""
    return int(F.unpack_fr(coeffs[:, 0, 0].reshape(L, 1)).reshape(-1)[0])


class BiPoly:
    """Device-resident bivariate polynomial over Fr (Montgomery coeffs)."""

    __slots__ = ("coeffs", "x_degree", "y_degree")

    def __init__(self, coeffs, x_degree=None, y_degree=None):
        if coeffs.dim() != 3 or coeffs.shape[0] != L:
            raise ValueError(f"BiPoly wants a [16, x, y] grid, got {tuple(coeffs.shape)}")
        self.coeffs = coeffs
        self.x_degree = coeffs.shape[1] - 1 if x_degree is None else x_degree
        self.y_degree = coeffs.shape[2] - 1 if y_degree is None else y_degree

    # -- construction ---------------------------------------------------
    @property
    def x_size(self):
        return self.coeffs.shape[1]

    @property
    def y_size(self):
        return self.coeffs.shape[2]

    @property
    def device(self):
        return self.coeffs.device

    @staticmethod
    def zero(x_size=1, y_size=1, device="cpu"):
        return BiPoly(F.fr_zero((x_size, y_size), device), -1, -1)

    @staticmethod
    def from_ints(grid, device) -> "BiPoly":
        """Host list-of-lists of Python ints -> BiPoly."""
        arr = F.pack_fr(grid)
        if arr.ndim != 3:
            raise ValueError("from_ints wants a 2-D grid")
        return BiPoly(F.tensor(arr, device))

    @staticmethod
    def from_coeffs(coeffs) -> "BiPoly":
        return BiPoly(coeffs)

    @staticmethod
    def from_rou_evals(evals, coset_x: int | None = None, coset_y: int | None = None):
        """evals: [16, x_size, y_size] device grid of evaluations."""
        return BiPoly(ntt_mod.bintt(evals, inverse=True, coset_x=coset_x, coset_y=coset_y))

    def to_rou_evals(self, coset_x: int | None = None, coset_y: int | None = None):
        return ntt_mod.bintt(self.coeffs, coset_x=coset_x, coset_y=coset_y)

    def to_ints(self):
        """Host grid of Python ints (numpy object array [x, y])."""
        return F.unpack_fr(self.coeffs)

    def clone(self):
        return BiPoly(self.coeffs, self.x_degree, self.y_degree)

    # -- shape management ----------------------------------------------
    def resized(self, target_x: int, target_y: int) -> "BiPoly":
        """Pad/truncate to next-pow2 of targets (reference `resize`)."""
        nx, ny = _next_pow2(target_x), _next_pow2(target_y)
        if nx == self.x_size and ny == self.y_size:
            return self
        c = self.coeffs
        cx = min(self.x_size, nx)
        cy = min(self.y_size, ny)
        out = F.fr_zero((nx, ny), c.device)
        out[:, :cx, :cy] = c[:, :cx, :cy]
        return BiPoly(out, min(self.x_degree, nx - 1), min(self.y_degree, ny - 1))

    def find_degree(self) -> tuple[int, int]:
        """Exact (x, y) degrees, reduced on the device; two ints come home.
        The result tightens the cached bounds, so repeat calls are free."""
        if (self.x_degree, self.y_degree) == (-1, -1):
            return -1, -1
        nz = (self.coeffs != 0).any(0)  # [x, y]
        rows = nz.any(1)
        cols = nz.any(0)
        ar_x = torch.arange(rows.shape[0], device=nz.device)
        ar_y = torch.arange(cols.shape[0], device=nz.device)
        xi = torch.where(rows, ar_x, -1).max()
        yi = torch.where(cols, ar_y, -1).max()
        xd, yd = (int(v) for v in torch.stack([xi, yi]).cpu())
        self.x_degree, self.y_degree = xd, yd
        return xd, yd

    def optimized(self) -> "BiPoly":
        xd, yd = self.find_degree()
        if xd < 0 or yd < 0:
            return BiPoly(self.coeffs, xd, yd)
        out = self.resized(xd + 1, yd + 1)
        return BiPoly(out.coeffs, xd, yd)

    # -- ring ops -------------------------------------------------------
    def _common(self, other: "BiPoly"):
        tx = max(self.x_size, other.x_size)
        ty = max(self.y_size, other.y_size)
        return self.resized(tx, ty), other.resized(tx, ty)

    def __add__(self, other):
        if isinstance(other, int):
            return self.add_scalar(other)
        a, b = self._common(other)
        return BiPoly(F.fr_add(a.coeffs, b.coeffs))

    def __sub__(self, other):
        if isinstance(other, int):
            return self.add_scalar((-other) % R_MOD)
        a, b = self._common(other)
        return BiPoly(F.fr_sub(a.coeffs, b.coeffs))

    def __neg__(self):
        return BiPoly(F.fr_neg(self.coeffs), self.x_degree, self.y_degree)

    def add_scalar(self, s: int) -> "BiPoly":
        """Add a constant (into coefficient [0, 0])."""
        c = self.coeffs.clone()
        c[:, 0, 0] = F.fr_add(self.coeffs[:, 0:1, 0], F.fr_mont(s))[:, 0]
        return BiPoly(c, self.x_degree, self.y_degree)

    def mul_scalar(self, s: int) -> "BiPoly":
        return BiPoly(F.fr_mul(self.coeffs, F.fr_mont(s)[:, 0]),
                      self.x_degree, self.y_degree)

    def __mul__(self, other):
        if isinstance(other, int):
            return self.mul_scalar(other)
        lxd, lyd = self.find_degree()
        rxd, ryd = other.find_degree()
        if lxd == 0 and lyd == 0 and (rxd + ryd) > 0:
            return other.mul_scalar(_scalar_of(self.coeffs))
        if rxd == 0 and ryd == 0:
            return self.mul_scalar(_scalar_of(other.coeffs))
        if lxd < 0 or rxd < 0:
            return BiPoly.zero(device=self.device)
        tx, ty = lxd + rxd + 1, lyd + ryd + 1
        a = self.resized(tx, ty)
        b = other.resized(a.x_size, a.y_size)
        prod = F.fr_mul(a.to_rou_evals(), b.to_rou_evals())
        return BiPoly(ntt_mod.bintt(prod, inverse=True))

    def mul_monomial(self, xe: int, ye: int) -> "BiPoly":
        if xe == 0 and ye == 0:
            return self.clone()
        tx = (self.x_degree + 1) + xe
        ty = (self.y_degree + 1) + ye
        nx, ny = _next_pow2(tx), _next_pow2(ty)
        out = F.fr_zero((nx, ny), self.device)
        cx = min(self.x_size, nx - xe)
        cy = min(self.y_size, ny - ye)
        out[:, xe : xe + cx, ye : ye + cy] = self.coeffs[:, :cx, :cy]
        return BiPoly(out)

    # -- evaluation -----------------------------------------------------
    def eval_y_axis(self, y: int):
        """Contract the Y axis at point y -> [16, x_size] device column."""
        return F.fr_sum(F.fr_mul(self.coeffs, F.fr_powers(y, self.y_size)), axis=1)

    def eval_device(self, x: int, y: int):
        """eval(x, y) left on the device as a [16] column (see eval_many)."""
        col = self.eval_y_axis(y)
        return F.fr_sum(F.fr_mul(col, F.fr_powers(x, self.x_size)), axis=0)

    def eval(self, x: int, y: int) -> int:
        val = self.eval_device(x, y)
        return int(F.unpack_fr(val.reshape(L, 1)).reshape(-1)[0])

    def scale_coeffs_x(self, factor: int) -> "BiPoly":
        """coeff[i][j] *= factor^i (substitutes X -> factor*X)."""
        px = F.fr_powers(factor, self.x_size)  # [16, x]: prefix broadcast
        return BiPoly(F.fr_mul(self.coeffs, px), self.x_degree, self.y_degree)

    def scale_coeffs_y(self, factor: int) -> "BiPoly":
        py = F.fr_powers(factor, self.y_size)
        return BiPoly(F.fr_mul(self.coeffs, py), self.x_degree, self.y_degree)

    # -- divisions ------------------------------------------------------
    def div_by_vanishing_opt(self, c: int, d: int):
        """Divide by (X^c - 1) and (Y^d - 1): P = qx*(X^c-1) + qy*(Y^d-1).

        Pure coefficient recurrences as block cumulative sums.  Requires
        exact divisibility (P vanishing on the product domain).
        """
        p = self.optimized()
        x_size, y_size = p.x_size, p.y_size
        if x_size % c or y_size % d:
            raise ValueError("numerator too small")
        m, n = x_size // c, y_size // d
        coeffs = p.coeffs
        dev = coeffs.device

        acc = coeffs.reshape(L, m, c, y_size)
        accs = acc[:, 0]
        for i in range(1, m):
            accs = F.fr_add(accs, acc[:, i])  # [16, c, y_size]

        # quo_y blocks: q[j] = -(acc_blk[0] + ... + acc_blk[j]), j < n-1
        acc_blk = accs.reshape(L, c, n, d)
        qy_blocks = []
        run = None
        for j in range(n - 1):
            run = acc_blk[:, :, j] if run is None else F.fr_add(run, acc_blk[:, :, j])
            qy_blocks.append(F.fr_neg(run))
        if qy_blocks:
            qy_core = torch.stack(qy_blocks, dim=2)  # [16, c, n-1, d]
            qy_full = torch.cat([qy_core, F.fr_zero((c, 1, d), dev)], dim=2)
            qy_full = qy_full.reshape(L, c, y_size)
        else:
            qy_full = F.fr_zero((c, y_size), dev)

        # B = P - quo_y*(Y^d - 1)  (only rows < c are touched)
        shifted = torch.zeros_like(qy_full)
        shifted[:, :, d:] = qy_full[:, :, : y_size - d]
        b_top = F.fr_sub(F.fr_add(coeffs[:, :c], qy_full), shifted)
        b = torch.cat([b_top, coeffs[:, c:]], dim=1)

        # quo_x blocks: q[i] = -(B_blk[0] + ... + B_blk[i]), i < m-1
        b_blk = b.reshape(L, m, c, y_size)
        qx_blocks = []
        run = None
        for i in range(m - 1):
            run = b_blk[:, i] if run is None else F.fr_add(run, b_blk[:, i])
            qx_blocks.append(F.fr_neg(run))
        if qx_blocks:
            qx_full = torch.cat(qx_blocks + [F.fr_zero((c, y_size), dev)], dim=1)
        else:
            qx_full = F.fr_zero((x_size, y_size), dev)

        quo_x = BiPoly(
            qx_full,
            (x_size - c - 1) if x_size > c else -1,
            (y_size - 1) if x_size > c else -1,
        )
        quo_y = BiPoly(
            qy_full,
            (c - 1) if y_size > d else -1,
            (y_size - d - 1) if y_size > d else -1,
        )
        return quo_x, quo_y

    def div_by_ruffini(self, x: int, y: int, lazy_rem: bool = False):
        """P = Q_X*(X-x) + Q_Y(Y)*(Y-y) + r.

        The Horner recurrences become suffix sums: with S_i = sum_{t>=i}
        p_t x^t,  q_i = S_{i+1} * x^{-(i+1)}, and the X-remainder column is S_0.
        lazy_rem=True returns the remainder as a [16] device column instead of
        a host int.
        """
        x = x % R_MOD
        y = y % R_MOD
        x_len, y_len = self.x_size, self.y_size
        coeffs = self.coeffs
        dev = coeffs.device

        if x == 0:
            qx = torch.zeros_like(coeffs)
            qx[:, : x_len - 1] = coeffs[:, 1:]
            rcol = coeffs[:, 0]  # [16, y_len]
        else:
            s = F.fr_suffix_sum(F.fr_mul(coeffs, F.fr_powers(x, x_len)), axis=0)
            s_next = torch.cat([s[:, 1:], F.fr_zero((1, y_len), dev)], dim=1)
            xinv = pow(x, -1, R_MOD)
            pxinv = F.fr_mul(F.tensor(F.fr_powers(xinv, x_len), dev), F.fr_mont(xinv)[:, 0])
            qx = F.fr_mul(s_next, pxinv)
            rcol = s[:, 0]

        # divide the remainder column R(Y) by (Y - y)
        if y == 0:
            qy = torch.zeros_like(rcol)
            qy[:, : y_len - 1] = rcol[:, 1:]
            rem = rcol[:, 0]
        else:
            s = F.fr_suffix_sum(F.fr_mul(rcol, F.fr_powers(y, y_len)), axis=0)
            s_next = torch.cat([s[:, 1:], F.fr_zero((1,), dev)], dim=1)
            yinv = pow(y, -1, R_MOD)
            pyinv = F.fr_mul(F.tensor(F.fr_powers(yinv, y_len), dev), F.fr_mont(yinv)[:, 0])
            qy = F.fr_mul(s_next, pyinv)
            rem = s[:, 0]

        if lazy_rem:
            return BiPoly(qx), BiPoly(qy[:, None, :]), rem
        return (
            BiPoly(qx),
            BiPoly(qy[:, None, :]),
            int(F.unpack_fr(rem.reshape(L, 1)).reshape(-1)[0]),
        )


def eval_many(items) -> list[int]:
    """Evaluate [(poly, x, y), ...] with ONE host pull."""
    if not items:
        return []
    vals = [p.eval_device(x, y) for p, x, y in items]
    stacked = torch.stack(vals, dim=1)  # [16, k]
    return [int(v) for v in F.unpack_fr(stacked).reshape(-1)]


def from_const(s: int, device) -> BiPoly:
    return BiPoly.from_ints([[s % R_MOD]], device)


def x_monomial(device) -> BiPoly:
    """The polynomial X (sizes (2, 1) as in the reference prover)."""
    return BiPoly.from_ints([[0], [1]], device)


def y_monomial(device) -> BiPoly:
    return BiPoly.from_ints([[0, 1]], device)


def low_degree_x_times_vanishing(coeffs: list[int], exponent: int, device) -> BiPoly:
    """coeffs(X) * (X^exponent - 1), as a (next_pow2, 1) poly."""
    x_size = _next_pow2(exponent + len(coeffs))
    out = [0] * x_size
    for i, cc in enumerate(coeffs):
        out[i] = (out[i] - cc) % R_MOD
        out[i + exponent] = (out[i + exponent] + cc) % R_MOD
    return BiPoly.from_ints([[v] for v in out], device)


def low_degree_y_times_vanishing(coeffs: list[int], exponent: int, device) -> BiPoly:
    y_size = _next_pow2(exponent + len(coeffs))
    out = [0] * y_size
    for i, cc in enumerate(coeffs):
        out[i] = (out[i] - cc) % R_MOD
        out[i + exponent] = (out[i + exponent] + cc) % R_MOD
    return BiPoly.from_ints([out], device)

"""Host-side exact oracle (Python ints) for testing the port's kernels.

Intentionally simple/slow O(n^2) implementations — the point is independent
ground truth, mirroring the reference's oracle strategy (the browser backend
checks against a pure-TS reference NTT, `backend-wasm/test/support/polynomial/
ntt-reference.ts`; we do the same with Python ints).
"""

from __future__ import annotations

from ..fields import FR, R_MOD, fr_root_of_unity


def dft(coeffs: list[int], coset: int = 1) -> list[int]:
    """evals[i] = P(coset * omega^i)."""
    n = len(coeffs)
    omega = fr_root_of_unity(n)
    out = []
    for i in range(n):
        x = (coset * pow(omega, i, R_MOD)) % R_MOD
        acc = 0
        xp = 1
        for c in coeffs:
            acc = (acc + c * xp) % R_MOD
            xp = (xp * x) % R_MOD
        out.append(acc)
    return out


def idft(evals: list[int], coset: int = 1) -> list[int]:
    n = len(evals)
    omega_inv = pow(fr_root_of_unity(n), -1, R_MOD)
    n_inv = pow(n, -1, R_MOD)
    coset_inv = pow(coset, -1, R_MOD)
    out = []
    for j in range(n):
        acc = 0
        for i, e in enumerate(evals):
            acc = (acc + e * pow(omega_inv, i * j, R_MOD)) % R_MOD
        acc = (acc * n_inv * pow(coset_inv, j, R_MOD)) % R_MOD
        out.append(acc)
    return out


def bi_dft(grid: list[list[int]], coset_x: int = 1, coset_y: int = 1) -> list[list[int]]:
    """grid[i][j] coefficient of X^i Y^j -> evals[a][b] = P(cx*wx^a, cy*wy^b)."""
    x_size = len(grid)
    y_size = len(grid[0])
    # transform along y
    rows = [dft(row, coset_y) for row in grid]
    # transform along x
    cols = [[rows[i][j] for i in range(x_size)] for j in range(y_size)]
    cols_t = [dft(col, coset_x) for col in cols]
    return [[cols_t[j][i] for j in range(y_size)] for i in range(x_size)]


def bi_idft(evals: list[list[int]], coset_x: int = 1, coset_y: int = 1) -> list[list[int]]:
    x_size = len(evals)
    y_size = len(evals[0])
    rows = [idft(row, coset_y) for row in evals]
    cols = [[rows[i][j] for i in range(x_size)] for j in range(y_size)]
    cols_t = [idft(col, coset_x) for col in cols]
    return [[cols_t[j][i] for j in range(y_size)] for i in range(x_size)]


def poly_eval_xy(grid: list[list[int]], x: int, y: int) -> int:
    acc = 0
    for i, row in enumerate(grid):
        for j, c in enumerate(row):
            acc = (acc + c * pow(x, i, R_MOD) * pow(y, j, R_MOD)) % R_MOD
    return acc

"""Witness / instance polynomial construction.

Counterpart of the reference's `polynomial_structures` and
`Permutation::to_poly`: evaluation grids are assembled on the host (sparse
bookkeeping) or by a scatter-add on the device, and interpolated with the
device bivariate inverse NTT.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import FR, R_MOD, fr_root_of_unity
from ..ops import field as F
from ..ops.poly import BiPoly
from .protocol import Instance, PermutationEntry, Placement, SetupParams, SubcircuitInfo, SubcircuitR1CS


def _pack_mont_dedup(vals) -> np.ndarray:
    """Montgomery-pack a list of ints paying the big-int conversion only per
    distinct value (witness grids repeat 0/1/selector constants heavily)."""
    arr = np.asarray([int(v) % R_MOD for v in vals], dtype=object)
    uniq, inv = np.unique(arr, return_inverse=True)
    packed = F.pack_fr(list(uniq))  # [16, U]
    return packed[:, inv]


def gen_bXY(placements: list[Placement], infos: list[SubcircuitInfo],
            params: SetupParams, device) -> BiPoly:
    """Interface-witness grid b(X,Y): rows = interface wires [l, l_D),
    columns = placements; only nonzero variables are packed."""
    m_i, s_max, l, l_d = params.m_i, params.s_max, params.l, params.l_D
    rows, cols, vals = [], [], []
    for i, pl in enumerate(placements):
        fm = infos[pl.subcircuit_id].flattenMap
        if len(fm) != len(pl.variables):
            raise ValueError("corrupted placement variables")
        garr = np.asarray(fm, dtype=np.int64)
        varr = np.asarray(pl.variables, dtype=object)
        sel = (garr >= l) & (garr < l_d) & (varr != 0)
        rows.append(garr[sel] - l)
        cols.append(np.full(int(sel.sum()), i, np.int64))
        vals.extend(varr[sel].tolist())
    grid = np.zeros((F.FR_L, m_i, s_max), np.int32)
    if vals:
        grid[:, np.concatenate(rows), np.concatenate(cols)] = _pack_mont_dedup(vals)
    return BiPoly.from_rou_evals(F.tensor(grid, device))


def _qap_col_arrays(r1cs: SubcircuitR1CS, which: str, device):
    """Flattened sparse-column arrays (wire, constraint-row, Montgomery
    coeff) for one subcircuit, cached on the R1CS object per device."""
    cache = r1cs.__dict__.setdefault("_qap_arrays_torch", {})
    key = (which, str(device))
    ent = cache.get(key)
    if ent is None:
        cols = getattr(r1cs, f"{which}_cols")
        W, Kc, C = [], [], []
        for wire, col in cols.items():
            for k, coeff in col:
                W.append(wire)
                Kc.append(k)
                C.append(coeff)
        ent = (
            np.asarray(W, np.int64),
            np.asarray(Kc, np.int64),
            F.tensor(_pack_mont_dedup(C), device) if C else None,
        )
        cache[key] = ent
    return ent


# S mod r for a limb-wise accumulated sum S = LO + 2^16*HI: one Montgomery
# product per half.  mm(a, b) = a*b*2^-256 mod r, so mm(LO, R mod r) = LO mod r
# and mm(HI, 2^16*R mod r) = 2^16*HI mod r (exact for any a < 2^256, b < r).
_C_LO = F.pack_fr([FR.R_mod % R_MOD], mont=False)
_C_HI = F.pack_fr([(FR.R_mod << 16) % R_MOD], mont=False)


def _reduce_u32_grid(acc):
    """[16, ...] limb-wise sums (held as uint32 words) -> exact mod r."""
    lo = (acc & 0xFFFF).to(torch.int32)
    hi = (acc >> 16).to(torch.int32)
    return F.fr_add(F.fr_mul(lo, _C_LO.reshape(F.FR_L)),
                    F.fr_mul(hi, _C_HI.reshape(F.FR_L)))


def _gen_qap_xy(placements: list[Placement], library: list[SubcircuitR1CS],
                params: SetupParams, which: str, device) -> BiPoly:
    """u/v/w(X,Y): per placement, the witness-weighted R1CS column combination
    on the n-domain.  Per subcircuit kind, the placement variables at the
    active wires are multiplied by the packed column coefficients on the
    device and their 16-bit limbs scatter-added into one grid of 32-bit word
    sums (limbs < 2^16 and constraint-row density << 2^16), reduced once."""
    n, s_max = params.n, params.s_max
    by_kind: dict[int, list[int]] = {}
    for i, pl in enumerate(placements):
        by_kind.setdefault(pl.subcircuit_id, []).append(i)

    acc = torch.zeros((F.FR_L, n * s_max), dtype=torch.int64, device=device)
    for sid, idxs in sorted(by_kind.items()):
        W, Kc, C_mont = _qap_col_arrays(library[sid], which, device)
        if C_mont is None:
            continue
        T = W.shape[0]
        vals = []
        for i in idxs:
            varr = np.asarray(placements[i].variables, dtype=object)
            vals.extend(varr[W].tolist())
        V = F.tensor(_pack_mont_dedup(vals).reshape(F.FR_L, len(idxs), T), device)
        prod = F.fr_mul(V, C_mont)  # cyclic suffix broadcast over placements
        flat = (Kc[None, :] * s_max + np.asarray(idxs, np.int64)[:, None]).reshape(-1)
        acc.index_add_(1, torch.as_tensor(flat, device=device),
                       prod.reshape(F.FR_L, -1).to(torch.int64))
    grid = _reduce_u32_grid(acc & 0xFFFFFFFF).reshape(F.FR_L, n, s_max)
    return BiPoly.from_rou_evals(grid)


def gen_uXY(placements, library, params, device):
    return _gen_qap_xy(placements, library, params, "A", device)


def gen_vXY(placements, library, params, device):
    return _gen_qap_xy(placements, library, params, "B", device)


def gen_wXY(placements, library, params, device):
    return _gen_qap_xy(placements, library, params, "C", device)


def permutation_to_polys(entries: list[PermutationEntry], m_i: int, s_max: int,
                         device) -> tuple[BiPoly, BiPoly]:
    """s^0, s^1 permutation polynomials: default grid (omega_x^row,
    omega_y^col), overridden by the cycle targets."""
    xp = F.fr_powers(fr_root_of_unity(m_i), m_i)  # [16, m_i] Montgomery
    yp = F.fr_powers(fr_root_of_unity(s_max), s_max)
    i0 = np.broadcast_to(np.arange(m_i, dtype=np.int64)[:, None], (m_i, s_max)).copy()
    j0 = np.broadcast_to(np.arange(s_max, dtype=np.int64)[None, :], (m_i, s_max)).copy()
    for e in entries:
        i0[e.row, e.col] = e.X
        j0[e.row, e.col] = e.Y
    return (
        BiPoly.from_rou_evals(F.tensor(xp[:, i0], device)),
        BiPoly.from_rou_evals(F.tensor(yp[:, j0], device)),
    )


def gen_a_free_X(instance: Instance, params: SetupParams, device) -> BiPoly:
    """Public-instance polynomial over the l_free domain."""
    m_block = params.l_free - params.l_user
    vals = [v % R_MOD for v in instance.a_pub_user[: params.l_user]]
    vals += [v % R_MOD for v in instance.a_pub_block[:m_block]]
    if len(vals) != params.l_free:
        raise ValueError("instance length does not match l_free")
    return BiPoly.from_rou_evals(F.tensor(F.pack_fr([[v] for v in vals]), device))


def vanishing_poly_x(n: int, device) -> BiPoly:
    """t_n(X) = X^n - 1 as a (2n, 1) grid."""
    grid = [[0] for _ in range(2 * n)]
    grid[0] = [(-1) % R_MOD]
    grid[n] = [1]
    return BiPoly.from_ints(grid, device)


def vanishing_poly_y(n: int, device) -> BiPoly:
    row = [0] * (2 * n)
    row[0] = (-1) % R_MOD
    row[n] = 1
    return BiPoly.from_ints([row], device)


def lagrange_kl_xy(m_i: int, s_max: int, device) -> BiPoly:
    """K_{m_i-1}(X) * L_{s_max-1}(Y)."""
    k = [[0] for _ in range(m_i)]
    k[m_i - 1] = [1]
    kx = BiPoly.from_rou_evals(F.tensor(F.pack_fr(k), device))
    l = [0] * s_max
    l[s_max - 1] = 1
    ly = BiPoly.from_rou_evals(F.tensor(F.pack_fr([l]), device))
    return kx * ly


def lagrange_k0_xy(m_i: int, device) -> BiPoly:
    k = [[0] for _ in range(m_i)]
    k[0] = [1]
    return BiPoly.from_rou_evals(F.tensor(F.pack_fr(k), device))

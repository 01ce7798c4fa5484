"""Witness / instance polynomial construction.

Counterpart of the reference's `polynomial_structures` and
`Permutation::to_poly`: evaluation grids are assembled on the host (sparse
bookkeeping) or by a scatter-add on the device, and interpolated with the
device bivariate inverse NTT.

A job's placement variables are converted to Montgomery limbs once:
`witness_table` writes them all as 32-byte integers in one host pass, sends
them to the device in one copy and multiplies them by R^2 mod r there with
K1's `fr_mul`.  The Prover builds that table in `init.witness` and hands it
to `gen_bXY`, `gen_uXY`, `gen_vXY` and `gen_wXY`, which gather their
entries from it.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from ..fields import FR, R_MOD, fr_root_of_unity
from ..ops import field as F
from ..ops.poly import BiPoly
from ..utils import timing
from .protocol import Instance, PermutationEntry, Placement, SetupParams, SubcircuitInfo, SubcircuitR1CS


def _pack_mont_dedup(vals) -> np.ndarray:
    """Montgomery-pack a list of ints paying the big-int conversion only per
    distinct value (the library's R1CS coefficients repeat heavily)."""
    arr = np.asarray([int(v) % R_MOD for v in vals], dtype=object)
    uniq, inv = np.unique(arr, return_inverse=True)
    packed = F.pack_fr(list(uniq))  # [16, U]
    return packed[:, inv]


# mm(x, R^2 mod r) = x*R mod r: standard limbs (x < r) to Montgomery form
_R2 = F.pack_fr([FR.R2_mod], mont=False).reshape(F.FR_L)


@dataclass
class WitnessTable:
    """Every placement variable of one job, Montgomery limbs on the device.

    `mont[:, s + j]` is variable j of a placement whose first column is s.
    `order` lists the placement indices grouped by subcircuit kind, and
    `kinds[sid]` is the slice of it that holds kind sid; `index[0]` is
    `order` on the device and `index[1]` each one's first column."""

    mont: torch.Tensor  # [16, N] int32
    index: torch.Tensor  # [2, P] int64
    order: np.ndarray  # [P]
    kinds: dict[int, slice]
    lengths: np.ndarray  # [P] each placement's variable count


def witness_table(placements: list[Placement], device) -> WitnessTable:
    """One job's placement variables, in placement order, reduced mod r (so
    values at or above r and negative ones keep their meaning), as one
    Montgomery table on `device`."""
    with timing.span("witness.convert", placements=len(placements)):
        lengths = np.asarray([len(pl.variables) for pl in placements], np.int64)
        by_kind: dict[int, list[int]] = {}
        for i, pl in enumerate(placements):
            by_kind.setdefault(pl.subcircuit_id, []).append(i)
        order, kinds = [], {}
        for sid in sorted(by_kind):
            kinds[sid] = slice(len(order), len(order) + len(by_kind[sid]))
            order += by_kind[sid]
        order = np.asarray(order, np.int64)
        starts = np.cumsum(lengths) - lengths
        parts = [(v % R_MOD).to_bytes(32, "little")
                 for v in itertools.chain.from_iterable(pl.variables for pl in placements)]
        n = len(parts)
        # the index rides behind the table (n * 32 bytes keeps it 8-aligned)
        parts.append(np.stack([order, starts[order]]).astype("<i8").tobytes())
        buf = bytearray().join(parts)
        timing.count("witness.vars_converted", n)
    with timing.sync("witness.upload"):
        raw = torch.from_numpy(np.frombuffer(buf, np.uint8)).to(device)
    limbs = raw[: n * 32].view(torch.int16).to(torch.int32) & 0xFFFF
    mont = F.fr_mul(limbs.reshape(n, F.FR_L).T.contiguous(), _R2)
    index = raw[n * 32:].view(torch.int64).reshape(2, len(placements))
    return WitnessTable(mont=mont, index=index, order=order, kinds=kinds, lengths=lengths)


def _interface_arrays(info: SubcircuitInfo, l: int, l_d: int, device) -> torch.Tensor:
    """[2, J] (local position, row = global wire - l) of one subcircuit's
    interface wires [l, l_D), cached on the info object per device."""
    cache = info.__dict__.setdefault("_interface_torch", {})
    key = (l, l_d, str(device))
    ent = cache.get(key)
    if ent is None:
        garr = np.asarray(info.flattenMap, np.int64)
        j = np.flatnonzero((garr >= l) & (garr < l_d))
        with timing.sync("witness.library"):
            ent = cache[key] = torch.as_tensor(np.stack([j, garr[j] - l]), device=device)
    return ent


def _b_grid(infos: list[SubcircuitInfo], params: SetupParams, table: WitnessTable):
    """[16, m_i, s_max] evaluations of b(X,Y): per kind, the interface wires'
    variables gathered from the table into (wire - l, placement)."""
    m_i, s_max, l, l_d = params.m_i, params.s_max, params.l, params.l_D
    grid = torch.zeros((F.FR_L, m_i, s_max), dtype=torch.int32, device=table.mont.device)
    for sid, sl in table.kinds.items():
        if np.any(table.lengths[table.order[sl]] != len(infos[sid].flattenMap)):
            raise ValueError("corrupted placement variables")
        local, rows = _interface_arrays(infos[sid], l, l_d, grid.device)
        if local.numel() == 0:
            continue
        cols, starts = table.index[0, sl, None], table.index[1, sl, None]
        grid[:, rows, cols] = table.mont[:, starts + local]
    return grid


def gen_bXY(infos: list[SubcircuitInfo], params: SetupParams, table: WitnessTable) -> BiPoly:
    """Interface-witness grid b(X,Y): rows = interface wires [l, l_D),
    columns = placements."""
    return BiPoly.from_rou_evals(_b_grid(infos, params, table))


def _qap_col_arrays(r1cs: SubcircuitR1CS, which: str, device):
    """Flattened sparse-column arrays (wire, constraint-row, Montgomery
    coeff) for one subcircuit on the device, and one more than its highest
    wire, cached on the R1CS object per device."""
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
        with timing.sync("witness.library"):
            wk = torch.as_tensor(np.asarray([W, Kc], np.int64).reshape(2, -1), device=device)
        ent = (
            wk[0],
            wk[1],
            F.tensor(_pack_mont_dedup(C), device) if C else None,
            max(W, default=-1) + 1,
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


def _qap_grid(library: list[SubcircuitR1CS], params: SetupParams, which: str,
              table: WitnessTable):
    """[16, n, s_max] evaluations of u/v/w(X,Y): per placement, the
    witness-weighted R1CS column combination on the n-domain.  Per
    subcircuit kind, the variables at the active wires are gathered from the
    table, multiplied by the packed column coefficients and their 16-bit
    limbs scatter-added into one grid of 32-bit word sums (limbs < 2^16 and
    constraint-row density << 2^16), reduced once."""
    n, s_max = params.n, params.s_max
    device = table.mont.device
    acc = torch.zeros((F.FR_L, n * s_max), dtype=torch.int64, device=device)
    for sid, sl in table.kinds.items():
        W, Kc, C_mont, top = _qap_col_arrays(library[sid], which, device)
        if C_mont is None:
            continue
        if top > table.lengths[table.order[sl]].min():
            raise ValueError("placement variables shorter than their subcircuit's wires")
        cols, starts = table.index[0, sl, None], table.index[1, sl, None]
        prod = F.fr_mul(table.mont[:, starts + W], C_mont)  # cyclic suffix broadcast
        flat = (Kc * s_max + cols).reshape(-1)
        acc.index_add_(1, flat, prod.reshape(F.FR_L, -1).to(torch.int64))
    return _reduce_u32_grid(acc & 0xFFFFFFFF).reshape(F.FR_L, n, s_max)


def gen_uXY(library: list[SubcircuitR1CS], params: SetupParams, table: WitnessTable) -> BiPoly:
    return BiPoly.from_rou_evals(_qap_grid(library, params, "A", table))


def gen_vXY(library: list[SubcircuitR1CS], params: SetupParams, table: WitnessTable) -> BiPoly:
    return BiPoly.from_rou_evals(_qap_grid(library, params, "B", table))


def gen_wXY(library: list[SubcircuitR1CS], params: SetupParams, table: WitnessTable) -> BiPoly:
    return BiPoly.from_rou_evals(_qap_grid(library, params, "C", table))


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

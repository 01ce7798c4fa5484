"""Trusted setup (fixed- or random-tau) -- CRS generation.

Port of the JAX package's `models/setup.py` (the reference `trusted-setup`
binary and `Sigma::gen`).  The CRS families that feed device MSMs
(xy_powers, gamma_inv_o_inst, eta_inv_li_o_inter_alpha4_kj,
delta_inv_li_o_prv) are device tensors (px, py, pinf); the handful of
standalone points stay host-side.  Families of up to 4096 points are exact
host scalar-muls; larger ones run the device fixed-base kernel (K4), with
their scalars formed on the device as outer products of two host vectors
(one Montgomery product each, K1) instead of millions of host big-int ops.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields import R_MOD, fr_root_of_unity
from ..host import curve as C
from ..ops import field as F
from ..ops import msm as msm_mod
from ..utils import timing
from ..utils.device import resolve_device
from .protocol import SetupParams, SubcircuitInfo, SubcircuitR1CS


@dataclass
class Tau:
    x: int
    y: int
    alpha: int
    gamma: int
    delta: int
    eta: int

    @staticmethod
    def fixed() -> "Tau":
        from ..fields import TAU_FIXED

        return Tau(**TAU_FIXED)

    @staticmethod
    def random(rng) -> "Tau":
        def r():
            return int.from_bytes(rng.bytes(32), "little") % R_MOD

        return Tau(x=r(), y=r(), alpha=r(), gamma=r(), delta=r(), eta=r())


@dataclass
class Sigma1:
    # device point families: (px, py, pinf) tensors
    xy_powers: object  # flattened [h_max * 2*s_max] grid, idx = h*(2 s_max)+i
    h_max: int
    rs_y: int
    gamma_inv_o_inst: object  # [l]
    eta_inv_li_o_inter_alpha4_kj: object  # [m_i * s_max], idx = j*s_max + i
    delta_inv_li_o_prv: object  # [m_prv * s_max]
    # host points
    x: object
    y: object
    delta: object
    eta: object
    delta_inv_alphak_xh_tx: list  # [3][3]
    delta_inv_alpha4_xj_tx: list  # [2]
    delta_inv_alphak_yi_ty: list  # [4][3]


@dataclass
class Sigma2:
    alpha: object
    alpha2: object
    alpha3: object
    alpha4: object
    gamma: object
    delta: object
    eta: object
    x: object
    y: object


@dataclass
class Sigma:
    G: object
    H: object
    sigma_1: Sigma1
    sigma_2: Sigma2
    lagrange_KL: object


def gen_evaled_lagrange_bases(val: int, size: int) -> list[int]:
    """All Lagrange basis polys over the size-point rou domain, evaluated at
    `val` (closed form)."""
    omega = fr_root_of_unity(size)
    pows = [pow(omega, i, R_MOD) for i in range(size)]
    vn = pow(val, size, R_MOD)
    if vn == 1:
        return [1 if (val - w) % R_MOD == 0 else 0 for w in pows]
    n_inv = pow(size, -1, R_MOD)
    scale = ((vn - 1) * n_inv) % R_MOD
    return [(scale * w * pow((val - w) % R_MOD, -1, R_MOD)) % R_MOD for w in pows]


def evaled_qap_mixture(r1cs: SubcircuitR1CS, info: SubcircuitInfo, tau: Tau,
                       x_lagrange: list[int]) -> list[int]:
    """o_j = alpha*u_j(tau.x) + alpha^2*v_j(tau.x) + alpha^3*w_j(tau.x)."""
    a2 = (tau.alpha * tau.alpha) % R_MOD
    a3 = (a2 * tau.alpha) % R_MOD
    out = [0] * info.Nwires
    for coeff_map, mult in ((r1cs.A_cols, tau.alpha), (r1cs.B_cols, a2), (r1cs.C_cols, a3)):
        for wire, col in coeff_map.items():
            acc = 0
            for k, c in col:
                acc += c * x_lagrange[k]
            out[wire] = (out[wire] + mult * acc) % R_MOD
    return out


def compute_o_vec(library, infos, params: SetupParams, tau: Tau) -> list[int]:
    x_lagrange = gen_evaled_lagrange_bases(tau.x, params.n)
    o_vec = [0] * params.m_D
    for r1cs, info in zip(library, infos):
        o_local = evaled_qap_mixture(r1cs, info, tau, x_lagrange)
        for local_idx, g in enumerate(info.flattenMap):
            if o_local[local_idx]:
                o_vec[g] = o_local[local_idx]
    return o_vec


_DEVICE_THRESHOLD = 4096


def _host_family(scalars, g1_gen, device):
    """Exact host fixed-base muls (small families)."""
    from ..ops import curve as cv

    pts = [C.g1_scalar_mul_affine(g1_gen, s % R_MOD) if s % R_MOD else None
           for s in scalars]
    return cv.pack_affine(pts, device)


def _outer_family(col, row, g1_gen, device):
    """The family with scalar col[j] * row[i] at index j*len(row) + i."""
    if len(col) * len(row) <= _DEVICE_THRESHOLD:
        return _host_family([c * r for c in col for r in row], g1_gen, device)
    with timing.span("setup.pack", "setup", n=len(col) + len(row)):
        a = F.tensor(F.pack_fr(col), device)  # [16, J]
        b = F.tensor(F.pack_fr(row), device)  # [16, I]
    grid = F.fr_mul(a[:, :, None].expand(F.FR_L, len(col), len(row)).contiguous(), b)
    scalars = msm_mod.scalars_from_mont(grid.reshape(F.FR_L, -1))
    return msm_mod.fixed_base_msm_points(scalars, g1_gen, device)


def _family(scalars, g1_gen, device):
    if len(scalars) <= _DEVICE_THRESHOLD:
        return _host_family(scalars, g1_gen, device)
    return msm_mod.fixed_base_msm_points(scalars, g1_gen, device)


def generate_sigma(params: SetupParams, tau: Tau, library: list[SubcircuitR1CS],
                   infos: list[SubcircuitInfo], g1_gen=None, g2_gen=None,
                   device=None) -> Sigma:
    """The CRS for `params`; device families live on `device` (default cuda)."""
    device = resolve_device(device)
    params.validate()
    g1_gen = g1_gen or C.G1.gen
    g2_gen = g2_gen or C.G2.gen
    n, s_max, l, l_free = params.n, params.s_max, params.l, params.l_free
    l_user, l_user_out = params.l_user, params.l_user_out
    m_i, m_d = params.m_i, params.m_D
    m_block = l_free - l_user
    m_function = l - l_free

    with timing.span("setup.host_scalars", "setup"):
        o_vec = compute_o_vec(library, infos, params, tau)
        k_vec = gen_evaled_lagrange_bases(tau.x, m_i)
        l_vec = gen_evaled_lagrange_bases(tau.y, s_max)
        m_vec = gen_evaled_lagrange_bases(tau.x, l_free)

    h_max = max(2 * n, 2 * m_i)
    rs_y = 2 * s_max

    def powers(x, k):
        out, acc = [], 1
        for _ in range(k):
            out.append(acc)
            acc = acc * x % R_MOD
        return out

    # xy_powers[h*rs_y + i] = x^h y^i * G
    xy_powers = _outer_family(powers(tau.x, h_max), powers(tau.y, rs_y), g1_gen, device)

    # gamma_inv_o_inst
    user_vec = (
        [l_vec[0]] * l_user_out
        + [l_vec[1]] * (l_user - l_user_out)
        + [l_vec[2]] * m_block
        + [l_vec[3]] * m_function
    )
    if len(user_vec) != l:
        raise ValueError("inconsistent public-wire layout in params")
    gamma_inv = pow(tau.gamma, -1, R_MOD)
    gi_scalars = []
    for j in range(l):
        v = (user_vec[j] * o_vec[j]) % R_MOD
        if j < l_free:
            v = (v + m_vec[j]) % R_MOD
        gi_scalars.append((v * gamma_inv) % R_MOD)
    gamma_inv_o_inst = _family(gi_scalars, g1_gen, device)

    # eta^{-1} L_i(y) (o_{l+j} + alpha^4 K_j(x)), idx = j*s_max + i
    eta_inv = pow(tau.eta, -1, R_MOD)
    a4 = pow(tau.alpha, 4, R_MOD)
    inter_col = [eta_inv * ((o_vec[l + j] + a4 * k_vec[j]) % R_MOD) % R_MOD
                 for j in range(m_i)]
    eta_inv_li_o_inter = _outer_family(inter_col, l_vec, g1_gen, device)

    # delta^{-1} L_i(y) o_j(x) for private wires, idx = j*s_max + i
    delta_inv = pow(tau.delta, -1, R_MOD)
    prv_col = [delta_inv * o_vec[params.l_D + j] % R_MOD for j in range(m_d - params.l_D)]
    delta_inv_li_o_prv = _outer_family(prv_col, l_vec, g1_gen, device)

    # zk vanishing families (host points)
    t_x = (pow(tau.x, n, R_MOD) - 1) % R_MOD
    dxh = [
        [
            C.g1_scalar_mul_affine(
                g1_gen,
                (delta_inv * pow(tau.alpha, k, R_MOD) * pow(tau.x, h, R_MOD) * t_x) % R_MOD,
            )
            for h in range(3)
        ]
        for k in range(1, 4)
    ]
    t_mi_x = (pow(tau.x, m_i, R_MOD) - 1) % R_MOD
    dx4 = [
        C.g1_scalar_mul_affine(g1_gen, (delta_inv * a4 * pow(tau.x, j, R_MOD) * t_mi_x) % R_MOD)
        for j in range(2)
    ]
    t_y = (pow(tau.y, s_max, R_MOD) - 1) % R_MOD
    dyi = [
        [
            C.g1_scalar_mul_affine(
                g1_gen,
                (delta_inv * pow(tau.alpha, k, R_MOD) * pow(tau.y, i, R_MOD) * t_y) % R_MOD,
            )
            for i in range(3)
        ]
        for k in range(1, 5)
    ]

    sigma1 = Sigma1(
        xy_powers=xy_powers,
        h_max=h_max,
        rs_y=rs_y,
        gamma_inv_o_inst=gamma_inv_o_inst,
        eta_inv_li_o_inter_alpha4_kj=eta_inv_li_o_inter,
        delta_inv_li_o_prv=delta_inv_li_o_prv,
        x=C.g1_scalar_mul_affine(g1_gen, tau.x),
        y=C.g1_scalar_mul_affine(g1_gen, tau.y),
        delta=C.g1_scalar_mul_affine(g1_gen, tau.delta),
        eta=C.g1_scalar_mul_affine(g1_gen, tau.eta),
        delta_inv_alphak_xh_tx=dxh,
        delta_inv_alpha4_xj_tx=dx4,
        delta_inv_alphak_yi_ty=dyi,
    )

    sigma2 = Sigma2(
        alpha=C.g2_scalar_mul_affine(g2_gen, tau.alpha),
        alpha2=C.g2_scalar_mul_affine(g2_gen, pow(tau.alpha, 2, R_MOD)),
        alpha3=C.g2_scalar_mul_affine(g2_gen, pow(tau.alpha, 3, R_MOD)),
        alpha4=C.g2_scalar_mul_affine(g2_gen, a4),
        gamma=C.g2_scalar_mul_affine(g2_gen, tau.gamma),
        delta=C.g2_scalar_mul_affine(g2_gen, tau.delta),
        eta=C.g2_scalar_mul_affine(g2_gen, tau.eta),
        x=C.g2_scalar_mul_affine(g2_gen, tau.x),
        y=C.g2_scalar_mul_affine(g2_gen, tau.y),
    )

    lagrange_KL = C.g1_scalar_mul_affine(g1_gen, (l_vec[s_max - 1] * k_vec[m_i - 1]) % R_MOD)

    return Sigma(G=g1_gen, H=g2_gen, sigma_1=sigma1, sigma_2=sigma2, lagrange_KL=lagrange_KL)

"""The Tokamak zk-SNARK prover: rounds 0-4 on the port's device stack.

Port of the JAX package's prover (the reference `prove/src/lib.rs` round
semantics) onto torch tensors and the hand-written kernels:

  prove0  — arithmetic constraints: p0 = u*v - w, vanishing division,
            blinded commitments U,V,W,Q_AX,Q_AY,B          (lib.rs:1446-1782)
  prove1  — copy-constraint grand product r(X,Y) via suffix-product scan,
            commitment R                                   (lib.rs:1784-1956)
  prove2  — 9-term combined numerator on the (4*m_i, 2*s_max) eval domain,
            vanishing division, blinded Q_CX,Q_CY          (lib.rs:1958-2270)
  prove3  — four openings V, R, R(w^-1 X), R(w^-1 X, w^-1 Y) (lib.rs:2272-2354)
  prove4  — opening-proof quotients via Ruffini division; Pi/M/N commitments
            (lib.rs:2356-3206)

All polynomial state stays resident on the device between rounds.  The
JAX package's TPU-only switches (the 16 GB HBM splits, the binding-family
release to host numpy) are not carried over.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import R_MOD, fr_root_of_unity
from ..ops import field as F
from ..ops import msm as msm_mod
from ..ops import poly as P
from ..ops.poly import BiPoly
from . import witness as W
from .protocol import (
    Binding, Instance, Mixer, Placement, PermutationEntry, Proof, Proof0,
    Proof1, Proof2, Proof3, Proof4, Proof4Test, SetupParams, SubcircuitInfo,
    SubcircuitR1CS,
)
from .setup import Sigma
from .transcript import TranscriptManager
from ..utils import timing
from ..utils.device import resolve_device


# ---------------------------------------------------------------------------
# Commitment: encode_poly == MSM of coefficients against xy_powers
# (`libs/src/group_structures/mod.rs:59-119`)
# ---------------------------------------------------------------------------


def encode_poly_start(sigma: Sigma, poly: BiPoly, params: SetupParams):
    """Dispatch a commitment MSM without blocking (None for zero polys);
    pair with `msm_mod.msm_finish`.  Rounds enqueue every commitment first
    and finish them together — one host sync per round."""
    p = poly.optimized()
    if p.x_degree < 0 or p.y_degree < 0:
        return None
    tx, ty = p.x_degree + 1, p.y_degree + 1
    rs_x = max(2 * params.n, 2 * params.m_i)
    rs_y = 2 * params.s_max
    if tx > rs_x or ty > rs_y:
        raise ValueError("Insufficient length of sigma.sigma_1.xy_powers")
    with timing.span("encode_poly", "encode", tx=tx, ty=ty):
        coeffs = p.coeffs[:, :tx, :ty]
        scalars = msm_mod.scalars_from_mont(coeffs.reshape(F.FR_L, -1))
        s1 = sigma.sigma_1
        px, py, pinf = s1.xy_powers
        # xy_powers is the x-major [h_max, rs_y] monomial grid flattened, so
        # the degree-sliced point view is a 2-D slice of the CRS
        LQ = px.shape[0]
        gx = px.reshape(LQ, s1.h_max, s1.rs_y)[:, :tx, :ty].reshape(LQ, -1).contiguous()
        gy = py.reshape(LQ, s1.h_max, s1.rs_y)[:, :tx, :ty].reshape(LQ, -1).contiguous()
        gi = pinf.reshape(s1.h_max, s1.rs_y)[:tx, :ty].reshape(-1).contiguous()
        return msm_mod.msm_start(scalars, gx, gy, gi)


def encode_poly(sigma: Sigma, poly: BiPoly, params: SetupParams):
    h = encode_poly_start(sigma, poly, params)
    return None if h is None else msm_mod.msm_finish(h)


def _indexed_msm(points_family, scalars_ints, indices):
    """MSM of host scalars against gathered rows of a device point family."""
    if not scalars_ints:
        return None
    px, py, pinf = points_family
    s = msm_mod.scalars_from_ints(scalars_ints, px.device)
    idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=px.device)
    return msm_mod.msm(s, px[:, idx].contiguous(), py[:, idx].contiguous(),
                       pinf[idx].contiguous())


# ---------------------------------------------------------------------------
# Binding MSMs over placement variables (`group_structures/mod.rs:184-300`)
# ---------------------------------------------------------------------------

_PUB_BUFFERS_OUT = ("bufferPubOut",)
_PUB_BUFFERS_IN = ("bufferPubIn", "bufferBlockIn")


def encode_O_pub_free(sigma, placements, infos, params):
    scalars, idxs = [], []
    for pl in placements:
        info = infos[pl.subcircuit_id]
        if info.name == "bufferEVMIn":
            continue
        if info.name in _PUB_BUFFERS_OUT:
            start, cnt = info.Out_idx
        elif info.name in _PUB_BUFFERS_IN:
            start, cnt = info.In_idx
        else:
            continue
        for j in range(start, start + cnt):
            v = pl.variables[j]
            if v:
                scalars.append(v % R_MOD)
                idxs.append(info.flattenMap[j])
    return _indexed_msm(sigma.sigma_1.gamma_inv_o_inst, scalars, idxs)


_STMT_WIRES_CACHE: dict = {}


def _stmt_wires(info, lo, hi):
    """Per-subcircuit (local wire indices, target rows) for flattenMap
    entries in [lo, hi) — structure only, cached per (subcircuit, region)."""
    key = (id(info), lo, hi)
    hit = _STMT_WIRES_CACHE.get(key)
    if hit is None:
        fm = np.asarray(info.flattenMap, dtype=np.int64)
        sel = np.nonzero((fm >= lo) & (fm < hi))[0]
        hit = _STMT_WIRES_CACHE[key] = (info, sel, fm[sel] - lo)
    return hit[1], hit[2]


def _encode_statement(points_family, lo, hi, offset_cols, placements, infos, s_max):
    """Zero scalars are dropped before packing: an MSM term with k=0
    contributes nothing, and buffer placements are mostly zero-padded."""
    scalars, idxs = [], []
    for i, pl in enumerate(placements):
        info = infos[pl.subcircuit_id]
        sel, rows = _stmt_wires(info, lo, hi)
        var = pl.variables
        for j, g in zip(sel.tolist(), rows.tolist()):
            v = var[j]
            if v:
                scalars.append(v % R_MOD)
                idxs.append(g * s_max + i)
    return _indexed_msm(points_family, scalars, idxs)


def encode_O_mid_no_zk(sigma, placements, infos, params):
    return _encode_statement(
        sigma.sigma_1.eta_inv_li_o_inter_alpha4_kj, params.l, params.l_D,
        None, placements, infos, params.s_max,
    )


def encode_O_prv_no_zk(sigma, placements, infos, params):
    return _encode_statement(
        sigma.sigma_1.delta_inv_li_o_prv, params.l_D, params.m_D,
        None, placements, infos, params.s_max,
    )


def encode_O_pub_fix(sigma, a_pub_function, params):
    """MSM of the fixed public-function instance against the tail of
    gamma_inv_o_inst (`group_structures/mod.rs:145-182`)."""
    m_function = params.l - params.l_free
    if m_function == 0:
        return None
    assert len(a_pub_function) == m_function
    start = params.l - m_function
    return _indexed_msm(
        sigma.sigma_1.gamma_inv_o_inst,
        [v % R_MOD for v in a_pub_function],
        list(range(start, params.l)),
    )


# ---------------------------------------------------------------------------


def _g1_add(a, b):
    from ..host.curve import G1

    return G1.to_affine(G1.add(G1.from_affine(a), G1.from_affine(b)))


def _g1_sub(a, b):
    from ..host.curve import G1

    return G1.to_affine(G1.add(G1.from_affine(a), G1.neg(G1.from_affine(b))))


def _g1_mul(a, k):
    from ..host.curve import G1

    return G1.to_affine(G1.scalar_mul(G1.from_affine(a), k % R_MOD))


def _g1_lincomb(*terms):
    """Sum of (point, scalar) host terms."""
    from ..host.curve import G1

    acc = G1.infinity
    for p, k in terms:
        acc = G1.add(acc, G1.scalar_mul(G1.from_affine(p), k % R_MOD))
    return G1.to_affine(acc)


class Prover:
    def __init__(
        self,
        params: SetupParams,
        sigma: Sigma,
        library: list[SubcircuitR1CS],
        infos: list[SubcircuitInfo],
        placements: list[Placement],
        permutation: list[PermutationEntry],
        instance: Instance,
        mixer: Mixer | None = None,
        rng=None,
        testing_mode: bool = False,
        device=None,
    ):
        import os as _os

        self.device = dev = resolve_device(device)
        self.testing_mode = testing_mode or _os.environ.get("TZK_TESTING_MODE") == "1"
        self._test_rng = np.random.default_rng(0x7E57)
        params.validate()
        self.params = params
        self.sigma = sigma
        self.placements = placements
        self.infos = infos
        n, s_max, m_i = params.n, params.s_max, params.m_i

        with timing.span("init.witness", "build", n=n, s_max=s_max, m_i=m_i):
            # witness polynomials (init phase, lib.rs:736-775)
            self.bXY = W.gen_bXY(placements, infos, params, dev)
            self.uXY = W.gen_uXY(placements, library, params, dev)
            self.vXY = W.gen_vXY(placements, library, params, dev)
            self.wXY = W.gen_wXY(placements, library, params, dev)
            self.rXY = None

            # instance polynomials (lib.rs:822-914)
            self.a_free_X = W.gen_a_free_X(instance, params, dev)
            self.t_n = W.vanishing_poly_x(n, dev)
            self.t_mi = W.vanishing_poly_x(m_i, dev)
            self.t_smax = W.vanishing_poly_y(s_max, dev)
            self.s0XY, self.s1XY = W.permutation_to_polys(permutation, m_i, s_max, dev)

        if mixer is None:
            mixer = Mixer.random(rng) if rng is not None else Mixer.zero()
        self.mixer = mixer

        self.q0 = self.q1 = self.q2 = self.q3 = None
        self._w_zk = None
        self._term_b_zk = None
        self._lagrange_kl = None

        with timing.span("init.binding", "build"):
            self.binding = self._compute_binding()


    # -- binding (lib.rs:1083-1167) ------------------------------------
    def _compute_binding(self) -> Binding:
        from ..host.curve import G1

        sp, sigma, mix = self.params, self.sigma, self.mixer
        A_free = encode_poly(sigma, self.a_free_X, sp)
        O_pub_free = encode_O_pub_free(sigma, self.placements, self.infos, sp)
        O_mid_core = encode_O_mid_no_zk(sigma, self.placements, self.infos, sp)
        O_prv_core = encode_O_prv_no_zk(sigma, self.placements, self.infos, sp)

        s1 = sigma.sigma_1
        O_mid = _g1_add(O_mid_core, _g1_mul(s1.delta, mix.rO_mid))
        zk_terms = [
            (s1.eta, (-mix.rO_mid) % R_MOD),
            (s1.delta_inv_alphak_xh_tx[0][0], mix.rU_X),
            (s1.delta_inv_alphak_xh_tx[1][0], mix.rV_X),
            (s1.delta_inv_alphak_xh_tx[2][0], mix.rW_X[0]),
            (s1.delta_inv_alphak_xh_tx[2][1], mix.rW_X[1]),
            (s1.delta_inv_alphak_xh_tx[2][2], mix.rW_X[2]),
            (s1.delta_inv_alpha4_xj_tx[0], mix.rB_X[0]),
            (s1.delta_inv_alpha4_xj_tx[1], mix.rB_X[1]),
            (s1.delta_inv_alphak_yi_ty[0][0], mix.rU_Y),
            (s1.delta_inv_alphak_yi_ty[1][0], mix.rV_Y),
            (s1.delta_inv_alphak_yi_ty[2][0], mix.rW_Y[0]),
            (s1.delta_inv_alphak_yi_ty[2][1], mix.rW_Y[1]),
            (s1.delta_inv_alphak_yi_ty[2][2], mix.rW_Y[2]),
            (s1.delta_inv_alphak_yi_ty[3][0], mix.rB_Y[0]),
            (s1.delta_inv_alphak_yi_ty[3][1], mix.rB_Y[1]),
        ]
        O_prv = G1.from_affine(O_prv_core)
        for p, k in zk_terms:
            O_prv = G1.add(O_prv, G1.scalar_mul(G1.from_affine(p), k % R_MOD))
        return Binding(
            A_free=A_free, O_pub_free=O_pub_free, O_mid=O_mid,
            O_prv=G1.to_affine(O_prv),
        )

    def _encode(self, poly: BiPoly):
        return encode_poly(self.sigma, poly, self.params)

    def _encode_many(self, *polys):
        """Commit several polynomials with ONE host sync: dispatch all the
        MSMs, then finish them in order."""
        handles = [encode_poly_start(self.sigma, p, self.params)
                   for p in polys]
        return [None if h is None else msm_mod.msm_finish(h)
                for h in handles]

    # -- in-round testing-mode checks (reference `--features testing-mode`,
    # prove/src/lib.rs:1473-1546, 1864-1920, 2591-2606) ------------------
    def _test_point(self) -> tuple[int, int]:
        r = self._test_rng
        return (
            int.from_bytes(r.bytes(32), "little") % R_MOD,
            int.from_bytes(r.bytes(32), "little") % R_MOD,
        )

    def _check_r1cs_evals(self):
        """u*v == w on the (n, s_max) rou grid (lib.rs:1473-1518)."""
        import sys

        ue = self.uXY.to_rou_evals()
        ve = self.vXY.to_rou_evals()
        we = self.wXY.to_rou_evals()
        bad = (F.fr_mul(ue, ve) != we).any(0).any(0).cpu().numpy()
        # per-column (placement) flags
        if bad.any():
            cols = np.nonzero(bad)[0].tolist()
            raise AssertionError(
                f"testing-mode: placements {cols} do not satisfy R1CS"
            )
        print("Checked: Evaluations of u(X,Y), v(X,Y), and w(X,Y) satisfy "
              "R1CS.", file=sys.stderr)

    def _check_vanishing_division(self, p, qx, qy, c, d, tag):
        """p(e) == qx(e)*(xe^c - 1) + qy(e)*(ye^d - 1) at a random point
        (lib.rs:1533-1546)."""
        import sys

        xe, ye = self._test_point()
        lhs = p.eval(xe, ye)
        rhs = (
            qx.eval(xe, ye) * ((pow(xe, c, R_MOD) - 1) % R_MOD)
            + qy.eval(xe, ye) * ((pow(ye, d, R_MOD) - 1) % R_MOD)
        ) % R_MOD
        if lhs != rhs:
            raise AssertionError(f"testing-mode: {tag} vanishing-division identity fails")
        print(f"Checked: {tag} satisfies the vanishing-division identity.",
              file=sys.stderr)

    def _check_grand_product(self, r_flat, f_t, g_t):
        """r_t[i] * f_t[i+1] == r_t[i+1] * g_t[i+1] over the transposed
        (placement-major) order, plus r_t[last] == 1 (lib.rs:1864-1920)."""
        import sys

        lhs = F.fr_mul(r_flat[:, :-1], f_t[:, 1:])
        rhs = F.fr_mul(r_flat[:, 1:], g_t[:, 1:])
        ok1 = bool((lhs == rhs).all())
        one = F.tensor(F.fr_mont(1), r_flat.device)
        ok2 = bool((r_flat[:, -1:] == one).all())
        if not (ok1 and ok2):
            raise AssertionError("testing-mode: grand product r(X,Y) malformed")
        print("Checked: r(X,Y) is well constructed.", file=sys.stderr)

    def _check_ruffini(self, num, qx, qy, rem, a, b, tag):
        """num(e) == qx(e)*(xe - a) + qy(e)*(ye - b) + rem, rem == 0
        (lib.rs:2591-2606)."""
        import sys

        if not isinstance(rem, int):  # lazy device remainder -> host int
            rem = int(F.unpack_fr(rem.reshape(F.FR_L, 1))[0])
        if rem % R_MOD != 0:
            raise AssertionError(f"testing-mode: {tag} ruffini remainder != 0")
        xe, ye = self._test_point()
        lhs = num.eval(xe, ye)
        rhs = (
            qx.eval(xe, ye) * ((xe - a) % R_MOD)
            + qy.eval(xe, ye) * ((ye - b) % R_MOD)
        ) % R_MOD
        if lhs != rhs:
            raise AssertionError(f"testing-mode: {tag} ruffini identity fails")
        print(f"Checked: {tag} satisfies the Ruffini identity.", file=sys.stderr)

    # -- round 0 (lib.rs:1446-1782) ------------------------------------
    def prove0(self) -> Proof0:
        sp, mix = self.params, self.mixer
        n, s_max = sp.n, sp.s_max
        if self.testing_mode:
            self._check_r1cs_evals()
        p0 = self.uXY * self.vXY - self.wXY
        self.q0, self.q1 = p0.div_by_vanishing_opt(n, s_max)
        if self.testing_mode:
            self._check_vanishing_division(p0, self.q0, self.q1, n, s_max, "p0")

        rW_X = BiPoly.from_ints([[c % R_MOD] for c in mix.rW_X], self.device)
        rW_Y = BiPoly.from_ints([[c % R_MOD for c in mix.rW_Y]], self.device)

        UXY = self.uXY + self.t_n.mul_scalar(mix.rU_X) + self.t_smax.mul_scalar(mix.rU_Y)
        VXY = self.vXY + self.t_n.mul_scalar(mix.rV_X) + self.t_smax.mul_scalar(mix.rV_Y)
        self._w_zk = P.low_degree_x_times_vanishing(mix.rW_X, n, self.device) + \
            P.low_degree_y_times_vanishing(mix.rW_Y, s_max, self.device)
        WXY = self.wXY + self._w_zk

        Q_AX = (
            self.q0
            + self.vXY.mul_scalar(mix.rU_X)
            + self.uXY.mul_scalar(mix.rV_X)
            - rW_X
            + self.t_n.mul_scalar(mix.rU_X * mix.rV_X)
            + self.t_smax.mul_scalar(mix.rU_Y * mix.rV_X)
        )
        Q_AY = (
            self.q1
            + self.vXY.mul_scalar(mix.rU_Y)
            + self.uXY.mul_scalar(mix.rV_Y)
            - rW_Y
            + self.t_n.mul_scalar(mix.rU_X * mix.rV_Y)
            + self.t_smax.mul_scalar(mix.rU_Y * mix.rV_Y)
        )
        self._term_b_zk = P.low_degree_x_times_vanishing(mix.rB_X, sp.m_i, self.device) + \
            P.low_degree_y_times_vanishing(mix.rB_Y, s_max, self.device)
        BXY = self.bXY + self._term_b_zk

        U, V, W, QAX, QAY, Bc = self._encode_many(
            UXY, VXY, WXY, Q_AX, Q_AY, BXY)
        return Proof0(U=U, V=V, W=W, Q_AX=QAX, Q_AY=QAY, B=Bc)

    # -- f, g (lib.rs:1807-1811) ---------------------------------------
    def _f_g(self, thetas):
        f = (
            self.bXY
            + self.s0XY.mul_scalar(thetas[0])
            + self.s1XY.mul_scalar(thetas[1])
            + thetas[2]
        )
        g = (
            self.bXY
            + P.x_monomial(self.device).mul_scalar(thetas[0])
            + P.y_monomial(self.device).mul_scalar(thetas[1])
            + thetas[2]
        )
        return f, g

    # -- round 1 (lib.rs:1784-1956) ------------------------------------
    def prove1(self, thetas) -> Proof1:
        sp, mix = self.params, self.mixer
        m_i, s_max = sp.m_i, sp.s_max
        f, g = self._f_g(thetas)
        f_evals = f.to_rou_evals()  # [16, m_i, s_max]
        g_evals = g.to_rou_evals()

        # scalers = g/f pointwise; suffix-product recurrence over the
        # transposed (placement-major) order (lib.rs:1856-1868)
        L = F.FR_L
        flat_f = f_evals.reshape(L, -1)
        flat_g = g_evals.reshape(L, -1)
        scalers = F.fr_mul(flat_g, F.fr_batch_inv(flat_f))
        st = scalers.reshape(L, m_i, s_max).permute(0, 2, 1).reshape(L, -1)
        suffix = F.fr_suffix_prod(st)
        one = F.tensor(F.fr_mont(1), suffix.device)
        r_flat = torch.cat([suffix[:, 1:], one], dim=1)
        if self.testing_mode:
            ft = flat_f.reshape(L, m_i, s_max).permute(0, 2, 1).reshape(L, -1)
            gt = flat_g.reshape(L, m_i, s_max).permute(0, 2, 1).reshape(L, -1)
            self._check_grand_product(r_flat, ft, gt)
        r_grid = r_flat.reshape(L, s_max, m_i).permute(0, 2, 1).contiguous()
        self.rXY = BiPoly.from_rou_evals(r_grid)

        RXY = self.rXY + self.t_mi.mul_scalar(mix.rR_X) + self.t_smax.mul_scalar(mix.rR_Y)
        return Proof1(R=self._encode(RXY))

    # -- round 2 (lib.rs:1958-2270) ------------------------------------
    def prove2(self, thetas, kappa0) -> Proof2:
        sp, mix = self.params, self.mixer
        m_i, s_max = sp.m_i, sp.s_max
        kappa0_sq = (kappa0 * kappa0) % R_MOD
        w_mi = fr_root_of_unity(m_i)
        w_smax = fr_root_of_unity(s_max)
        w_mi_inv = pow(w_mi, -1, R_MOD)
        w_smax_inv = pow(w_smax, -1, R_MOD)

        r_omegaX = self.rXY.scale_coeffs_x(w_mi_inv)
        r_omegaX_omegaY = r_omegaX.scale_coeffs_y(w_smax_inv)
        f, g = self._f_g(thetas)

        lagrange_KL = W.lagrange_kl_xy(m_i, s_max, self.device)
        lagrange_K0 = W.lagrange_k0_xy(m_i, self.device)
        self._lagrange_kl = lagrange_KL

        # fused evaluation of the combined numerator on (4*m_i, 2*s_max)
        dx, dy = 4 * m_i, 2 * s_max

        def ev(poly):
            return poly.resized(dx, dy).to_rou_evals()

        e_r = ev(self.rXY)
        e_g = ev(g)
        e_f = ev(f)
        e_rox = ev(r_omegaX)
        e_roxy = ev(r_omegaX_omegaY)
        e_kl = ev(lagrange_KL)
        e_k0 = ev(lagrange_K0)
        one = F.tensor(F.fr_mont(1)[:, 0], self.device)
        # (X - 1) on the eval domain: [16, dx], prefix-broadcast over Y
        x_m1 = F.fr_sub(F.tensor(F.fr_powers(fr_root_of_unity(dx), dx), self.device), one)
        r_g = F.fr_mul(e_r, e_g)
        p1 = F.fr_mul(F.fr_sub(e_r, one), e_kl)
        p2 = F.fr_mul(F.fr_sub(r_g, F.fr_mul(e_rox, e_f)), x_m1)
        p3 = F.fr_mul(e_k0, F.fr_sub(r_g, F.fr_mul(e_roxy, e_f)))
        comb = F.fr_add(
            p1,
            F.fr_add(
                F.fr_mul(p2, F.fr_mont(kappa0)[:, 0]),
                F.fr_mul(p3, F.fr_mont(kappa0_sq)[:, 0]),
            ),
        )
        p_comb = BiPoly.from_rou_evals(comb)
        # the (4m_i, 2s_max) eval grids are ~537 MB each at the full shape;
        # drop them before the division's working set
        del e_r, e_g, e_f, e_rox, e_roxy, e_kl, e_k0, r_g, p1, p2, p3, comb
        self.q2, self.q3 = p_comb.div_by_vanishing_opt(m_i, s_max)
        if self.testing_mode:
            self._check_vanishing_division(
                p_comb, self.q2, self.q3, m_i, s_max, "p_comb"
            )
        del p_comb

        r_D1 = self.rXY - r_omegaX
        r_D2 = self.rXY - r_omegaX_omegaY
        g_D = g - f
        del f, g, r_omegaX, r_omegaX_omegaY

        def mul_by_linear_x(p, coeffs):
            return p.mul_scalar(coeffs[0]) + p.mul_monomial(1, 0).mul_scalar(coeffs[1])

        def mul_by_linear_y(p, coeffs):
            return p.mul_scalar(coeffs[0]) + p.mul_monomial(0, 1).mul_scalar(coeffs[1])

        def mul_x_minus_one(p):
            return p.mul_monomial(1, 0) - p

        # Q_CX (lib.rs:2181-2223)
        d1x = mul_by_linear_x(r_D1, mix.rB_X) + g_D.mul_scalar(mix.rR_X)
        d2x = mul_by_linear_x(r_D2, mix.rB_X) + g_D.mul_scalar(mix.rR_X)
        Q_CX_XY = (
            self.q2
            + lagrange_KL.mul_scalar(mix.rR_X)
            + mul_x_minus_one(d1x).mul_scalar(kappa0)
            + (lagrange_K0 * d2x).mul_scalar(kappa0_sq)
        )
        del d1x, d2x
        # Q_CY (lib.rs:2225-2267)
        d1y = mul_by_linear_y(r_D1, mix.rB_Y) + g_D.mul_scalar(mix.rR_Y)
        d2y = mul_by_linear_y(r_D2, mix.rB_Y) + g_D.mul_scalar(mix.rR_Y)
        Q_CY_XY = (
            self.q3
            + lagrange_KL.mul_scalar(mix.rR_Y)
            + mul_x_minus_one(d1y).mul_scalar(kappa0)
            + (lagrange_K0 * d2y).mul_scalar(kappa0_sq)
        )
        Q_CX, Q_CY = self._encode_many(Q_CX_XY, Q_CY_XY)
        return Proof2(Q_CX=Q_CX, Q_CY=Q_CY)

    # -- round 3 (lib.rs:2272-2354) ------------------------------------
    def prove3(self, chi, zeta) -> Proof3:
        sp, mix = self.params, self.mixer
        VXY = self.vXY + self.t_n.mul_scalar(mix.rV_X) + self.t_smax.mul_scalar(mix.rV_Y)
        RXY = self.rXY + self.t_mi.mul_scalar(mix.rR_X) + self.t_smax.mul_scalar(mix.rR_Y)
        w_mi_inv = pow(fr_root_of_unity(sp.m_i), -1, R_MOD)
        w_smax_inv = pow(fr_root_of_unity(sp.s_max), -1, R_MOD)
        R_omegaX = RXY.scale_coeffs_x(w_mi_inv)
        # all four opening scalars in one host pull
        V_eval, R_eval, R_omegaX_eval, R_omegaX_omegaY_eval = P.eval_many([
            (VXY, chi, zeta),
            (RXY, chi, zeta),
            (R_omegaX, chi, zeta),
            (R_omegaX.scale_coeffs_y(w_smax_inv), chi, zeta),
        ])
        return Proof3(
            V_eval=V_eval, R_eval=R_eval, R_omegaX_eval=R_omegaX_eval,
            R_omegaX_omegaY_eval=R_omegaX_omegaY_eval,
        )

    # -- round 4 (lib.rs:2356-3206) ------------------------------------
    def prove4(self, proof3, thetas, kappa0, chi, zeta, kappa1):
        sp, mix = self.params, self.mixer
        m_i, s_max, n = sp.m_i, sp.s_max, sp.n
        w_mi = fr_root_of_unity(m_i)
        w_smax = fr_root_of_unity(s_max)
        w_mi_inv = pow(w_mi, -1, R_MOD)
        w_smax_inv = pow(w_smax, -1, R_MOD)
        minus_one = (-1) % R_MOD

        # --- all opening scalars for the round in ONE host pull ---------
        r_omegaX = self.rXY.scale_coeffs_x(w_mi_inv)
        r_omegaX_omegaY = r_omegaX.scale_coeffs_y(w_smax_inv)
        lagrange_K0 = W.lagrange_k0_xy(m_i, self.device)
        (small_v_eval, A_eval, lagrange_K0_eval, small_r_eval,
         small_r_omegaX_eval, small_r_omegaX_omegaY_eval) = P.eval_many([
            (self.vXY, chi, zeta),
            (self.a_free_X, chi, zeta),
            (lagrange_K0, chi, zeta),
            (self.rXY, chi, zeta),
            (r_omegaX, chi, zeta),
            (r_omegaX_omegaY, chi, zeta),
        ])
        # r_D1/r_D2 are linear in the polys above (lib.rs:2936-2951)
        r_D1_eval = (small_r_eval - small_r_omegaX_eval) % R_MOD
        r_D2_eval = (small_r_eval - small_r_omegaX_omegaY_eval) % R_MOD

        # --- Pi_A: arithmetic-claim opening quotient (lib.rs:2383-2532)
        t_n_eval = (pow(chi, n, R_MOD) - 1) % R_MOD
        t_smax_eval = (pow(zeta, s_max, R_MOD) - 1) % R_MOD
        rW_X = BiPoly.from_ints([[c % R_MOD] for c in mix.rW_X], self.device)
        rW_Y = BiPoly.from_ints([[c % R_MOD for c in mix.rW_Y]], self.device)
        W_zk = self._w_zk if self._w_zk is not None else (
            P.low_degree_x_times_vanishing(mix.rW_X, n, self.device)
            + P.low_degree_y_times_vanishing(mix.rW_Y, s_max, self.device)
        )
        VXY = self.vXY + self.t_n.mul_scalar(mix.rV_X) + self.t_smax.mul_scalar(mix.rV_Y)
        pA = (
            (VXY - proof3.V_eval).mul_scalar(kappa1)
            + self.uXY.mul_scalar(small_v_eval)
            + self.wXY.mul_scalar(minus_one)
            + self.q0.mul_scalar((-t_n_eval) % R_MOD)
            + self.q1.mul_scalar((-t_smax_eval) % R_MOD)
            + self.t_n.mul_scalar(small_v_eval * mix.rU_X)
            + self.t_smax.mul_scalar(small_v_eval * mix.rU_Y)
            + self.vXY.mul_scalar((-(mix.rU_X * t_n_eval + mix.rU_Y * t_smax_eval)) % R_MOD)
            + rW_X.mul_scalar(t_n_eval)
            + rW_Y.mul_scalar(t_smax_eval)
            + W_zk.mul_scalar(minus_one)
        )
        Pi_AX_XY, Pi_AY_XY, rem_a = pA.div_by_ruffini(chi, zeta, lazy_rem=True)
        if self.testing_mode:
            self._check_ruffini(pA, Pi_AX_XY, Pi_AY_XY, rem_a, chi, zeta, "Pi_A")
        h_pi_ax = encode_poly_start(self.sigma, Pi_AX_XY, self.params)
        h_pi_ay = encode_poly_start(self.sigma, Pi_AY_XY, self.params)

        # --- M, N: R-shift opening quotients (lib.rs:2534-2701)
        RXY = self.rXY + self.t_mi.mul_scalar(mix.rR_X) + self.t_smax.mul_scalar(mix.rR_Y)
        M_num = RXY - proof3.R_omegaX_eval
        M_X_XY, M_Y_XY, rem_m = M_num.div_by_ruffini(
            (w_mi_inv * chi) % R_MOD, zeta, lazy_rem=True)
        if self.testing_mode:
            self._check_ruffini(
                M_num, M_X_XY, M_Y_XY, rem_m, (w_mi_inv * chi) % R_MOD, zeta, "M"
            )
        h_mx = encode_poly_start(self.sigma, M_X_XY, self.params)
        h_my = encode_poly_start(self.sigma, M_Y_XY, self.params)
        N_num = RXY - proof3.R_omegaX_omegaY_eval
        N_X_XY, N_Y_XY, rem_n = N_num.div_by_ruffini(
            (w_mi_inv * chi) % R_MOD, (w_smax_inv * zeta) % R_MOD,
            lazy_rem=True,
        )
        if self.testing_mode:
            self._check_ruffini(
                N_num, N_X_XY, N_Y_XY, rem_n, (w_mi_inv * chi) % R_MOD,
                (w_smax_inv * zeta) % R_MOD, "N",
            )
        h_nx = encode_poly_start(self.sigma, N_X_XY, self.params)
        h_ny = encode_poly_start(self.sigma, N_Y_XY, self.params)
        # sync batch 1: finish the six pending MSMs before building Pi_C
        fin = (lambda h: None if h is None else msm_mod.msm_finish(h))
        Pi_AX, Pi_AY = fin(h_pi_ax), fin(h_pi_ay)
        M_X, M_Y = fin(h_mx), fin(h_my)
        N_X, N_Y = fin(h_nx), fin(h_ny)
        del pA, Pi_AX_XY, Pi_AY_XY, VXY, W_zk, rW_X, rW_Y
        del M_num, M_X_XY, M_Y_XY, N_num, N_X_XY, N_Y_XY

        # --- Pi_C: copy-claim opening quotient (lib.rs:2703-3130)
        f, g = self._f_g(thetas)
        t_mi_eval = (pow(chi, m_i, R_MOD) - 1) % R_MOD
        lagrange_KL = self._lagrange_kl if self._lagrange_kl is not None else \
            W.lagrange_kl_xy(m_i, s_max, self.device)

        term5 = g.mul_scalar(small_r_eval) + f.mul_scalar((-small_r_omegaX_eval) % R_MOD)
        term6 = g.mul_scalar(small_r_eval) + f.mul_scalar(
            (-small_r_omegaX_omegaY_eval) % R_MOD
        )
        pC = (
            lagrange_KL.mul_scalar((small_r_eval - 1) % R_MOD)
            + term5.mul_scalar((kappa0 * (chi - 1)) % R_MOD)
            + term6.mul_scalar((kappa0 * kappa0 % R_MOD) * lagrange_K0_eval % R_MOD)
            + self.q2.mul_scalar((-t_mi_eval) % R_MOD)
            + self.q3.mul_scalar((-t_smax_eval) % R_MOD)
        )

        # zk correction terms (lib.rs:2936-3051)
        r_D1 = self.rXY - r_omegaX
        r_D2 = self.rXY - r_omegaX_omegaY
        term_B_zk = self._term_b_zk if self._term_b_zk is not None else (
            P.low_degree_x_times_vanishing(mix.rB_X, m_i, self.device)
            + P.low_degree_y_times_vanishing(mix.rB_Y, s_max, self.device)
        )
        g_minus_f = g - f
        term10_scale = (mix.rR_X * t_mi_eval + mix.rR_Y * t_smax_eval) % R_MOD
        term10 = g_minus_f.mul_scalar(term10_scale)

        def mul_by_term9(p):
            const = (t_mi_eval * mix.rB_X[0] + t_smax_eval * mix.rB_Y[0]) % R_MOD
            xc = (t_mi_eval * mix.rB_X[1]) % R_MOD
            yc = (t_smax_eval * mix.rB_Y[1]) % R_MOD
            return (
                p.mul_scalar(const)
                + p.mul_monomial(1, 0).mul_scalar(xc)
                + p.mul_monomial(0, 1).mul_scalar(yc)
            )

        def mul_by_one_minus_x(p):
            return p - p.mul_monomial(1, 0)

        r_d1_t9_p10 = mul_by_term9(r_D1) + term10
        LHS_zk1 = (
            term_B_zk.mul_scalar(((chi - 1) * r_D1_eval) % R_MOD)
            + mul_by_one_minus_x(r_d1_t9_p10)
            + term10.mul_scalar((chi - 1) % R_MOD)
        )
        r_d2_t9_p10 = mul_by_term9(r_D2) + term10
        LHS_zk2 = (
            term_B_zk.mul_scalar((lagrange_K0_eval * r_D2_eval) % R_MOD)
            + term10.mul_scalar(lagrange_K0_eval)
            + (lagrange_K0 * r_d2_t9_p10).mul_scalar(minus_one)
        )
        R_minus_eval = RXY - proof3.R_eval
        k1_2 = pow(kappa1, 2, R_MOD)
        k1_3 = pow(kappa1, 3, R_MOD)
        LHS_for_copy = (
            pC.mul_scalar(k1_2)
            + LHS_zk1.mul_scalar((k1_2 * kappa0) % R_MOD)
            + LHS_zk2.mul_scalar((k1_2 * kappa0 * kappa0) % R_MOD)
            + R_minus_eval.mul_scalar(k1_3)
        )
        Pi_CX_XY, Pi_CY_XY, rem_c = LHS_for_copy.div_by_ruffini(chi, zeta, lazy_rem=True)
        if self.testing_mode:
            self._check_ruffini(
                LHS_for_copy, Pi_CX_XY, Pi_CY_XY, rem_c, chi, zeta, "Pi_C"
            )
        del pC, LHS_zk1, LHS_zk2, LHS_for_copy, r_d1_t9_p10, r_d2_t9_p10
        del r_D1, r_D2, term5, term6, term10, g_minus_f, R_minus_eval
        del f, g, r_omegaX, r_omegaX_omegaY
        h_pi_cx = encode_poly_start(self.sigma, Pi_CX_XY, self.params)
        h_pi_cy = encode_poly_start(self.sigma, Pi_CY_XY, self.params)

        # --- Pi_B: binding opening (lib.rs:3137-3181)
        piB_num = self.a_free_X - A_eval
        piB_XY, _, _ = piB_num.div_by_ruffini(chi, zeta, lazy_rem=True)
        h_pi_b = encode_poly_start(self.sigma, piB_XY, self.params)
        # sync batch 2
        Pi_CX, Pi_CY = fin(h_pi_cx), fin(h_pi_cy)
        Pi_B = _g1_mul(fin(h_pi_b), pow(kappa1, 4, R_MOD))

        Pi_X = _g1_add(_g1_add(Pi_AX, Pi_CX), Pi_B)
        Pi_Y = _g1_add(Pi_AY, Pi_CY)
        proof4 = Proof4(Pi_X=Pi_X, Pi_Y=Pi_Y, M_X=M_X, M_Y=M_Y, N_X=N_X, N_Y=N_Y)
        proof4_test = Proof4Test(
            Pi_AX=Pi_AX, Pi_AY=Pi_AY, Pi_CX=Pi_CX, Pi_CY=Pi_CY, Pi_B=Pi_B,
            M_X=M_X, M_Y=M_Y, N_X=N_X, N_Y=N_Y,
        )
        return proof4, proof4_test

    # -- full pipeline (prove/src/main.rs flow) -------------------------
    def prove(self) -> tuple[Proof, Proof4Test]:
        manager = TranscriptManager()
        with timing.span("prove0", "prove"):
            proof0 = self.prove0()
        manager.add_proof0(proof0)
        thetas = manager.get_thetas()
        with timing.span("prove1", "prove"):
            proof1 = self.prove1(thetas)
        manager.add_proof1(proof1)
        kappa0 = manager.get_kappa0()
        with timing.span("prove2", "prove"):
            proof2 = self.prove2(thetas, kappa0)
        manager.add_proof2(proof2)
        chi, zeta = manager.get_chi_zeta()
        with timing.span("prove3", "prove"):
            proof3 = self.prove3(chi, zeta)
        manager.add_proof3(proof3)
        kappa1 = manager.get_kappa1()
        with timing.span("prove4", "prove"):
            proof4, proof4_test = self.prove4(
                proof3, thetas, kappa0, chi, zeta, kappa1
            )
        return (
            Proof(binding=self.binding, proof0=proof0, proof1=proof1,
                  proof2=proof2, proof3=proof3, proof4=proof4),
            proof4_test,
        )

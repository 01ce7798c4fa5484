"""The SNARK verifier — host-side group algebra + one 5x5 multi-pairing.

Port of the JAX package's verifier, which reimplements `verify-rust/src/lib.rs`: transcript replay for challenges,
the algebraic LHS terms (arith / copy / binding), AUX combinations, and the
final pairing-product equality (lib.rs:248-289), plus the decomposed
testing-mode checks (verify_arith / verify_copy / verify_binding,
lib.rs:291-352).
"""

from __future__ import annotations

from ..fields import R_MOD, fr_root_of_unity
from ..host.curve import G1
from ..host.pairing import multi_pairing
from . import witness as W
from .protocol import Instance, PreprocessResult, Proof, Proof4Test, SetupParams
from .setup import Sigma
from .transcript import TranscriptManager
from ..utils.device import resolve_device


def _acc(*terms):
    """Sum of (point, scalar) pairs in host jacobian."""
    acc = G1.infinity
    for p, k in terms:
        if k % R_MOD == 0:
            continue
        acc = G1.add(acc, G1.scalar_mul(G1.from_affine(p), k % R_MOD))
    return acc


def _aff(j):
    return G1.to_affine(j)


class Verifier:
    def __init__(
        self,
        params: SetupParams,
        sigma: Sigma,
        preprocess: PreprocessResult,
        instance: Instance,
        proof: Proof,
        rng=None,
        device=None,
    ):
        device = resolve_device(device)
        params.validate()
        self.params = params
        self.sigma = sigma
        self.preprocess = preprocess
        self.proof = proof
        self.a_pub_X = W.gen_a_free_X(instance, params, device)
        self._rng = rng

    # -- challenges (verify-rust/src/lib.rs:98-117) --------------------
    def collect_challenges(self):
        m = TranscriptManager()
        m.add_proof0(self.proof.proof0)
        thetas = m.get_thetas()
        m.add_proof1(self.proof.proof1)
        kappa0 = m.get_kappa0()
        m.add_proof2(self.proof.proof2)
        chi, zeta = m.get_chi_zeta()
        m.add_proof3(self.proof.proof3)
        kappa1 = m.get_kappa1()
        # kappa2 is the verifier's own batching challenge — the reference
        # samples it randomly (`verify-rust/src/lib.rs`); a fixed value would
        # weaken the batched pairing check, so default to a CSPRNG.
        if self._rng is None:
            from ..utils.rng import secure_rng

            self._rng = secure_rng()
        kappa2 = int.from_bytes(self._rng.bytes(32), "little") % R_MOD
        return thetas, kappa0, chi, zeta, kappa1, kappa2

    def _domain(self, chi, zeta):
        p = self.params
        return {
            "m_i": p.m_i,
            "omega_m_i": fr_root_of_unity(p.m_i),
            "omega_s_max": fr_root_of_unity(p.s_max),
            "t_n_eval": (pow(chi, p.n, R_MOD) - 1) % R_MOD,
            "t_mi_eval": (pow(chi, p.m_i, R_MOD) - 1) % R_MOD,
            "t_smax_eval": (pow(zeta, p.s_max, R_MOD) - 1) % R_MOD,
        }

    def _lagrange_k0_eval(self, dom, chi):
        if chi % R_MOD == 1:
            return 1
        return (
            dom["t_mi_eval"]
            * pow(dom["m_i"], -1, R_MOD)
            * pow((chi - 1) % R_MOD, -1, R_MOD)
        ) % R_MOD

    # -- LHS terms (lib.rs:154-202) ------------------------------------
    def _lhs_arith(self, dom, ch):
        thetas, kappa0, chi, zeta, kappa1, kappa2 = ch
        p0, p3 = self.proof.proof0, self.proof.proof3
        g = self.sigma.G
        return _acc(
            (p0.U, p3.V_eval),
            (p0.W, (-1) % R_MOD),
            (p0.V, kappa1),
            (g, (-(kappa1 * p3.V_eval)) % R_MOD),
            (p0.Q_AX, (-dom["t_n_eval"]) % R_MOD),
            (p0.Q_AY, (-dom["t_smax_eval"]) % R_MOD),
        )

    def _lhs_copy(self, dom, ch, k0_eval):
        thetas, kappa0, chi, zeta, kappa1, kappa2 = ch
        p0, p1, p2, p3 = (
            self.proof.proof0, self.proof.proof1, self.proof.proof2, self.proof.proof3
        )
        g = self.sigma.G
        s1 = self.sigma.sigma_1
        F = _acc(
            (p0.B, 1), (self.preprocess.s0, thetas[0]),
            (self.preprocess.s1, thetas[1]), (g, thetas[2]),
        )
        Gt = _acc(
            (p0.B, 1), (s1.x, thetas[0]), (s1.y, thetas[1]), (g, thetas[2]),
        )
        c1 = (kappa0 * ((chi - 1) % R_MOD)) % R_MOD
        c2 = (kappa0 * kappa0 % R_MOD) * k0_eval % R_MOD
        term1 = _acc(
            (self.sigma.lagrange_KL, (p3.R_eval - 1) % R_MOD),
            (_aff(Gt), (p3.R_eval * c1) % R_MOD),
            (_aff(F), (-(p3.R_omegaX_eval * c1)) % R_MOD),
            (_aff(Gt), (p3.R_eval * c2) % R_MOD),
            (_aff(F), (-(p3.R_omegaX_omegaY_eval * c2)) % R_MOD),
            (p2.Q_CX, (-dom["t_mi_eval"]) % R_MOD),
            (p2.Q_CY, (-dom["t_smax_eval"]) % R_MOD),
        )
        k1_2 = pow(kappa1, 2, R_MOD)
        k1_3 = pow(kappa1, 3, R_MOD)
        return _acc(
            (_aff(term1), k1_2),
            (p1.R, k1_3), (g, (-(k1_3 * p3.R_eval)) % R_MOD),
            (p1.R, kappa2), (g, (-(kappa2 * p3.R_omegaX_eval)) % R_MOD),
            (p1.R, pow(kappa2, 2, R_MOD)),
            (g, (-(pow(kappa2, 2, R_MOD) * p3.R_omegaX_omegaY_eval)) % R_MOD),
        )

    def _lhs_binding(self, ch, a_eval):
        thetas, kappa0, chi, zeta, kappa1, kappa2 = ch
        b = self.proof.binding
        k = (kappa2 * pow(kappa1, 4, R_MOD)) % R_MOD
        return _acc(
            (b.A_free, (1 + k) % R_MOD),
            (self.sigma.G, (-(k * a_eval)) % R_MOD),
        )

    def _snark_aux(self, dom, ch):
        thetas, kappa0, chi, zeta, kappa1, kappa2 = ch
        p4 = self.proof.proof4
        w_mi_inv = pow(dom["omega_m_i"], -1, R_MOD)
        w_smax_inv = pow(dom["omega_s_max"], -1, R_MOD)
        k2_2 = pow(kappa2, 2, R_MOD)
        k2_3 = pow(kappa2, 3, R_MOD)
        AUX = _acc(
            (p4.Pi_X, (kappa2 * chi) % R_MOD),
            (p4.Pi_Y, (kappa2 * zeta) % R_MOD),
            (p4.M_X, (k2_2 * w_mi_inv % R_MOD) * chi % R_MOD),
            (p4.M_Y, (k2_2 * zeta) % R_MOD),
            (p4.N_X, (k2_3 * w_mi_inv % R_MOD) * chi % R_MOD),
            (p4.N_Y, (k2_3 * w_smax_inv % R_MOD) * zeta % R_MOD),
        )
        AUX_X = _acc((p4.Pi_X, kappa2), (p4.M_X, k2_2), (p4.N_X, k2_3))
        AUX_Y = _acc((p4.Pi_Y, kappa2), (p4.M_Y, k2_2), (p4.N_Y, k2_3))
        return AUX, AUX_X, AUX_Y

    # -- the one pairing check (lib.rs:248-289) ------------------------
    def verify_snark(self) -> bool:
        ch = self.collect_challenges()
        thetas, kappa0, chi, zeta, kappa1, kappa2 = ch
        dom = self._domain(chi, zeta)
        k0_eval = self._lagrange_k0_eval(dom, chi)
        a_eval = self.a_pub_X.eval(chi, zeta)
        lhs_a = self._lhs_arith(dom, ch)
        lhs_c = self._lhs_copy(dom, ch, k0_eval)
        lhs_b = self._lhs_binding(ch, a_eval)
        lhs = G1.add(lhs_b, G1.scalar_mul(G1.add(lhs_a, lhs_c), kappa2))
        aux, aux_x, aux_y = self._snark_aux(dom, ch)

        p0 = self.proof.proof0
        b = self.proof.binding
        s2 = self.sigma.sigma_2
        O_pub = _aff(_acc((self.preprocess.O_pub_fix, 1), (b.O_pub_free, 1)))
        left = multi_pairing(
            [_aff(G1.add(lhs, aux)), p0.B, p0.U, p0.V, p0.W],
            [self.sigma.H, s2.alpha4, s2.alpha, s2.alpha2, s2.alpha3],
        )
        right = multi_pairing(
            [O_pub, b.O_mid, b.O_prv, _aff(aux_x), _aff(aux_y)],
            [s2.gamma, s2.eta, s2.delta, s2.x, s2.y],
        )
        return left == right

    # -- decomposed testing-mode checks (lib.rs:291-352) ---------------
    def verify_arith(self, proof4t: Proof4Test) -> bool:
        ch = self.collect_challenges()
        thetas, kappa0, chi, zeta, kappa1, kappa2 = ch
        dom = self._domain(chi, zeta)
        lhs_a = self._lhs_arith(dom, ch)
        aux_a = _acc((proof4t.Pi_AX, chi), (proof4t.Pi_AY, zeta))
        s2 = self.sigma.sigma_2
        left = multi_pairing([_aff(G1.add(lhs_a, aux_a))], [self.sigma.H])
        right = multi_pairing([proof4t.Pi_AX, proof4t.Pi_AY], [s2.x, s2.y])
        return left == right

    def verify_copy(self, proof4t: Proof4Test) -> bool:
        ch = self.collect_challenges()
        thetas, kappa0, chi, zeta, kappa1, kappa2 = ch
        dom = self._domain(chi, zeta)
        k0_eval = self._lagrange_k0_eval(dom, chi)
        lhs_c = self._lhs_copy(dom, ch, k0_eval)
        w_mi_inv = pow(dom["omega_m_i"], -1, R_MOD)
        w_smax_inv = pow(dom["omega_s_max"], -1, R_MOD)
        k2_2 = pow(kappa2, 2, R_MOD)
        aux_c = _acc(
            (proof4t.Pi_CX, chi), (proof4t.Pi_CY, zeta),
            (proof4t.M_X, (kappa2 * w_mi_inv % R_MOD) * chi % R_MOD),
            (proof4t.M_Y, (kappa2 * zeta) % R_MOD),
            (proof4t.N_X, (k2_2 * w_mi_inv % R_MOD) * chi % R_MOD),
            (proof4t.N_Y, (k2_2 * w_smax_inv % R_MOD) * zeta % R_MOD),
        )
        aux_x = _acc((proof4t.Pi_CX, 1), (proof4t.M_X, kappa2), (proof4t.N_X, k2_2))
        aux_y = _acc((proof4t.Pi_CY, 1), (proof4t.M_Y, kappa2), (proof4t.N_Y, k2_2))
        s2 = self.sigma.sigma_2
        left = multi_pairing([_aff(G1.add(lhs_c, aux_c))], [self.sigma.H])
        right = multi_pairing([_aff(aux_x), _aff(aux_y)], [s2.x, s2.y])
        return left == right

    def verify_binding(self, proof4t: Proof4Test) -> bool:
        ch = self.collect_challenges()
        thetas, kappa0, chi, zeta, kappa1, kappa2 = ch
        a_eval = self.a_pub_X.eval(chi, zeta)
        lhs_b = self._lhs_binding(ch, a_eval)
        aux_b = _acc((proof4t.Pi_B, (kappa2 * chi) % R_MOD))
        p0 = self.proof.proof0
        b = self.proof.binding
        s2 = self.sigma.sigma_2
        O_pub = _aff(_acc((self.preprocess.O_pub_fix, 1), (b.O_pub_free, 1)))
        left = multi_pairing(
            [_aff(G1.add(lhs_b, aux_b)), p0.B, p0.U, p0.V, p0.W],
            [self.sigma.H, s2.alpha4, s2.alpha, s2.alpha2, s2.alpha3],
        )
        right = multi_pairing(
            [O_pub, b.O_mid, b.O_prv, _aff(_acc((proof4t.Pi_B, kappa2)))],
            [s2.gamma, s2.eta, s2.delta, s2.x],
        )
        return left == right

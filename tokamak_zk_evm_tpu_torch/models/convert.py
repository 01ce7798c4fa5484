"""Carry the JAX package's CRS and proofs into the port.

The port imports nothing of the JAX package.  These converters read the
other package's objects only through attributes and `numpy.asarray`, so both
packages can prove from one CRS and each verifier can check the other's
proofs.  A device point family arrives as three arrays (x and y limb-major
[24, N] uint32, Montgomery; inf [N]) with the interchange bit pattern.
"""

from __future__ import annotations

import numpy as np
import torch

from .protocol import (
    Binding, Proof, Proof0, Proof1, Proof2, Proof3, Proof4,
)
from .setup import Sigma, Sigma1, Sigma2


def _family(fam, device):
    if fam is None:
        return None
    return tuple(torch.as_tensor(np.asarray(a).astype(np.int32), device=device)
                 for a in fam)


def sigma_from_arrays(sigma, device) -> Sigma:
    """A `Sigma` with the JAX package's field names -> the port's `Sigma`
    with its device families on `device`."""
    s1, s2 = sigma.sigma_1, sigma.sigma_2
    sigma1 = Sigma1(
        xy_powers=_family(s1.xy_powers, device),
        h_max=int(s1.h_max),
        rs_y=int(s1.rs_y),
        gamma_inv_o_inst=_family(s1.gamma_inv_o_inst, device),
        eta_inv_li_o_inter_alpha4_kj=_family(s1.eta_inv_li_o_inter_alpha4_kj, device),
        delta_inv_li_o_prv=_family(s1.delta_inv_li_o_prv, device),
        x=s1.x, y=s1.y, delta=s1.delta, eta=s1.eta,
        delta_inv_alphak_xh_tx=[list(r) for r in s1.delta_inv_alphak_xh_tx],
        delta_inv_alpha4_xj_tx=list(s1.delta_inv_alpha4_xj_tx),
        delta_inv_alphak_yi_ty=[list(r) for r in s1.delta_inv_alphak_yi_ty],
    )
    sigma2 = Sigma2(**{k: getattr(s2, k) for k in (
        "alpha", "alpha2", "alpha3", "alpha4", "gamma", "delta", "eta", "x", "y")})
    return Sigma(G=sigma.G, H=sigma.H, sigma_1=sigma1, sigma_2=sigma2,
                 lagrange_KL=sigma.lagrange_KL)


def _pt(p):
    return None if p is None else (int(p[0]), int(p[1]))


def proof_from_fields(proof) -> Proof:
    """A proof with the JAX package's field names -> the port's `Proof`."""
    b, p0, p1, p2, p3, p4 = (proof.binding, proof.proof0, proof.proof1, proof.proof2,
                             proof.proof3, proof.proof4)
    return Proof(
        binding=Binding(A_free=_pt(b.A_free), O_pub_free=_pt(b.O_pub_free),
                        O_mid=_pt(b.O_mid), O_prv=_pt(b.O_prv)),
        proof0=Proof0(U=_pt(p0.U), V=_pt(p0.V), W=_pt(p0.W), Q_AX=_pt(p0.Q_AX),
                      Q_AY=_pt(p0.Q_AY), B=_pt(p0.B)),
        proof1=Proof1(R=_pt(p1.R)),
        proof2=Proof2(Q_CX=_pt(p2.Q_CX), Q_CY=_pt(p2.Q_CY)),
        proof3=Proof3(V_eval=int(p3.V_eval), R_eval=int(p3.R_eval),
                      R_omegaX_eval=int(p3.R_omegaX_eval),
                      R_omegaX_omegaY_eval=int(p3.R_omegaX_omegaY_eval)),
        proof4=Proof4(Pi_X=_pt(p4.Pi_X), Pi_Y=_pt(p4.Pi_Y), M_X=_pt(p4.M_X),
                      M_Y=_pt(p4.M_Y), N_X=_pt(p4.N_X), N_Y=_pt(p4.N_Y)),
    )

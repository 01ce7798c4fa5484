"""The phase-2 MPC ceremony: a contributor and the coordinator on one card.

Set-up makes the starting CRS on the device from the seed's tau
(`generate_sigma`, as the resident prover does).  A job is one link of the
chain: `phase2_contribute(sigma, <the contributor's stream>)` on the CRS the
coordinator last accepted, then `phase2_verify(sigma, new, proof,
rng=<the coordinator's stream>)`; the chain moves on to the new CRS only
where the coordinator accepts it.  The warm-up job never moves it, so the
window's first job builds on the starting CRS.  The answer is the verdict,
the three Schnorr proofs, and both CRS at the task's sampled points.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tokamak_zk_evm_tpu_torch.models.mpc_setup import phase2_contribute, phase2_verify
from tokamak_zk_evm_tpu_torch.models.setup import generate_sigma
from tokamak_zk_evm_tpu_torch.ops import curve as cv

from ..reference.ceremony import FAMILIES
from . import base, port

HOST_G1 = ("x", "y", "delta", "eta")
G2_POINTS = ("alpha", "alpha2", "alpha3", "alpha4", "gamma", "delta", "eta", "x", "y")


class Entry(base.Entry):
    mixers = False
    unrescaled = False  # the control: hand over delta_inv_li_o_prv as it was

    def setup(self):
        lib = self.ctx.lib
        self.sigma = generate_sigma(port.params(lib), port.tau(self.ctx.tau), port.library(lib),
                                    port.infos(lib), device=self.device)
        self.sync()

    def prepare(self, job, key):
        return key, job

    def run_job(self, item):
        key, job = item
        prev = self.sigma
        contributor = np.random.default_rng(job["contributor"])
        coordinator = np.random.default_rng(job["coordinator"])
        rec = self.rec
        if rec is None:
            new, proof = phase2_contribute(prev, contributor)
            new = self._handed(prev, new)
            ok = phase2_verify(prev, new, proof, rng=coordinator)
            self.sync()
            timing = {}
        else:
            new, proof = rec.span("p2.contribute", phase2_contribute, prev, contributor)
            contribute_s = rec.last_s()
            new = self._handed(prev, new)
            ok = rec.span("p2.verify", phase2_verify, prev, new, proof, rng=coordinator)
            timing = dict(contribute_s=contribute_s, verify_s=rec.last_s())
        answer = dict(accepted=bool(ok), pok=_pok(proof), prev=self.samples(prev),
                      cur=self.samples(new))
        if ok and key != "warmup":
            self.sigma = new
        return dict(proof=answer, timing=timing)

    def _handed(self, prev, new):
        if not self.unrescaled:
            return new
        s1 = dataclasses.replace(new.sigma_1,
                                 delta_inv_li_o_prv=prev.sigma_1.delta_inv_li_o_prv)
        return dataclasses.replace(new, sigma_1=s1)

    def samples(self, sigma) -> dict:
        """The CRS at the task's sampled indices, as plain ints (None for
        the identity): the four device families, the 23 delta-inverse host
        points in the layout's order, and the other host points."""
        s1, s2 = sigma.sigma_1, sigma.sigma_2
        fams = {}
        for name in FAMILIES:
            px, py, pinf = getattr(s1, name)
            idx = torch.as_tensor(self.ctx.samples[name], device=px.device)
            fams[name] = cv.unpack_affine((px[:, idx], py[:, idx], pinf[idx]))
        rows = s1.delta_inv_alphak_xh_tx + [s1.delta_inv_alpha4_xj_tx] + s1.delta_inv_alphak_yi_ty
        g1 = {k: getattr(s1, k) for k in HOST_G1}
        g1.update(G=sigma.G, lagrange_KL=sigma.lagrange_KL)
        g2 = {k: getattr(s2, k) for k in G2_POINTS}
        g2["H"] = sigma.H
        return dict(families=fams, small=[_plain(p) for row in rows for p in row],
                    g1={k: _plain(p) for k, p in g1.items()},
                    g2={k: _plain(p) for k, p in g2.items()})

    def close(self):
        self.sigma = None
        if self.device != "cpu":
            torch.cuda.empty_cache()


def _plain(p):
    """A host point as nested tuples of ints, None for the identity."""
    if p is None:
        return None
    return tuple(_plain(c) if isinstance(c, (tuple, list)) else int(c) for c in p)


def _pok(proof) -> dict:
    return {name: dict(X_g1=_plain(pf.X_g1), X_g2=_plain(pf.X_g2), R=_plain(pf.R), s=int(pf.s))
            for name, pf in (("gamma", proof.proof_gamma), ("delta", proof.proof_delta),
                             ("eta", proof.proof_eta))}

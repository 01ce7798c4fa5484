"""The close of phase 1 and the circuit-specific prepare: a phase-1
contributor and the coordinator on one card.

Set-up holds the library in the program's types and the starting
accumulator (`Phase1Accumulator.initial`).  A job is, in order:
`compute(<the contributor's stream>)` on the accumulator the coordinator
last accepted; the hand-over, `Phase1Accumulator.from_json(new.to_json())`,
the checked load; `prev.verify(loaded, proof, rng=<the coordinator's
stream>)`; and `phase2_prepare` of the last accepted accumulator (the
loaded one once the coordinator accepts it) with the job's beacon y, on the
card.  The chain moves on only where the coordinator accepts; the warm-up
job never moves it, so the window's first job builds on the starting
accumulator.  The answer is the verdict, both Schnorr proofs, the loaded
accumulator at the task's sampled indices (and every alpha_g1, alpha_g2 and
x_g2), and the prepared CRS at the task's sampled points.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tokamak_zk_evm_tpu_torch.models.mpc_setup import Phase1Accumulator, phase2_prepare

from . import base, port
from .ceremony import Entry as CeremonyEntry
from .ceremony import _plain


class Entry(base.Entry):
    mixers = False
    unupdated = False  # the control: hand over the first sampled x_g1 power as it was

    def setup(self):
        lib = self.ctx.lib
        self.params, self.library, self.infos = port.params(lib), port.library(lib), port.infos(lib)
        self.acc = Phase1Accumulator.initial(self.params)

    def prepare(self, job, key):
        return key, job

    def run_job(self, item):
        key, job = item
        prev = self.acc
        contributor = np.random.default_rng(job["contributor"])
        coordinator = np.random.default_rng(job["coordinator"])
        rec, dev = self.rec, self.device

        def step(label, fn, *a, **kw):
            return fn(*a, **kw) if rec is None else rec.span(label, fn, *a, **kw)

        new, proof = step("p1.contribute", prev.compute, contributor, dev)
        handed = self._handed(prev, new).to_json()
        loaded = step("p1.load", Phase1Accumulator.from_json, handed, dev)
        ok = step("p1.verify", prev.verify, loaded, proof, rng=coordinator, device=dev)
        sigma = step("p2.prepare", phase2_prepare, loaded if ok else prev, job["y"], self.params,
                     self.library, self.infos, dev)
        self.sync()
        timing = {}
        if rec is not None:
            contribute, load, verify, prep = (t1 - t0 for _, t0, t1 in rec.spans[-4:])
            timing = dict(contribute_s=contribute / 1e9, check_s=(load + verify) / 1e9,
                          prepare_s=prep / 1e9)
        # the ceremony entry's sampler reads only `self.ctx.samples`
        answer = dict(accepted=bool(ok), pok=_pok(proof), acc=self.acc_samples(loaded),
                      crs=CeremonyEntry.samples(self, sigma))
        if ok and key != "warmup":
            self.acc = loaded
        return dict(proof=answer, timing=timing)

    def _handed(self, prev, new):
        if not self.unupdated:
            return new
        h = self.ctx.acc_samples["x_g1"][0]
        x_g1 = list(new.x_g1)
        x_g1[h] = prev.x_g1[h]
        return dataclasses.replace(new, x_g1=x_g1)

    def acc_samples(self, acc) -> dict:
        """The accumulator at the task's sampled indices, as plain ints
        (None for the identity), with every alpha_g1, alpha_g2 and x_g2."""
        idx = self.ctx.acc_samples
        return dict(index=acc.contributor_index,
                    x_g1=[_plain(acc.x_g1[h]) for h in idx["x_g1"]],
                    alpha_x_g1=[[_plain(acc.alpha_x_g1[k][h]) for h in row]
                                for k, row in enumerate(idx["alpha_x_g1"])],
                    alpha_g1=[_plain(p) for p in acc.alpha_g1],
                    alpha_g2=[_plain(p) for p in acc.alpha_g2],
                    x_g2=_plain(acc.x_g2))

    def close(self):
        self.acc = None
        if self.device != "cpu":
            torch.cuda.empty_cache()


def _pok(proof) -> dict:
    return {name: dict(X_g1=_plain(pf.X_g1), X_g2=_plain(pf.X_g2), R=_plain(pf.R), s=int(pf.s))
            for name, pf in (("alpha", proof.proof_alpha), ("x", proof.proof_x))}

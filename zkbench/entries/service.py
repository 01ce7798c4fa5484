"""A resident prover: the CRS and the library held across jobs.

Set-up makes the CRS on the device from the seed's tau (`generate_sigma`);
a job is then `Prover(params, sigma, library, infos, placements,
permutation, instance, mixer=<the job's mixer, drawn from the seed>).prove()`.
"""

from __future__ import annotations

import torch

from tokamak_zk_evm_tpu_torch.models.prover import Prover
from tokamak_zk_evm_tpu_torch.models.setup import generate_sigma

from .. import gen
from . import base, port


class Entry(base.Entry):
    def setup(self):
        lib = self.ctx.lib
        self.params, self.infos, self.library = port.params(lib), port.infos(lib), port.library(lib)
        self.sigma = generate_sigma(self.params, port.tau(self.ctx.tau), self.library,
                                    self.infos, device=self.device)
        self.sync()

    def prepare(self, job, key):
        mixer = gen.zero_mixer() if self.zero_blinding else job.mixer
        return (*port.job_inputs(job), port.mixer(mixer))

    def run_job(self, item):
        placements, permutation, instance, mixer = item
        args = (self.params, self.sigma, self.library, self.infos, placements, permutation,
                instance)
        rec = self.rec
        if rec is None:
            proof, _ = Prover(*args, mixer=mixer, device=self.device).prove()
            self.sync()
            return dict(proof=port.proof_dict(proof), timing={})
        prover = rec.span("prover.init", Prover, *args, mixer=mixer, device=self.device)
        init_s = rec.last_s()
        proof, _ = rec.span("prover.rounds", prover.prove)
        return dict(proof=port.proof_dict(proof),
                    timing=dict(init_s=init_s, rounds_s=rec.last_s()))

    def close(self):
        self.sigma = None
        if self.device != "cpu":
            torch.cuda.empty_cache()

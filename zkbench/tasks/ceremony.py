"""A kind of job: one link of the phase-2 MPC ceremony, a contribution made
on the CRS the coordinator last accepted and then verified by the
coordinator, judged by the plain reference (`reference/ceremony.py`).

The configuration's `library` (a `setupParams.json`) and the seed give the
library, tau (the starting CRS is `generate_sigma` from it) and the sampled
indices (the mix's `samples` a family); job `i` is two seeds of its own, the
contributor's stream and the coordinator's.  Every completed job is judged.

Controls (`zkbench.control`):

* `control`: the entry hands the coordinator a contribution whose
  `delta_inv_li_o_prv` was left as it was (not rescaled).  The coordinator
  has to refuse it (`rejected`) and the reference to see it (`mismatch`).
* `altered`: one sampled point of each contribution changed where the entry
  hands the answer over.  The reference alone has to see it (`mismatch`).
"""

from __future__ import annotations

from .. import gen
from ..reference.ceremony import Ceremony, sample_indices
from ..reference.curve import G1_GEN, Q
from ..run import log

SECONDS_PER_JOB = "proof_s"  # here the window's seconds over the contributions made and verified

# every number compared, with its limit: a count of jobs, proofs or points, exact
LIMITS = {
    "rejected": {"limit": 0},
    "pok_fail": {"limit": 0},
    "mismatch": {"limit": 0},
    "missing": {"limit": 0},
    "judged": {"at_least": 1},
}


def alter_sample(answer: dict) -> dict:
    """The contribution's first sampled `delta_inv_li_o_prv` point negated
    (the generator where it is the identity), in a copy."""
    fams = dict(answer["cur"]["families"])
    pts = list(fams["delta_inv_li_o_prv"])
    p = pts[0]
    pts[0] = G1_GEN if p is None else (p[0], (Q - p[1]) % Q)
    fams["delta_inv_li_o_prv"] = pts
    return dict(answer, cur=dict(answer["cur"], families=fams))


CONTROLS = {
    "control": dict(unrescaled=True),
    "altered": dict(alter=alter_sample),
}


def shared(ctx):
    """The library, tau and the sampled indices."""
    ctx.lib = gen.make_library(**ctx.config["library"])
    ctx.tau = gen.make_tau(gen.rng_for(ctx.seed, 0))
    ctx.samples = sample_indices(ctx.lib.params, ctx.traffic["samples"],
                                 gen.rng_for(ctx.seed, 7))


def _seeds(rng) -> dict:
    contributor, coordinator = (int(v) for v in rng.integers(0, 2**63, size=2))
    return dict(contributor=contributor, coordinator=coordinator)


def make_job(ctx, i: int) -> dict:
    return dict(index=i, **_seeds(gen.rng_for(ctx.seed, 8, i)))


def warmup_job(ctx) -> dict:
    return dict(index=-1, **_seeds(gen.rng_for(ctx.seed, 9)))


def judge(ctx, jobs: list, done: list, failed: list, seed: int) -> dict:
    """Every completed job, in the order they ran, held to the reference."""
    ran = sorted(done, key=lambda r: r["k"])
    chain = [(jobs[r["k"]]["contributor"], r["proof"]) for r in ran]
    flags = Ceremony(ctx.lib, ctx.tau, ctx.samples).judge(chain)
    for n, what, where in flags.pop("detail"):
        log(f"[zkbench] job {ran[n]['k']}: {what}: {where}")
    flags["missing"] = len(failed)
    flags["judged"] = len(chain)
    return flags

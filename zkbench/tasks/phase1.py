"""A kind of job: the close of phase 1 of the MPC ceremony and the
circuit-specific prepare, judged by the plain reference
(`reference/phase1.py`).

A job is one phase-1 update made on the accumulator the coordinator last
accepted, its checked load from the accumulator's JSON, the coordinator's
check, and `phase2_prepare` of the last accepted accumulator with the job's
beacon y.  The configuration's `library` (a `setupParams.json`) and the seed
give the library and the sampled indices (the mix's `samples` a row of the
accumulator and a family of the CRS); job `i` is three seeds of its own, the
contributor's stream, the coordinator's and the beacon's.  Every completed
job is judged.

Controls (`zkbench.control`):

* `control`: the entry hands the coordinator an accumulator whose first
  sampled `x_g1` power was left as it was (not updated).  The coordinator
  has to refuse it (`rejected`) and the reference to see it (`mismatch`).
* `altered`: the first sampled `delta_inv_li_o_prv` point of each prepared
  CRS negated where the entry hands the answer over.  The reference alone
  has to see it (`mismatch`).
"""

from __future__ import annotations

from .. import gen
from ..reference import phase1 as RP
from ..reference.ceremony import sample_indices
from ..reference.curve import G1_GEN, Q
from ..run import log

SECONDS_PER_JOB = "proof_s"  # here the window's seconds over the jobs completed in it

# every number compared, with its limit: a count of jobs, proofs or points, exact
LIMITS = {
    "rejected": {"limit": 0},
    "pok_fail": {"limit": 0},
    "mismatch": {"limit": 0},
    "missing": {"limit": 0},
    "judged": {"at_least": 1},
}


def alter_sample(answer: dict) -> dict:
    """The prepared CRS's first sampled `delta_inv_li_o_prv` point negated
    (the generator where it is the identity), in a copy."""
    fams = dict(answer["crs"]["families"])
    pts = list(fams["delta_inv_li_o_prv"])
    p = pts[0]
    pts[0] = G1_GEN if p is None else (p[0], (Q - p[1]) % Q)
    fams["delta_inv_li_o_prv"] = pts
    return dict(answer, crs=dict(answer["crs"], families=fams))


CONTROLS = {
    "control": dict(unupdated=True),
    "altered": dict(alter=alter_sample),
}


def shared(ctx):
    """The library and the sampled indices of the CRS and the accumulator."""
    ctx.lib = gen.make_library(**ctx.config["library"])
    ctx.samples = sample_indices(ctx.lib.params, ctx.traffic["samples"],
                                 gen.rng_for(ctx.seed, 7))
    ctx.acc_samples = RP.sample_indices(ctx.lib.params, ctx.traffic["samples"],
                                        gen.rng_for(ctx.seed, 10))


def _seeds(rng) -> dict:
    contributor, coordinator, beacon = (int(v) for v in rng.integers(0, 2**63, size=3))
    return dict(contributor=contributor, coordinator=coordinator, beacon=beacon,
                y=RP.beacon(beacon))


def make_job(ctx, i: int) -> dict:
    return dict(index=i, **_seeds(gen.rng_for(ctx.seed, 8, i)))


def warmup_job(ctx) -> dict:
    return dict(index=-1, **_seeds(gen.rng_for(ctx.seed, 9)))


def judge(ctx, jobs: list, done: list, failed: list, seed: int) -> dict:
    """Every completed job, in the order they ran, held to the reference."""
    ran = sorted(done, key=lambda r: r["k"])
    chain = [(jobs[r["k"]]["contributor"], jobs[r["k"]]["beacon"], r["proof"]) for r in ran]
    flags = RP.Phase1(ctx.lib, ctx.acc_samples, ctx.samples).judge(chain)
    for n, what, where in flags.pop("detail"):
        log(f"[zkbench] job {ran[n]['k']}: {what}: {where}")
    flags["missing"] = len(failed)
    flags["judged"] = len(chain)
    return flags

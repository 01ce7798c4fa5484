"""A kind of job: one transaction proved, judged by the plain reference.

The configuration's `library` (a `setupParams.json`) and the seed give the
library and tau; the traffic mix's `placements` [lo, hi] and `heavy_share`
give each job's size and kinds, and `judge` the number of proofs judged.
A job carries the generator's mixer where the entry blinds with it
(`ctx.mixers`), and the judge then knows every commitment exactly.

Controls (`zkbench.control`):

* `control`: the program's own zero-blinding path switched on (the
  service's `Mixer.zero()` in place of the job's mixer, the CLI's
  `--deterministic`), where the configuration states zero-knowledge
  blinding.  `unblinded` has to come out above its limit.
* `altered`: each proof's `V_eval` changed by one where the entry hands the
  proof over.  `relation_fail` has to come out above its limit.
"""

from __future__ import annotations

from .. import gen
from ..reference.check import Reference
from ..reference.curve import R
from ..run import log

SECONDS_PER_JOB = "proof_s"

# every number compared, with its limit: a count of proofs, exact
LIMITS = {
    "relation_fail": {"limit": 0},
    "unblinded": {"limit": 0},
    "mismatch": {"limit": 0},
    "layout_fail": {"limit": 0},
    "missing": {"limit": 0},
    "judged": {"at_least": 1},
}


def alter_v_eval(proof: dict) -> dict:
    return dict(proof, V_eval=(proof["V_eval"] + 1) % R)


CONTROLS = {
    "control": dict(zero_blinding=True),
    "altered": dict(alter=alter_v_eval),
}


def shared(ctx):
    """The library and tau, which the entry and every job share."""
    ctx.lib = gen.make_library(**ctx.config["library"])
    ctx.tau = gen.make_tau(gen.rng_for(ctx.seed, 0))


def make_job(ctx, i: int) -> gen.Job:
    return gen.job(ctx.lib, gen.placement_count(ctx.traffic, i), ctx.seed, i, ctx.mixers,
                   tuple(ctx.traffic["heavy_share"]))


def warmup_job(ctx) -> gen.Job:
    """A job of the mix's largest size, from a stream of its own."""
    rng = gen.rng_for(ctx.seed, 3)
    job = gen.make_job(ctx.lib, ctx.traffic["placements"][1], rng, index=-1,
                       heavy=tuple(ctx.traffic["heavy_share"]))
    if ctx.mixers:
        job.mixer = gen.make_mixer(rng)
    return job


def judge(ctx, jobs: list, done: list, failed: list, seed: int) -> dict:
    """Hold a sample of the window's proofs to the plain reference: the
    longest job and `judge - 1` others drawn from the seed."""
    sample_n = ctx.traffic["judge"]
    order = list(range(len(done)))
    if len(order) > sample_n:
        rng = gen.rng_for(seed, 4)
        longest = max(order, key=lambda i: jobs[done[i]["k"]].n_placements)
        rest = [i for i in order if i != longest]
        pick = rng.choice(len(rest), size=sample_n - 1, replace=False)
        order = sorted([longest] + [rest[int(i)] for i in pick])
    ref = Reference(ctx.lib, ctx.tau)
    flags = dict(relation_fail=0, unblinded=0, mismatch=0, layout_fail=0)
    for i in order:
        res = done[i]
        job = jobs[res["k"]]
        if res.get("layout_error"):
            flags["layout_fail"] += 1
            continue
        k2 = gen.rand_fr(gen.rng_for(seed, 5, res["k"]))
        mixer = job.mixer if ctx.mixers else None
        verdict = ref.judge(job, res["proof"], mixer, k2)
        for key in ("relation_fail", "unblinded", "mismatch"):
            flags[key] += verdict[key]
        if verdict["detail"] or verdict["relation_fail"]:
            log(f"[zkbench] job {res['k']}: {verdict}")
    layout_fails = sum(1 for r in failed if r.get("layout_error"))
    flags["layout_fail"] += layout_fails
    flags["missing"] = len(failed) - layout_fails
    flags["judged"] = len(order)
    return flags

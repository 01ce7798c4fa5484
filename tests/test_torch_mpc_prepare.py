"""Phase 1's close and the circuit-specific prepare against the benchmark's
plain reference (`zkbench/reference/phase1.py`), on the CPU at a small
`zkbench.gen` library (n = 16: at n = 8 a sound proof is rejected).

Two phase-1 contributions, each handed over as the accumulator's JSON and
loaded checked, each checked by the coordinator, then `phase2_prepare` of
the last one: every point of the accumulators and of every family of the
prepared CRS equals the reference's, the proofs of knowledge are the
documented draws, and an update with one power left as it was is refused
and seen by the reference.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu_torch.models import mpc_setup as M
from zkbench import gen
from zkbench.entries import port
from zkbench.entries.ceremony import Entry as CeremonyEntry
from zkbench.entries.phase1 import Entry as Phase1Entry
from zkbench.entries.phase1 import _pok
from zkbench.reference import ceremony as RC
from zkbench.reference import phase1 as RP
from zkbench.reference.curve import R

torch.set_num_threads(1)
CPU = torch.device("cpu")
LIB = dict(l=6, l_D=22, l_free=4, l_user=2, l_user_out=1, m_D=35, n=16, s_D=5, s_max=8)
SEEDS = [(2**40 + 11, 2**40 + 12), (2**41 + 13, 2**41 + 14)]  # (contributor, coordinator)
BEACON = 2**42 + 15


def every_index(params: dict) -> tuple[dict, dict]:
    """Every index of the accumulator's rows and of the CRS's families."""
    x_len, ax_len = RP.acc_sizes(params)
    acc = dict(x_g1=list(range(x_len)), alpha_x_g1=[list(range(ax_len))] * RP.N_ALPHA)
    return acc, {k: list(range(v)) for k, v in RC.family_sizes(params).items()}


@pytest.fixture(scope="module")
def chain():
    lib = gen.make_library(**LIB)
    params = port.params(lib)
    acc_idx, crs_idx = every_index(lib.params)
    view = SimpleNamespace(ctx=SimpleNamespace(samples=crs_idx, acc_samples=acc_idx))
    acc = M.Phase1Accumulator.initial(params)
    steps = []
    for contributor, coordinator in SEEDS:
        new, proof = acc.compute(np.random.default_rng(contributor), CPU)
        handed = new.to_json()
        loaded = M.Phase1Accumulator.from_json(handed, CPU)
        ok = acc.verify(loaded, proof, rng=np.random.default_rng(coordinator), device=CPU)
        steps.append(SimpleNamespace(prev=acc, new=new, handed=handed, loaded=loaded, proof=proof,
                                     ok=ok, answer=Phase1Entry.acc_samples(view, loaded)))
        acc = loaded
    y = RP.beacon(BEACON)
    sigma = M.phase2_prepare(acc, y, params, port.library(lib), port.infos(lib), CPU)
    return SimpleNamespace(lib=lib, steps=steps, y=y, crs=CeremonyEntry.samples(view, sigma),
                           judge=RP.Phase1(lib, acc_idx, crs_idx), view=view)


def test_the_hand_over_is_exact_and_checked(chain):
    for s in chain.steps:
        assert s.loaded.to_json() == s.handed == s.new.to_json()
        assert s.loaded.contributor_index == s.prev.contributor_index + 1
    assert [s.ok for s in chain.steps] == [True, True]


@pytest.mark.parametrize("step", [0, 1])
def test_proofs_of_knowledge_are_the_documented_draws(chain, step):
    s = chain.steps[step]
    secrets = RP.secrets(SEEDS[step][0])
    assert RP.Phase1.pok_fails(secrets, _pok(s.proof)) == []
    # the draws in another order cannot pass
    swapped = dict(secrets, u=dict(alpha=secrets["u"]["x"], x=secrets["u"]["alpha"]))
    assert RP.Phase1.pok_fails(swapped, _pok(s.proof)) == ["alpha", "x"]


@pytest.mark.parametrize("step", [0, 1])
def test_accumulator_equals_the_reference_at_every_point(chain, step):
    x = alpha = 1
    for contributor, _ in SEEDS[: step + 1]:
        u = RP.secrets(contributor)["u"]
        x, alpha = x * u["x"] % R, alpha * u["alpha"] % R
    want = chain.judge.accumulator(x, alpha, step + 1)
    assert RP.acc_differing(chain.steps[step].answer, want) == []
    assert len(want["x_g1"]) == 31 and [len(r) for r in want["alpha_x_g1"]] == [18] * 4


def test_prepared_crs_equals_the_reference_at_every_point(chain):
    x = alpha = 1
    for contributor, _ in SEEDS:
        u = RP.secrets(contributor)["u"]
        x, alpha = x * u["x"] % R, alpha * u["alpha"] % R
    want = chain.judge.crs(x, chain.y, alpha)
    assert RC.differing(chain.crs, want) == []
    sizes = RC.family_sizes(chain.lib.params)
    assert {k: len(v) for k, v in chain.crs["families"].items()} == sizes
    # the second job judged alone builds on an accumulator the chain never reached
    alone = dict(accepted=True, pok=_pok(chain.steps[1].proof), acc=chain.steps[1].answer,
                 crs=chain.crs)
    flags = chain.judge.judge([(SEEDS[1][0], BEACON, alone)])
    assert flags["rejected"] == flags["pok_fail"] == 0 and flags["mismatch"] > 0


def test_an_update_left_as_it_was_is_refused_and_seen(chain):
    s = chain.steps[1]
    h = 5
    x_g1 = list(s.new.x_g1)
    x_g1[h] = s.prev.x_g1[h]
    handed = dataclasses.replace(s.new, x_g1=x_g1)
    loaded = M.Phase1Accumulator.from_json(handed.to_json(), CPU)  # every point is a valid point
    assert not s.prev.verify(loaded, s.proof, rng=np.random.default_rng(SEEDS[1][1]), device=CPU)
    x = alpha = 1
    for contributor, _ in SEEDS:
        u = RP.secrets(contributor)["u"]
        x, alpha = x * u["x"] % R, alpha * u["alpha"] % R
    bad = RP.acc_differing(Phase1Entry.acc_samples(chain.view, loaded),
                           chain.judge.accumulator(x, alpha, 2))
    assert bad == [("x_g1", h)]

"""Phase 1's and the prepare's spans and counters (`utils/timing`), on the CPU
at a small `zkbench.gen` library (n = 16).

One job of the close of phase 1 (a contribution, its JSON hand-over and
checked load, the coordinator's check, `phase2_prepare`), traced, gives the
named spans with their nesting and order; the counters equal the points,
lanes, windows and nonzeros they count, each worked out apart from the
program (the multiplier's lanes and gathering windows from its calls, seen
by a wrapper; the rest from the library's sizes); and the outputs are
byte-equal to the same seeded job untraced, which records nothing.
"""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu_torch.models import mpc_setup as M
from tokamak_zk_evm_tpu_torch.utils import timing
from zkbench import gen
from zkbench.entries import port
from zkbench.reference import ceremony as RC
from zkbench.reference import phase1 as RP

torch.set_num_threads(1)
CPU = torch.device("cpu")
LIB = dict(l=6, l_D=22, l_free=4, l_user=2, l_user_out=1, m_D=35, n=16, s_D=5, s_max=8)
Y = 0xBEEF12345

ROOTS = ["p1.contribute", "p1.load", "p1.verify", "p2.prepare"]
# each root's children, in order (the waits of its nested steps below them)
STEPS = {
    "p1.contribute": ["p1.hash", "p1.schnorr", "p1.mul", "p1.g2"],
    "p1.load": ["p1.parse", "p1.subgroup", "p1.parse"],
    "p2.prepare": ["prep.xy", "prep.lagrange", "prep.o_terms", "prep.o_points",
                   "prep.families", "prep.tx", "sync.prep.done"],
}
# span -> the spans it may sit under
UNDER = {
    "p1.hash": {"p1.contribute", "p1.verify"},
    "p1.schnorr": {"p1.contribute", "p1.verify"},
    "p1.mul": {"p1.contribute"},
    "sync.p1.mul": {"p1.mul"},
    "p1.g2": {"p1.contribute"},
    "p1.parse": {"p1.load"},
    "p1.subgroup": {"p1.load"},
    "sync.p1.subgroup": {"p1.subgroup"},
    "p1.rlc": {"p1.verify"},
    "p2.pairing": {"p1.schnorr", "p1.verify"},
    "sync.prep.xy": {"prep.xy"},
    "sync.prep.lagrange": {"prep.o_points"},
    "sync.prep.segments": {"prep.o_points"},
    "sync.prep.o_idx": {"prep.o_points"},
    "sync.prep.kl": {"prep.o_points"},
    "sync.prep.done": {"p2.prepare"},
}


def _job(lib, params):
    acc = M.Phase1Accumulator.initial(params)
    new, proof = acc.compute(np.random.default_rng(2**40 + 1), CPU)
    loaded = M.Phase1Accumulator.from_json(new.to_json(), CPU)
    ok = acc.verify(loaded, proof, rng=np.random.default_rng(2**40 + 2), device=CPU)
    sigma = M.phase2_prepare(loaded, Y, params, port.library(lib), port.infos(lib), CPU)
    return new, proof, ok, sigma


def _gathers(P, table, sidx, pidx) -> int:
    """The windows of one multiplication whose digit differs between scalars
    (a gather of each lane's table point): 4-bit windows where the table of
    16 multiples fits, from the top nonzero window of any scalar down."""
    w = 4 if int(P[0].shape[1]) * 16 <= M._WINDOW_POINTS else 1
    digits = [[(int(k) >> (w * i)) & ((1 << w) - 1) for k in table] for i in range(256 // w)]
    live = [i for i, row in enumerate(digits) if any(row)]
    return sum(len(set(digits[i])) > 1 for i in range(max(live) + 1)) if live else 0


@pytest.fixture(scope="module")
def runs():
    lib = gen.make_library(**LIB)
    params = port.params(lib)
    timing.enable()
    timing.disable()
    period = timing.snapshot().period
    plain = _job(lib, params)
    untraced = timing.snapshot()

    muls = []  # (lanes, gathering windows) of each multiplication, with the open root
    pairings = []
    mp = pytest.MonkeyPatch()
    real_mul = M._mul_jac

    def spy(P, table, sidx=None, pidx=None, tag=None):
        muls.append((tag, M._lanes(P, sidx, pidx), _gathers(P, table, sidx, pidx)))
        return real_mul(P, table, sidx, pidx, tag)

    mp.setattr(M, "_mul_jac", spy)
    real_pairing = M.multi_pairing
    mp.setattr(M, "multi_pairing", lambda a, b: pairings.append(len(a)) or real_pairing(a, b))
    try:
        with timing.tracing():
            traced = _job(lib, params)
    finally:
        mp.undo()
    return dict(lib=lib, plain=plain, traced=traced, snap=timing.snapshot(), untraced=untraced,
                period=period, muls=muls, pairings=pairings)


def test_untraced_run_records_nothing(runs):
    snap = runs["untraced"]
    assert snap.period == runs["period"] and snap.events == [] and snap.counts == {}


def test_outputs_byte_equal_to_untraced(runs):
    (new_a, proof_a, ok_a, sig_a), (new_b, proof_b, ok_b, sig_b) = runs["plain"], runs["traced"]
    assert ok_a is True and ok_b is True
    assert new_a.to_json() == new_b.to_json() and proof_a.to_json() == proof_b.to_json()
    for name in M._FAMILIES:
        for a, b in zip(getattr(sig_a.sigma_1, name), getattr(sig_b.sigma_1, name)):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    for k, v in vars(sig_a.sigma_1).items():
        if k not in M._FAMILIES:
            assert v == getattr(sig_b.sigma_1, k), k
    assert vars(sig_a.sigma_2) == vars(sig_b.sigma_2)
    assert (sig_a.G, sig_a.H, sig_a.lagrange_KL) == (sig_b.G, sig_b.H, sig_b.lagrange_KL)


def test_span_names_nesting_and_order(runs):
    snap = runs["snap"]
    assert snap.dropped == 0
    by_id = {e.id: e for e in snap.events}
    roots = sorted((e for e in snap.events if not e.parent), key=lambda e: e.t0)
    assert [e.name for e in roots] == ROOTS
    assert {e.category for e in roots} == {"ceremony"}
    parents = collections.defaultdict(set)
    for e in snap.events:
        if e.parent:
            up = by_id[e.parent]
            parents[e.name].add(up.name)
            assert up.t0 <= e.t0 <= e.t1 <= up.t1
    for name, ups in UNDER.items():
        assert parents[name] and parents[name] <= ups, (name, parents[name])
    for root in roots:
        kids = sorted((e for e in snap.events if e.parent == root.id), key=lambda e: e.t0)
        if root.name in STEPS:
            assert [e.name for e in kids] == STEPS[root.name], root.name
        assert all(a.t1 <= b.t0 for a, b in zip(kids, kids[1:]))
    # the check: its hash, the two Schnorr checks, then pairings and combinations
    verify = [e.name for e in sorted((e for e in snap.events if e.parent == roots[2].id),
                                     key=lambda e: e.t0)]
    assert verify[:3] == ["p1.hash", "p1.schnorr", "p1.schnorr"]
    assert set(verify[3:]) == {"p2.pairing", "p1.rlc"} and verify.count("p1.rlc") == 6
    # the MSMs' own spans and waits sit inside the combinations
    for e in snap.events:
        if e.name.startswith(("msm.", "sync.msm.")):
            up = by_id[e.parent]
            while up.name != "p1.rlc":
                assert up.name.startswith("msm."), (e.name, up.name)
                up = by_id[up.parent]


def test_counters_count_what_they_name(runs):
    lib, snap = runs["lib"], runs["snap"]
    totals = collections.Counter()
    for (_, name, _), k in snap.counts.items():
        totals[name] += k
    p = lib.params
    x_len, ax_len = RP.acc_sizes(p)
    powers = x_len + RP.N_ALPHA + RP.N_ALPHA * ax_len
    assert totals["p1.multiplied_points"] == powers
    assert totals["p1.checked_points"] == powers  # every G1 point of the loaded accumulator
    nonzeros = sum(len(col) for cols in lib.r1cs for side in cols for col in side.values())
    assert totals["prep.r1cs_nonzeros"] == nonzeros
    m_i = p["l_D"] - p["l"]
    assert totals["prep.lagrange_points"] == 2 * m_i + 3 * p["n"] + p["l_free"]
    assert totals["prep.out_points"] == sum(RC.family_sizes(p).values())
    tagged = [(lanes, g) for tag, lanes, g in runs["muls"] if tag == "prep"]
    assert len(tagged) == len([m for m in runs["muls"] if m[0]]) > 0
    assert totals["prep.mul_lanes"] == sum(lanes for lanes, _ in tagged)
    assert totals["prep.full_scalar_lanes"] == totals["prep.mul_lanes"] - nonzeros
    assert totals["prep.gathered_windows"] == sum(g for _, g in tagged) > 0
    names = collections.Counter(e.name for e in snap.events)
    assert totals["p2.pairings"] == len(runs["pairings"]) == names["p2.pairing"] == 15
    assert totals["host_syncs"] == sum(n for name, n in names.items() if name.startswith("sync."))

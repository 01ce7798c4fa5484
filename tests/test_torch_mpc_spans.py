"""The phase-2 ceremony's spans and counters (`utils/timing`), on the CPU at
the toy fixture's shape (the CRS `generate_sigma` makes from the fixed tau).

One contribution and the coordinator's check, traced, give the named spans
with their nesting; the counters equal the points, bytes, lanes and
pairings they count (B13's lanes: the calls of each kernel's entry times
their widths, seen by a wrapper); and the outputs are byte-equal to the same
seeded contribution and check untraced, which record nothing.
"""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu_torch.backend import kernels as K
from tokamak_zk_evm_tpu_torch.models import mpc_setup as M
from tokamak_zk_evm_tpu_torch.models.setup import Tau, generate_sigma
from tokamak_zk_evm_tpu_torch.testing.fixtures import build_fixture
from tokamak_zk_evm_tpu_torch.utils import timing

torch.set_num_threads(1)

# span -> the spans it may sit under
UNDER = {
    "p2.contribute": {None},
    "p2.verify": {None},
    "p2.hash": {"p2.contribute", "p2.verify"},
    "p2.schnorr": {"p2.contribute", "p2.verify"},
    "p2.rescale": {"p2.contribute"},
    "sync.p2.rescale": {"p2.contribute"},
    "p2.g2": {"p2.contribute"},
    "p2.equal": {"p2.verify"},
    "sync.p2.equal": {"p2.equal"},
    "p2.rlc": {"p2.verify"},
    "p2.pairing": {"p2.schnorr", "p2.verify"},
}
LANES = {"g1_add": "g1.add_lanes", "g1_dbl": "g1.dbl_lanes", "g1_to_affine": "g1.affine_lanes"}


def _link(sigma):
    """One seeded contribution and its check."""
    new, proof = M.phase2_contribute(sigma, np.random.default_rng(5))
    return new, proof, M.phase2_verify(sigma, new, proof, np.random.default_rng(6))


@pytest.fixture(scope="module")
def runs():
    fx = build_fixture()
    sigma = generate_sigma(fx.params, Tau.fixed(), fx.library, fx.infos, device="cpu")
    timing.enable()
    timing.disable()
    period = timing.snapshot().period
    plain = _link(sigma)
    untraced = timing.snapshot()

    calls = collections.Counter()  # kernel entry -> lanes of its calls
    pairings = []
    mp = pytest.MonkeyPatch()
    for name in LANES:
        def spy(p, *a, _fn=getattr(K, name), _name=name, **kw):
            calls[_name] += int(p[0].shape[1])
            return _fn(p, *a, **kw)
        mp.setattr(K, name, spy)
    real_pairing = M.multi_pairing
    mp.setattr(M, "multi_pairing", lambda a, b: pairings.append(len(a)) or real_pairing(a, b))
    try:
        with timing.tracing():
            traced = _link(sigma)
    finally:
        mp.undo()
    return dict(sigma=sigma, plain=plain, traced=traced, snap=timing.snapshot(),
                untraced=untraced, period=period, calls=calls, pairings=pairings)


def test_untraced_run_records_nothing(runs):
    snap = runs["untraced"]
    assert snap.period == runs["period"] and snap.events == [] and snap.counts == {}


def test_outputs_byte_equal_to_untraced(runs):
    (new_a, proof_a, ok_a), (new_b, proof_b, ok_b) = runs["plain"], runs["traced"]
    assert ok_a is True and ok_b is True
    assert proof_a.to_json() == proof_b.to_json()
    for name in M._FAMILIES:
        for a, b in zip(getattr(new_a.sigma_1, name), getattr(new_b.sigma_1, name)):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert vars(new_a.sigma_1).keys() == vars(new_b.sigma_1).keys()
    for k, v in vars(new_a.sigma_1).items():
        if k not in M._FAMILIES:
            assert v == getattr(new_b.sigma_1, k), k
    assert vars(new_a.sigma_2) == vars(new_b.sigma_2)
    assert M._sigma_hash(new_a) == M._sigma_hash(new_b)


def test_span_names_and_nesting(runs):
    snap = runs["snap"]
    assert snap.dropped == 0
    by_id = {e.id: e for e in snap.events}
    parents = collections.defaultdict(set)
    for e in snap.events:
        parents[e.name].add(by_id[e.parent].name if e.parent else None)
        if e.parent:
            up = by_id[e.parent]
            assert up.t0 <= e.t0 <= e.t1 <= up.t1
    for name, ups in UNDER.items():
        assert parents[name] and parents[name] <= ups, (name, parents[name])
    assert parents["p2.hash"] == {"p2.contribute", "p2.verify"}
    assert parents["p2.pairing"] == {"p2.schnorr", "p2.verify"}
    roots = [e for e in snap.events if not e.parent]
    assert [e.name for e in roots] == ["p2.contribute", "p2.verify"]
    assert {e.category for e in roots} == {"ceremony"}
    names = collections.Counter(e.name for e in snap.events)
    assert names["p2.hash"] == 2 and names["p2.schnorr"] == 4 and names["p2.g2"] == 1
    assert names["sync.p2.hash_pull"] == 0  # the CPU's tensors are hashed where they are
    assert names["p2.rescale"] == names["sync.p2.rescale"] == 1
    assert names["p2.equal"] == names["sync.p2.equal"] == 1
    assert names["p2.rlc"] == 6
    # the MSMs' own spans and waits sit inside the combinations
    for e in snap.events:
        if e.name.startswith(("msm.", "sync.msm.")):
            up = by_id[e.parent]
            while up.name != "p2.rlc":
                assert up.name.startswith("msm."), (e.name, up.name)
                up = by_id[up.parent]


def test_contribution_rescales_while_it_hashes(runs):
    """The contribution launches its rescaling before its hash and waits for
    it after its proofs: its steps, in order, and the check's hash first."""
    snap = runs["snap"]
    roots = {e.name: e for e in snap.events if not e.parent}
    steps = {name: sorted((e for e in snap.events if e.parent == root.id), key=lambda e: e.t0)
             for name, root in roots.items()}
    assert [e.name for e in steps["p2.contribute"]] == [
        "p2.rescale", "p2.hash", "p2.schnorr", "sync.p2.rescale", "p2.g2"]
    assert all(a.t1 <= b.t0 for a, b in zip(steps["p2.contribute"], steps["p2.contribute"][1:]))
    assert steps["p2.verify"][0].name == "p2.hash"


def test_counters_count_what_they_name(runs):
    sigma, snap = runs["sigma"], runs["snap"]
    totals = collections.Counter()
    for (_, name, _), k in snap.counts.items():
        totals[name] += k
    s1 = sigma.sigma_1
    fam_bytes = sum(c.numel() * c.element_size() for name in M._FAMILIES
                    for c in getattr(s1, name))
    assert totals["p2.hash_bytes"] == 2 * fam_bytes
    assert totals["p2.hash_staged_bytes"] == 0  # nothing goes through the card's pinned buffers
    rescaled = [int(getattr(s1, n)[2].numel()) for n in M._FAMILIES[1:]]
    small = [p for row in s1.delta_inv_alphak_xh_tx + [s1.delta_inv_alpha4_xj_tx]
             + s1.delta_inv_alphak_yi_ty for p in row]
    assert totals["p2.rescaled_points"] == sum(rescaled) + len(small) + 2
    live = sum(p is not None for p in small)
    assert totals["p2.rlc_points"] == 2 * (sum(rescaled) + live)
    names = collections.Counter(e.name for e in snap.events)
    assert totals["p2.pairings"] == len(runs["pairings"]) == names["p2.pairing"] == 14
    for fn, counter in LANES.items():
        assert runs["calls"][fn] > 0 and totals[counter] == runs["calls"][fn], fn
    assert totals["host_syncs"] == sum(n for name, n in names.items() if name.startswith("sync."))

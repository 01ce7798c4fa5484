"""The generator: determinism by seed, its counts, the published layout it
builds, and the constraints it promises."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from zkbench import gen, run
from zkbench.gen import R_MOD

# setupParams.json of the shipped library (v2.1.3), as the configurations hold it
FULL = json.load(open(os.path.join(run.ROOT, "zkbench", "configs", "s256-cli.json")))["library"]
SMALL = dict(l=12, l_D=76, l_free=8, l_user=4, l_user_out=2, m_D=172, n=64, s_D=7, s_max=16)
MIX = json.load(open(os.path.join(run.ROOT, "zkbench", "traffic", "full-tx.json")))


@pytest.fixture(scope="module")
def full_lib():
    return gen.make_library(**FULL)


def test_full_library_is_the_published_setup(full_lib):
    assert full_lib.params == dict(l=728, l_D=4824, l_free=128, l_user=85, l_user_out=65,
                                   m_D=26591, n=4096, s_D=14, s_max=256)
    assert len(full_lib.infos) == 14
    assert (full_lib.n_out, full_lib.n_in) == (167, 168)
    assert full_lib.n_priv[0] == 4096 - 167 - 1
    assert sum(full_lib.n_priv) == 26591 - 4824
    wires = [g for i in full_lib.infos for g in i["flattenMap"][0:1] + i["flattenMap"][1:]]
    iface = [g for g in wires if 728 <= g < 4824]
    assert len(iface) == len(set(iface)) <= 4096  # each interface wire has one owner
    assert sorted(g for g in wires if g >= 4824) == list(range(4824, 26591))


def test_public_layout_is_the_shipped_library(full_lib):
    want = {"bufferPubOut": ("Out_idx", 0, 65), "bufferPubIn": ("In_idx", 65, 85),
            "bufferBlockIn": ("In_idx", 85, 128), "bufferEVMIn": ("In_idx", 128, 728)}
    for kind, info in enumerate(full_lib.infos[:4]):
        side, lo, hi = want[info["name"]]
        start, cnt = info[side]
        assert info["id"] == kind and info["flattenMap"][start:start + cnt] == list(range(lo, hi))
    job = gen.make_job(full_lib, 218, gen.rng_for(3, 2, 0), heavy=tuple(MIX["heavy_share"]))
    assert (len(job.a_pub_user), len(job.a_pub_block), len(job.a_pub_function)) == (85, 43, 600)
    assert [sid for sid, _ in job.placements[:4]] == [0, 1, 2, 3]


def test_jobs_are_deterministic_by_seed_and_distinct(full_lib):
    def jobs(seed):
        return [gen.job(full_lib, 218 + i, seed, i, True, (5, 18)) for i in range(3)]

    a, b, c = jobs(2**31 + 7), jobs(2**31 + 7), jobs(2**31 + 8)
    key = [(j.placements, j.permutation, j.a_pub_user, j.a_pub_block, j.a_pub_function, j.mixer)
           for j in a]
    assert key == [(j.placements, j.permutation, j.a_pub_user, j.a_pub_block,
                    j.a_pub_function, j.mixer) for j in b]
    assert a[0].a_pub_user != c[0].a_pub_user
    assert len({tuple(j.a_pub_function) for j in a}) == 3
    assert gen.make_tau(gen.rng_for(-5, 0)) == gen.make_tau(gen.rng_for(-5, 0))


def test_placement_counts_are_the_same_for_every_seed_and_cover_the_range(full_lib):
    lo, hi = MIX["placements"]
    counts = [gen.placement_count(MIX, i) for i in range(2 * (hi - lo))]
    assert sorted(set(counts)) == list(range(lo, hi + 1))
    assert all(counts[i] + counts[i + 1] == lo + hi for i in range(0, len(counts), 2))
    with pytest.raises(ValueError):
        gen.placement_count({"placements": [218, 251]}, 0)
    job = gen.make_job(full_lib, 234, gen.rng_for(3, 2, 0), heavy=tuple(MIX["heavy_share"]))
    assert len(job.placements) == 234
    n_vars = sum(len(v) for _, v in job.placements)
    assert abs(n_vars - 658454) / 658454 < 0.002  # the documented transaction's variables


@pytest.mark.parametrize("n_placements", [5, 9, 16])
def test_constraints_and_copies_hold(n_placements):
    lib = gen.make_library(**SMALL)
    job = gen.make_job(lib, n_placements, gen.rng_for(11, 2, 0), heavy=(1, 3))
    assert len(job.placements) == n_placements
    for sid, var in job.placements:
        a, b, c = lib.r1cs[sid]
        assert len(var) == lib.infos[sid]["Nwires"] and var[0] == 1
        rows: dict = {}
        for m, cols in enumerate((a, b, c)):
            for wire, entries in cols.items():
                for k, coeff in entries:
                    rows.setdefault(k, [0, 0, 0])[m] += coeff * var[wire]
        assert max(rows) < lib.params["n"]
        assert all(x * y % R_MOD == z % R_MOD for x, y, z in rows.values())
    l = lib.params["l"]
    value, public = {}, {}
    for col, (sid, var) in enumerate(job.placements):
        for local, g in enumerate(lib.infos[sid]["flattenMap"]):
            if l <= g < lib.params["l_D"]:
                value[(g - l, col)] = var[local]
            elif g < l:
                public[g] = var[local]
    for r, c, x, y in job.permutation:
        assert value[(r, c)] == value[(x, y)]
    assert [public[g] for g in range(l)] == \
        job.a_pub_user + job.a_pub_block + job.a_pub_function


def test_chain_kinds_follow_the_heavy_share():
    lib = gen.make_library(**SMALL)
    kinds = gen.chain_kinds(lib, 18, (1, 3))
    assert kinds.count(0) == 6 and set(kinds[1:]) >= {1, 2}
    with pytest.raises(ValueError):
        gen.make_library(**dict(SMALL, m_D=SMALL["m_D"] + 10**4))
    assert np.mean([gen.placement_count({"placements": [2, 6]}, i) for i in range(6)]) == 4

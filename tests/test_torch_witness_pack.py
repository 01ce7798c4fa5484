"""One Montgomery table of a job's placement variables feeds b, u, v and w.

`models/witness.py` converts a job's placement variables once
(`witness_table`: one host bytes pass, one copy to the device, one K1
product by R^2 mod r) and gathers b, u, v and w from that table.  Here, on
the CPU, the grids it gives are held byte for byte to the four-pass
versions it replaced (kept below as the oracle: each pass packed its own
values through `_pack_mont_dedup`), on the toy fixture, on a small job of
the benchmark's generator and on variables at the edges of the field; and a
traced Prover converts every variable once and keeps no table.
"""

from __future__ import annotations

import collections
import gc
import weakref

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu_torch.fields import R_MOD
from tokamak_zk_evm_tpu_torch.models import witness as W
from tokamak_zk_evm_tpu_torch.models.protocol import Mixer, Placement
from tokamak_zk_evm_tpu_torch.models.prover import Prover
from tokamak_zk_evm_tpu_torch.models.setup import Tau, generate_sigma
from tokamak_zk_evm_tpu_torch.ops import field as F
from tokamak_zk_evm_tpu_torch.ops.poly import BiPoly
from tokamak_zk_evm_tpu_torch.testing.fixtures import build_fixture
from tokamak_zk_evm_tpu_torch.utils import timing

torch.set_num_threads(1)

# the benchmark generator's small library (zkbench/tests/test_zkbench_gen.py)
GEN_SMALL = dict(l=12, l_D=76, l_free=8, l_user=4, l_user_out=2, m_D=172, n=64, s_D=7,
                 s_max=16)


# ---------------------------------------------------------------------------
# The oracle: the four-pass versions, each packing its own values
# ---------------------------------------------------------------------------


def _old_pack_mont_dedup(vals) -> np.ndarray:
    arr = np.asarray([int(v) % R_MOD for v in vals], dtype=object)
    uniq, inv = np.unique(arr, return_inverse=True)
    packed = F.pack_fr(list(uniq))
    return packed[:, inv]


def old_gen_bXY(placements, infos, params, device) -> BiPoly:
    m_i, s_max, l, l_d = params.m_i, params.s_max, params.l, params.l_D
    rows, cols, vals = [], [], []
    for i, pl in enumerate(placements):
        fm = infos[pl.subcircuit_id].flattenMap
        if len(fm) != len(pl.variables):
            raise ValueError("corrupted placement variables")
        garr = np.asarray(fm, dtype=np.int64)
        varr = np.asarray(pl.variables, dtype=object)
        sel = (garr >= l) & (garr < l_d) & (varr != 0)
        rows.append(garr[sel] - l)
        cols.append(np.full(int(sel.sum()), i, np.int64))
        vals.extend(varr[sel].tolist())
    grid = np.zeros((F.FR_L, m_i, s_max), np.int32)
    if vals:
        grid[:, np.concatenate(rows), np.concatenate(cols)] = _old_pack_mont_dedup(vals)
    return BiPoly.from_rou_evals(F.tensor(grid, device))


def _old_qap_col_arrays(r1cs, which, device):
    W_, Kc, C = [], [], []
    for wire, col in getattr(r1cs, f"{which}_cols").items():
        for k, coeff in col:
            W_.append(wire)
            Kc.append(k)
            C.append(coeff)
    return (np.asarray(W_, np.int64), np.asarray(Kc, np.int64),
            F.tensor(_old_pack_mont_dedup(C), device) if C else None)


def old_gen_qap_xy(placements, library, params, which, device) -> BiPoly:
    n, s_max = params.n, params.s_max
    by_kind: dict[int, list[int]] = {}
    for i, pl in enumerate(placements):
        by_kind.setdefault(pl.subcircuit_id, []).append(i)
    acc = torch.zeros((F.FR_L, n * s_max), dtype=torch.int64, device=device)
    for sid, idxs in sorted(by_kind.items()):
        W_, Kc, C_mont = _old_qap_col_arrays(library[sid], which, device)
        if C_mont is None:
            continue
        T = W_.shape[0]
        vals = []
        for i in idxs:
            varr = np.asarray(placements[i].variables, dtype=object)
            vals.extend(varr[W_].tolist())
        packed = _old_pack_mont_dedup(vals).reshape(F.FR_L, len(idxs), T)
        prod = F.fr_mul(F.tensor(packed, device), C_mont)
        flat = (Kc[None, :] * s_max + np.asarray(idxs, np.int64)[:, None]).reshape(-1)
        acc.index_add_(1, torch.as_tensor(flat, device=device),
                       prod.reshape(F.FR_L, -1).to(torch.int64))
    grid = W._reduce_u32_grid(acc & 0xFFFFFFFF).reshape(F.FR_L, n, s_max)
    return BiPoly.from_rou_evals(grid)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def _gen_job(n_placements: int):
    """(placements, infos, library, params) of one small generator job."""
    from zkbench import gen
    from zkbench.entries import port

    lib = gen.make_library(**GEN_SMALL)
    job = gen.make_job(lib, n_placements, gen.rng_for(2**40 + 7, 2, 0), heavy=(1, 3))
    placements = port.job_inputs(job)[0]
    return placements, port.infos(lib), port.library(lib), port.params(lib)


def _edges(fx_inputs):
    """The toy fixture with every variable but each placement's first
    replaced, in turn, by 0, 1, r - 1, r, r + 5, 2^256 - 1, 2^300 + 3, -1,
    -r - 3 and a random one: values at or above r and negative ones reduce
    mod r, as each pass did."""
    placements, infos, library, params = fx_inputs
    rng = np.random.default_rng(5)
    edge = [0, 1, R_MOD - 1, R_MOD, R_MOD + 5, 2**256 - 1, 2**300 + 3, -1, -R_MOD - 3]
    out, t = [], 0
    for pl in placements:
        vs = [pl.variables[0]]
        for _ in pl.variables[1:]:
            k = t % (len(edge) + 1)
            vs.append(edge[k] if k < len(edge) else int.from_bytes(rng.bytes(40), "little"))
            t += 1
        out.append(Placement(pl.subcircuit_id, vs))
    return out, infos, library, params


def _toy():
    fx = build_fixture()
    return fx.placements, fx.infos, fx.library, fx.params


INPUTS = {
    "toy": _toy,
    "gen9": lambda: _gen_job(9),
    "gen16": lambda: _gen_job(16),
    "edges": lambda: _edges(_toy()),
    "gen9_edges": lambda: _edges(_gen_job(9)),
}


@pytest.fixture(scope="module", params=sorted(INPUTS))
def inputs(request):
    return INPUTS[request.param]()


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def test_the_table_is_every_variable_in_montgomery_form(inputs):
    placements = inputs[0]
    table = W.witness_table(placements, "cpu")
    flat = [v % R_MOD for pl in placements for v in pl.variables]
    assert table.mont.dtype == torch.int32 and table.mont.shape == (F.FR_L, len(flat))
    assert np.array_equal(table.mont.numpy(), F.pack_fr(flat))
    assert list(table.lengths) == [len(pl.variables) for pl in placements]
    starts = np.cumsum(table.lengths) - table.lengths
    assert table.index.tolist() == [list(table.order), list(starts[table.order])]
    for sid, sl in table.kinds.items():
        assert sorted(table.order[sl]) == [i for i, pl in enumerate(placements)
                                           if pl.subcircuit_id == sid]


@pytest.mark.parametrize("poly", ["bXY", "uXY", "vXY", "wXY"])
def test_grids_equal_the_four_pass_versions(inputs, poly):
    placements, infos, library, params = inputs
    table = W.witness_table(placements, "cpu")
    if poly == "bXY":
        want = old_gen_bXY(placements, infos, params, "cpu")
        shared = W.gen_bXY(infos, params, table)
    else:
        which = {"uXY": "A", "vXY": "B", "wXY": "C"}[poly]
        want = old_gen_qap_xy(placements, library, params, which, "cpu")
        shared = getattr(W, f"gen_{poly}")(library, params, table)
    assert torch.equal(shared.coeffs, want.coeffs)


def test_corrupted_placement_raises():
    placements, infos, library, params = _toy()
    bad = [Placement(pl.subcircuit_id, list(pl.variables)) for pl in placements]
    bad[1].variables.append(7)
    with pytest.raises(ValueError, match="corrupted placement variables"):
        W.gen_bXY(infos, params, W.witness_table(bad, "cpu"))
    bad[1].variables[-2:] = []
    with pytest.raises(ValueError, match="shorter than their subcircuit's wires"):
        W.gen_uXY(library, params, W.witness_table(bad, "cpu"))


@pytest.fixture(scope="module")
def toy_sigma():
    fx = build_fixture()
    return fx, generate_sigma(fx.params, Tau.fixed(), fx.library, fx.infos, device="cpu")


def _prover(toy_sigma):
    fx, sigma = toy_sigma
    return Prover(fx.params, sigma, fx.library, fx.infos, fx.placements, fx.permutation,
                  fx.instance, mixer=Mixer.zero(), device="cpu")


def test_a_traced_job_converts_every_variable_once(toy_sigma):
    fx = toy_sigma[0]
    with timing.tracing():
        pr = _prover(toy_sigma)
    snap = timing.snapshot()
    totals = collections.Counter()
    for (proof, name, _), k in snap.counts.items():
        if name == "witness.vars_converted":
            assert proof == pr.proof_id
            totals[name] += k
    assert totals["witness.vars_converted"] == sum(len(pl.variables) for pl in fx.placements)
    by_id = {e.id: e for e in snap.events}
    converts = [e for e in snap.events if e.name == "witness.convert"]
    assert len(converts) == 1 and by_id[converts[0].parent].name == "init.witness"


def test_the_prover_keeps_no_table(toy_sigma, monkeypatch):
    made = []
    build = W.witness_table

    def spy(placements, device):
        table = build(placements, device)
        made.append((weakref.ref(table), weakref.ref(table.mont)))
        return table

    monkeypatch.setattr(W, "witness_table", spy)
    pr = _prover(toy_sigma)
    gc.collect()
    assert len(made) == 1
    assert all(ref() is None for ref in made[0])
    assert not any(isinstance(v, W.WitnessTable) for v in vars(pr).values())

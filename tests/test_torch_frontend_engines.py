"""The port's witness engines and host oracle against the JAX package's.

* `host/reference.py`: `dft`, `idft`, `bi_dft`, `bi_idft` and
  `poly_eval_xy` on random inputs at n <= 16, with cosets; the port's
  `ops/ntt` on the CPU agrees with the port's oracle.
* `models/witness_solver.solve_r1cs_witness` and
  `frontend/r1cs_eval.compile_subcircuit(...).evaluate` on every placement
  of `build_fixture()` and of `build_synthetic()` at the bench's small rung,
  each package on the library it read back from the files
  `io/artifacts.save_library` wrote: equal to each other and to the
  fixture's placement variables.
* `check_r1cs_satisfaction` true on the fixtures and false with one wire
  changed; `WitnessGenerator`'s solver engine equal to the JAX one, and
  its failure on outputs that disagree the JAX one's.  (`UncompilableR1CS`
  is held in `test_torch_frontend_wasm.py`, beside the calculator for the
  R1CS that raises it.)

Inputs come from numpy seeds.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from tokamak_zk_evm_tpu.frontend import r1cs_eval as JR
from tokamak_zk_evm_tpu.frontend import witness_gen as JWG
from tokamak_zk_evm_tpu.host import reference as JRef
from tokamak_zk_evm_tpu.io import artifacts as JA
from tokamak_zk_evm_tpu.models import witness_solver as JS
from tokamak_zk_evm_tpu.testing import real_fixture as JRF
from tokamak_zk_evm_tpu_torch.fields import R_MOD, fr_root_of_unity
from tokamak_zk_evm_tpu_torch.frontend import r1cs_eval as TR
from tokamak_zk_evm_tpu_torch.frontend import witness_gen as TWG
from tokamak_zk_evm_tpu_torch.host import reference as TRef
from tokamak_zk_evm_tpu_torch.io import artifacts as TA
from tokamak_zk_evm_tpu_torch.models import witness_solver as TS
from tokamak_zk_evm_tpu_torch.ops import field as F
from tokamak_zk_evm_tpu_torch.ops import ntt as TN
from tokamak_zk_evm_tpu_torch.testing import real_fixture as TRF
from tokamak_zk_evm_tpu_torch.testing.fixtures import build_fixture
from tokamak_zk_evm_tpu_torch.testing.synthetic import build_synthetic

torch.set_num_threads(1)

# bench.py's small rung
SMALL = dict(n=256, s_max=32, m_i=256, n_synth_kinds=2, priv_per_synth=120)


def rand_fr(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(n)]


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("coset", [1, 7])
def test_oracle_dft_matches_jax(n, coset):
    rng = np.random.default_rng(100 + n + coset)
    coeffs = rand_fr(rng, n)
    evals = TRef.dft(coeffs, coset)
    assert evals == JRef.dft(coeffs, coset)
    assert TRef.idft(evals, coset) == JRef.idft(evals, coset) == coeffs


@pytest.mark.parametrize("shape", [(2, 4), (8, 2), (4, 16)])
@pytest.mark.parametrize("cosets", [(1, 1), (5, 3)])
def test_oracle_bivariate_matches_jax(shape, cosets):
    rng = np.random.default_rng(shape[0] * 31 + shape[1] + cosets[0])
    grid = [rand_fr(rng, shape[1]) for _ in range(shape[0])]
    evals = TRef.bi_dft(grid, *cosets)
    assert evals == JRef.bi_dft(grid, *cosets)
    assert TRef.bi_idft(evals, *cosets) == JRef.bi_idft(evals, *cosets) == grid
    x, y = rand_fr(rng, 2)
    assert TRef.poly_eval_xy(grid, x, y) == JRef.poly_eval_xy(grid, x, y)
    # evals[a][b] is the polynomial at (cx w_x^a, cy w_y^b)
    wx, wy = fr_root_of_unity(shape[0]), fr_root_of_unity(shape[1])
    assert evals[1][1] == TRef.poly_eval_xy(grid, cosets[0] * wx % R_MOD, cosets[1] * wy % R_MOD)


@pytest.mark.parametrize("shape", [(1, 16), (4, 8), (8, 4)])
@pytest.mark.parametrize("coset", [None, 7])
def test_port_ntt_matches_port_oracle(shape, coset):
    rng = np.random.default_rng(7 * shape[0] + shape[1])
    grid = [rand_fr(rng, shape[1]) for _ in range(shape[0])]
    t = F.tensor(F.pack_fr(grid), "cpu")
    rows = F.unpack_fr(TN.ntt_batched(t, coset=coset).numpy())
    assert [list(r) for r in rows] == [TRef.dft(r, coset or 1) for r in grid]
    back = F.unpack_fr(TN.ntt_batched(TN.ntt_batched(t, coset=coset), inverse=True,
                                      coset=coset).numpy())
    assert [list(r) for r in back] == grid
    if shape[0] > 1:
        bi = F.unpack_fr(TN.bintt(t, coset_x=coset, coset_y=coset).numpy())
        assert [list(r) for r in bi] == TRef.bi_dft(grid, coset or 1, coset or 1)


@pytest.fixture(scope="module", params=["toy", "small"])
def staged(request, tmp_path_factory):
    """(fixture, the library as each package reads it back from disk)."""
    fx = build_fixture() if request.param == "toy" else build_synthetic(**SMALL)
    lib = str(tmp_path_factory.mktemp(f"frontend_{request.param}"))
    TA.save_library(lib, fx.params, fx.infos, fx.library)
    return fx, TA.load_library(lib), JA.load_library(lib)


def _inputs(p, info):
    i0, ic = info.In_idx
    return p.variables[i0:i0 + ic]


def test_solver_and_schedule_match_jax_on_the_fixtures(staged):
    fx, (_, t_infos, t_lib), (_, j_infos, j_lib) = staged
    for p in fx.placements:
        ti, ji = t_infos[p.subcircuit_id], j_infos[p.subcircuit_id]
        known = {0: 1}
        known.update({ti.In_idx[0] + k: v for k, v in enumerate(_inputs(p, ti))})
        t_w = TS.solve_r1cs_witness(t_lib[ti.id], ti.Nwires, dict(known))
        assert t_w == JS.solve_r1cs_witness(j_lib[ji.id], ji.Nwires, dict(known))
        assert t_w == p.variables
        t_c = TR.compile_subcircuit(t_lib[ti.id], ti).evaluate(_inputs(p, ti))
        assert t_c == JR.compile_subcircuit(j_lib[ji.id], ji).evaluate(_inputs(p, ji))
        assert t_c == p.variables


def test_r1cs_satisfaction_matches_jax(staged):
    fx, (_, _, t_lib), (_, _, j_lib) = staged
    for p in fx.placements:
        r_t, r_j = t_lib[p.subcircuit_id], j_lib[p.subcircuit_id]
        assert TRF.check_r1cs_satisfaction(r_t, p.variables) is True
        assert JRF.check_r1cs_satisfaction(r_j, p.variables) is True
        bad = list(p.variables)
        bad[-1] = (bad[-1] + 1) % R_MOD
        assert TRF.check_r1cs_satisfaction(r_t, bad) is False
        assert JRF.check_r1cs_satisfaction(r_j, bad) is False


def test_witness_generator_solver_engine_matches_jax(staged):
    fx, (_, t_infos, t_lib), (_, j_infos, j_lib) = staged
    tg = TWG.WitnessGenerator(None, t_infos, t_lib)
    jg = JWG.WitnessGenerator(None, j_infos, j_lib)
    for p in fx.placements:
        ins = _inputs(p, t_infos[p.subcircuit_id])
        assert not tg.has_exact(p.subcircuit_id)
        assert tg.witness(p.subcircuit_id, ins) == jg.witness(p.subcircuit_id, ins) \
            == p.variables
    # outputs that disagree with the inputs: the solver's own full check
    # refuses them, in both packages alike (fresh generators: the cache is
    # keyed by the inputs alone)
    p = fx.placements[-1]
    info = t_infos[p.subcircuit_id]
    o0, oc = info.Out_idx
    outs = list(p.variables[o0:o0 + oc])
    outs[0] = (outs[0] + 1) % R_MOD
    errs = []
    for gen, exc in ((TWG.WitnessGenerator(None, t_infos, t_lib), TS.UnsolvableR1CS),
                     (JWG.WitnessGenerator(None, j_infos, j_lib), JS.UnsolvableR1CS)):
        with pytest.raises(exc) as e:
            gen.witness(p.subcircuit_id, _inputs(p, info), out_values=outs)
        errs.append(str(e.value))
    assert errs[0] == errs[1]

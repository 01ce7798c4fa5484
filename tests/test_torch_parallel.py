"""The port's multi-device path vs the JAX package, on gloo groups of 2 and 4
spawned CPU ranks (mirrors tests/test_parallel.py's cases).

One spawn a world size runs every case of that size (`torch_parallel_workers`,
JAX blocked in the ranks); the tests below read the results and compare
them with the JAX package's unsharded ops on the same numpy-seeded inputs,
computed here.  Tolerance: exact limbs and exact points everywhere.  Each
case that claims the sharded path ran also requires the dist counters
(`parallel.mesh.COUNTS`) above zero: a mesh of one rank, or a grid that
does not divide, would take the local path and prove nothing.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from tokamak_zk_evm_tpu.fields import R_MOD
from tokamak_zk_evm_tpu.host import curve as C
from tokamak_zk_evm_tpu.ops import curve as cv
from tokamak_zk_evm_tpu.ops import field as F
from tokamak_zk_evm_tpu.ops import msm as msm_mod
from tokamak_zk_evm_tpu.ops import ntt as ntt_mod

torch.set_num_threads(1)


def rand_grid(x_size, y_size, seed):
    rng = np.random.default_rng(seed)
    ints = [[int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(y_size)]
            for _ in range(x_size)]
    return np.asarray(F.pack_fr(ints)).astype(np.uint32)


def msm_inputs(n, seed, plant=True):
    rng = np.random.default_rng(seed)
    pts = [C.g1_scalar_mul_affine(C.G1.gen, int.from_bytes(rng.bytes(16), "little"))
           for _ in range(n)]
    scalars = [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(n)]
    if plant:
        pts[3] = None
        scalars[4] = 0
        pts[7], scalars[7] = None, 0
    px, py, pinf = (np.asarray(a) for a in cv.pack_affine(pts))
    s = np.asarray(msm_mod.scalars_from_ints(scalars))
    return (s, px, py, pinf), scalars, pts


GRID = rand_grid(16, 8, 1)
GRID_EV = np.asarray(ntt_mod.bintt(jnp.asarray(GRID))).astype(np.uint32)
COSET = (7, 5)
MSM_64 = msm_inputs(64, 2)
MSM_63 = msm_inputs(63, 3)  # pads to a multiple of 2 and of 4


def cases(world):
    c = [("bintt_fwd", "case_bintt_dist", (GRID, False)),
         ("bintt_inv", "case_bintt_dist", (GRID_EV, True)),
         ("coset_fwd", "case_bintt_coset", (GRID, False) + COSET),
         ("coset_inv", "case_bintt_coset", (GRID_EV, True) + COSET),
         ("msm", "case_msm", MSM_64[0]),
         ("msm_pad", "case_msm", MSM_63[0] + (False, False)),
         ("global_mesh", "case_global_mesh", ()),
         ("submesh", "case_bintt_submesh", (GRID,))]
    if world == 2:
        c += [("prove", "case_prove", ()),
              ("mixers", "case_mixers", (True,))]
    if world == 4:
        c += [("bintt_2d", "case_bintt_dist", (GRID, False, True)),
              ("bintt_2d_inv", "case_bintt_dist", (GRID_EV, True, True)),
              ("msm_2d", "case_msm", MSM_64[0] + (True,)),
              ("mixers", "case_mixers", (False,))]
    return c


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [rank results]}, each world spawned once, on first use."""
    done = {}

    def get(world):
        if world not in done:
            done[world] = W.run_ranks(world, cases(world),
                                      str(tmp_path_factory.mktemp(f"gloo{world}")))
        return done[world]

    return get


def result(ranks, world, key):
    """Every rank's result of case `key` (raising with the rank's traceback
    when it failed)."""
    out = []
    for r, res in enumerate(ranks(world)):
        assert "_init" not in res, res["_init"][1]
        status, value = res[key]
        assert status == "ok", f"rank {r}: {value}"
        out.append(value)
    return out


def u32(a):
    return np.asarray(a).astype(np.uint32)


@pytest.mark.parametrize("world", [2, 4])
def test_bintt_dist_matches_jax(ranks, world):
    for r, res in enumerate(result(ranks, world, "bintt_fwd")):
        assert np.array_equal(u32(res["direct"]), GRID_EV), f"rank {r}"
        assert np.array_equal(u32(res["ops"]), GRID_EV), f"rank {r}"
        assert res["counts"]["bintt_dist"] == 2  # direct, then the mesh branch of bintt
        assert res["counts"]["staged_bytes"] == 0  # CPU tensors: nothing staged
    for r, res in enumerate(result(ranks, world, "bintt_inv")):
        assert np.array_equal(u32(res["direct"]), GRID), f"rank {r}"
        assert np.array_equal(u32(res["ops"]), GRID), f"rank {r}"


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("world", [2, 4])
def test_bintt_cosets_through_mesh_branch(ranks, world, inverse):
    src = GRID_EV if inverse else GRID
    want = u32(ntt_mod.bintt(jnp.asarray(src), inverse=inverse, coset_x=COSET[0],
                             coset_y=COSET[1]))
    for r, res in enumerate(result(ranks, world, "coset_inv" if inverse else "coset_fwd")):
        assert np.array_equal(u32(res["out"]), want), f"rank {r}"
        assert res["counts"]["bintt_dist"] == 1


@pytest.mark.parametrize("world", [2, 4])
def test_msm_dist_matches_jax_and_oracle(ranks, world):
    (s, px, py, pinf), scalars, pts = MSM_64
    want = C.G1.msm_affine(scalars, pts)
    assert msm_mod.msm(*(jnp.asarray(a) for a in (s, px, py, pinf))) == want
    for r, res in enumerate(result(ranks, world, "msm")):
        assert res["direct"] == want and res["ops"] == want, f"rank {r}"
        assert res["counts"]["msm_dist"] == 2


@pytest.mark.parametrize("world", [2, 4])
def test_msm_padding_to_mesh_size(ranks, world):
    """63 points (infinities and zero scalars planted) do not divide by the
    mesh: ops.msm pads with zero scalars on infinities."""
    (s, px, py, pinf), scalars, pts = MSM_63
    want = C.G1.msm_affine(scalars, pts)
    assert msm_mod.msm(*(jnp.asarray(a) for a in (s, px, py, pinf))) == want
    for r, res in enumerate(result(ranks, world, "msm_pad")):
        assert res["ops"] == want, f"rank {r}"
        assert res["counts"]["msm_dist"] == 1


def test_bintt_dist_2d_mesh(ranks):
    for r, res in enumerate(result(ranks, 4, "bintt_2d")):
        assert res["axis_names"] == ("hosts", "chips") and res["shape"] == (2, 2)
        assert np.array_equal(u32(res["direct"]), GRID_EV), f"rank {r}"
        assert np.array_equal(u32(res["ops"]), GRID_EV), f"rank {r}"
        assert res["counts"]["bintt_dist"] == 2
    for r, res in enumerate(result(ranks, 4, "bintt_2d_inv")):
        assert np.array_equal(u32(res["direct"]), GRID), f"rank {r}"


def test_msm_dist_2d_mesh(ranks):
    (s, px, py, pinf), scalars, pts = MSM_64
    want = C.G1.msm_affine(scalars, pts)
    for r, res in enumerate(result(ranks, 4, "msm_2d")):
        assert res["direct"] == want and res["ops"] == want, f"rank {r}"
        assert res["counts"]["msm_dist"] == 2


def test_submesh_of_first_two_ranks(ranks):
    got = result(ranks, 4, "submesh")
    assert np.array_equal(u32(got[0]), GRID_EV) and np.array_equal(u32(got[1]), GRID_EV)
    assert got[2] is None and got[3] is None


def test_multihost_init_noop_single_process(monkeypatch):
    import torch.distributed as dist

    from tokamak_zk_evm_tpu_torch.parallel import mesh as PM
    from tokamak_zk_evm_tpu_torch.parallel import multihost

    for k in ("TZK_COORDINATOR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.init_from_env(device="cpu") is False
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        multihost.global_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        PM.make_mesh_2d(2, 2, device="cpu")


@pytest.mark.parametrize("world", [2, 4])
def test_global_mesh_axis_names(ranks, world):
    for res in result(ranks, world, "global_mesh"):
        assert res["init"] is True  # the group exists: a no-op, more than one process
        assert res["one_d"] == (("chips",), (world,), "gloo")
        assert res["two_d"] == (("hosts", "chips"), (1, world))


def test_full_prove_under_mesh_matches_jax_golden(ranks):
    """The toy fixture's five-round prove on 2 ranks under `use_mesh`: both
    ranks' proofs are the JAX package's unsharded proof (the golden digest
    pinned in tests/test_golden_proof.py, the port's copy in
    testing/fixtures.py, to which the port's unsharded proof also hashes:
    tests/test_torch_prover.py), and verify."""
    from tokamak_zk_evm_tpu_torch.testing.fixtures import GOLDEN_PROOF_SHA256 as GOLDEN

    got = result(ranks, 2, "prove")
    n, s_max, m_i = got[0]["params"]
    assert n % 2 == 0 and s_max % 2 == 0 and m_i % 2 == 0  # the grids split across 2 ranks
    for r, res in enumerate(got):
        assert hashlib.sha256(res["proof"]).hexdigest() == GOLDEN, f"rank {r}"
        assert res["verifies"] is True, f"rank {r}"
        assert res["counts"]["bintt_dist"] > 0 and res["counts"]["msm_dist"] > 0, res["counts"]
    assert got[0]["proof"] == got[1]["proof"]


@pytest.mark.parametrize("world", [2, 4])
def test_mismatched_mixers_raise(ranks, world):
    for r, msg in enumerate(result(ranks, world, "mixers")):
        assert msg is not None and "different mixers" in msg, f"rank {r}: {msg}"


@pytest.mark.slow
def test_bintt_dist_full_shape(tmp_path):
    """The sharded transform at the prover's largest domain (16384 x 512 =
    2^23) on 2 ranks vs the JAX package's local transform."""
    rng = np.random.default_rng(5)
    x_size, y_size = 16384, 512
    raw = rng.integers(0, 1 << 16, (16, x_size, y_size), dtype=np.uint32)
    grid = F.fr_mul(jnp.asarray(raw).reshape(16, -1),
                    jnp.asarray(F.fr_mont(1))).reshape(16, x_size, y_size)
    grid = np.asarray(grid).astype(np.uint32)
    want = u32(ntt_mod.bintt(jnp.asarray(grid)))
    res = W.run_ranks(2, [("g", "case_bintt_dist", (grid, False))], str(tmp_path), 3600)
    for r, out in enumerate(res):
        status, value = out["g"]
        assert status == "ok", value
        assert np.array_equal(u32(value["direct"]), want), f"rank {r}"


@pytest.mark.slow
def test_msm_dist_large(tmp_path):
    """Points-split MSM at 2^16 on 4 ranks against the O(1) oracle
    (sum k_i (c_i G) == (sum k_i c_i) G)."""
    N = 1 << 16
    rng = np.random.default_rng(6)
    cs = [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(N)]
    fam = tuple(np.asarray(a) for a in msm_mod.fixed_base_msm_points(cs, C.G1.gen))
    ks = [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(N)]
    s = np.asarray(msm_mod.scalars_from_ints(ks))
    want = C.g1_scalar_mul_affine(C.G1.gen, sum(k * c for k, c in zip(ks, cs)) % R_MOD)
    res = W.run_ranks(4, [("m", "case_msm", (s,) + fam)], str(tmp_path), 3600)
    for r, out in enumerate(res):
        status, value = out["m"]
        assert status == "ok", value
        assert value["direct"] == want and value["ops"] == want, f"rank {r}"

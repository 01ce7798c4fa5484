"""Rank processes for tests/test_torch_parallel.py.

`run_ranks` spawns `world` processes (the spawn context) that join one gloo
group through a FileStore and run a list of cases, each a function of this
module, on the CPU; every rank sends back {case: ("ok", result) or
("error", traceback)}.  The ranks block `jax` (and the JAX package) in
`sys.modules` before they import the port, so nothing here may need them;
the JAX reference values are computed by the parent.
"""

from __future__ import annotations

import os
import queue as queue_mod
import sys
import time
import traceback
from datetime import timedelta

import numpy as np


def _t(a):
    import torch

    return torch.as_tensor(np.ascontiguousarray(a).astype(np.int32))


def _dist_counts():
    from tokamak_zk_evm_tpu_torch.parallel import mesh as PM

    return PM.counts()


# -- cases: each runs on every rank ------------------------------------------


def case_bintt_dist(grid, inverse, two_d=False):
    """`bintt_dist` from this rank's rows; then `ops.ntt.bintt` under the
    mesh (the same transform through the mesh branch)."""
    from tokamak_zk_evm_tpu_torch.ops import ntt as NT
    from tokamak_zk_evm_tpu_torch.parallel import context, ntt_dist
    from tokamak_zk_evm_tpu_torch.parallel.mesh import (
        make_mesh, make_mesh_2d, reset_counts, row_slice)

    mesh = make_mesh_2d(2, 2, device="cpu") if two_d else make_mesh(device="cpu")
    g = _t(grid)
    reset_counts()
    direct = ntt_dist.bintt_dist(g[:, row_slice(mesh, g.shape[1])], mesh, inverse)
    with context.use_mesh(mesh):
        via_ops = NT.bintt(g, inverse=inverse)
    return {"direct": direct.numpy(), "ops": via_ops.numpy(), "counts": _dist_counts(),
            "axis_names": mesh.axis_names, "shape": mesh.shape}


def case_bintt_coset(grid, inverse, cx, cy):
    """`ops.ntt.bintt` with cosets under the mesh."""
    from tokamak_zk_evm_tpu_torch.ops import ntt as NT
    from tokamak_zk_evm_tpu_torch.parallel import context
    from tokamak_zk_evm_tpu_torch.parallel.mesh import make_mesh, reset_counts

    mesh = make_mesh(device="cpu")
    reset_counts()
    with context.use_mesh(mesh):
        out = NT.bintt(_t(grid), inverse=inverse, coset_x=cx, coset_y=cy)
    return {"out": out.numpy(), "counts": _dist_counts()}


def case_bintt_submesh(grid):
    """`bintt_dist` on a mesh of the first two ranks of the group; the
    other ranks get no mesh and call nothing."""
    from tokamak_zk_evm_tpu_torch.parallel import ntt_dist
    from tokamak_zk_evm_tpu_torch.parallel.mesh import make_mesh, row_slice

    mesh = make_mesh(2, device="cpu")
    if mesh is None:
        return None
    g = _t(grid)
    return ntt_dist.bintt_dist(g[:, row_slice(mesh, g.shape[1])], mesh).numpy()


def case_msm(scalars, px, py, pinf, core="pippenger", two_d=False, direct=True):
    """`msm_dist` on the whole mesh (when the count divides), and
    `ops.msm.msm` under the mesh (padding), on MSM core `core`."""
    from tokamak_zk_evm_tpu_torch.ops import msm as TM
    from tokamak_zk_evm_tpu_torch.parallel import context, msm_dist
    from tokamak_zk_evm_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d, reset_counts

    mesh = make_mesh_2d(2, 2, device="cpu") if two_d else make_mesh(device="cpu")
    args = (_t(scalars), _t(px), _t(py), _t(pinf))
    reset_counts()
    out = {}
    with TM.use_core(core):
        if direct:
            out["direct"] = msm_dist.msm_dist(*args, mesh)
        with context.use_mesh(mesh):
            out["ops"] = TM.msm(*args)
    out["counts"] = _dist_counts()
    return out


def case_global_mesh():
    """`init_from_env` is a no-op once a group exists; the global meshes'
    axis names and shapes."""
    from tokamak_zk_evm_tpu_torch.parallel import multihost

    m1 = multihost.global_mesh(device="cpu")
    m2 = multihost.global_mesh(two_d=True, device="cpu")
    return {"init": multihost.init_from_env(device="cpu"),
            "one_d": (m1.axis_names, m1.shape, m1.backend),
            "two_d": (m2.axis_names, m2.shape)}


_SIGMA = {}


def _toy():
    from tokamak_zk_evm_tpu_torch.models.setup import Tau, generate_sigma
    from tokamak_zk_evm_tpu_torch.testing.fixtures import build_fixture

    if not _SIGMA:
        fx = build_fixture()
        _SIGMA["fx"] = fx
        _SIGMA["sigma"] = generate_sigma(fx.params, Tau.fixed(), fx.library, fx.infos,
                                         device="cpu")
    return _SIGMA["fx"], _SIGMA["sigma"]


def case_prove():
    """The toy fixture's whole prove under the mesh (Mixer.zero()), then
    verify: -> the proof's canonical bytes, the verdict and the counters."""
    from tokamak_zk_evm_tpu_torch.io.artifacts import canonical_proof_bytes
    from tokamak_zk_evm_tpu_torch.models.preprocess import preprocess
    from tokamak_zk_evm_tpu_torch.models.protocol import Mixer
    from tokamak_zk_evm_tpu_torch.models.prover import Prover
    from tokamak_zk_evm_tpu_torch.models.verifier import Verifier
    from tokamak_zk_evm_tpu_torch.parallel import context
    from tokamak_zk_evm_tpu_torch.parallel.mesh import make_mesh, reset_counts

    fx, sigma = _toy()
    mesh = make_mesh(device="cpu")
    reset_counts()
    with context.use_mesh(mesh):
        proof, _ = Prover(fx.params, sigma, fx.library, fx.infos, fx.placements,
                          fx.permutation, fx.instance, mixer=Mixer.zero(),
                          device="cpu").prove()
    counts = _dist_counts()
    pre = preprocess(sigma, fx.permutation, fx.instance, fx.params, device="cpu")
    ok = Verifier(fx.params, sigma, pre, fx.instance, proof, rng=np.random.default_rng(7),
                  device="cpu").verify_snark()
    return {"proof": canonical_proof_bytes(proof), "verifies": ok, "counts": counts,
            "params": (fx.params.n, fx.params.s_max, fx.params.l_D - fx.params.l)}


def case_mixers(build_prover):
    """Each rank draws its own mixer (rng seeded by its rank) under the
    mesh: -> the error raised, or None.  `build_prover`: through
    `Prover(...)` (toy fixture), else the check alone."""
    import torch.distributed as dist

    from tokamak_zk_evm_tpu_torch.models import prover as PV
    from tokamak_zk_evm_tpu_torch.models.protocol import Mixer
    from tokamak_zk_evm_tpu_torch.parallel import context
    from tokamak_zk_evm_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    mixer = Mixer.random(np.random.default_rng(dist.get_rank()))
    with context.use_mesh(mesh):
        PV._check_mixer(Mixer.zero())  # the same everywhere: passes
        try:
            if build_prover:
                fx, sigma = _toy()
                PV.Prover(fx.params, sigma, fx.library, fx.infos, fx.placements,
                          fx.permutation, fx.instance, mixer=mixer, device="cpu")
            else:
                PV._check_mixer(mixer)
        except ValueError as e:
            return str(e)
    return None


# -- the rank processes --------------------------------------------------------


def rank_main(rank: int, world: int, store: str, cases: list, out) -> None:
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None
    sys.modules["tokamak_zk_evm_tpu"] = None
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    results = {}
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world, timeout=timedelta(seconds=90))
        for key, fn, args in cases:
            try:
                results[key] = ("ok", globals()[fn](*args))
            except Exception:  # reported to the parent, which fails the case
                results[key] = ("error", traceback.format_exc()[-3000:])
        dist.destroy_process_group()
    except Exception:
        results["_init"] = ("error", traceback.format_exc()[-3000:])
    assert not any(m == "jax" or m.startswith(("jax.", "tokamak_zk_evm_tpu."))
                   for m, v in sys.modules.items() if v is not None)
    out.put((rank, results))


def run_ranks(world: int, cases: list, tmp_dir: str, timeout: float = 420.0) -> list[dict]:
    """Run `cases` ([(key, function name, args)]) on `world` spawned gloo
    ranks; -> each rank's results, in rank order.  Raises if a rank dies,
    or if they have not all reported within `timeout` seconds (the ranks
    are then killed)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(tmp_dir, "store")
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    try:
        procs = [ctx.Process(target=rank_main, args=(r, world, store, cases, out))
                 for r in range(world)]
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world - len(got)} of {world} ranks did not report "
                                   f"within {timeout:.0f} s")
            try:
                rank, res = out.get(timeout=1.0)
                got[rank] = res
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank exited with code {dead[0]} before reporting")
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    return [got[r] for r in range(world)]

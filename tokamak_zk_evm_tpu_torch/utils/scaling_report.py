"""One device against N for the sharded bivariate NTT and MSM: the port's
counterpart of the JAX package's `scripts/scaling_report.py`, on the
`torch.distributed` mesh of `parallel/`.

Run from the repository root:

    SCALE_PLATFORM=cpu VIRT_DEVICES=4 python -m tokamak_zk_evm_tpu_torch.utils.scaling_report
        N gloo ranks on the CPU, spawned here, one thread each: they share
        the host's cores, so N-rank efficiency is capped at cores / N, and
        `efficiency_vs_host_ceiling` divides by that cap;
    python -m tokamak_zk_evm_tpu_torch.utils.scaling_report
        on the card, one NCCL rank (raises without a card);
    torchrun --nproc-per-node 4 -m tokamak_zk_evm_tpu_torch.utils.scaling_report
        one NCCL rank a card.

`--out` names the file (default `.cache/torch_scaling_report.json`; the
root `scaling_report.json` is the JAX package's).  The grid is 16384 x 512,
the prover's 2^23 domain, and the MSM 2^SCALE_MSM_LOG2 points (default 18),
as in the JAX report.  Writes the report and prints it as one JSON line.

Rows have the JAX report's form, `op`, `n_devices`, `seconds`, `efficiency`
(t_1 / (t_N N)) and, on N > 1 rows, `efficiency_vs_host_ceiling`, and one
key of their own, `sharded`: False for the unsharded op on one rank (the base
of every efficiency), True for `ntt_dist.bintt_dist` / `msm_dist.msm_dist`
on a mesh of N ranks, N in 1, 2, 4, 8 up to the world size.  The one-rank
sharded rows price the dist path itself: on a machine with one card they
are cost figures, not scaling ones.  Every row is checked, and a mismatch
raises: `bintt_dist` against `bintt` and its inverse back to the grid, each
MSM against the O(1) oracle (sum k_i c_i) G.  A row's `seconds` is its
slowest rank's mean.
"""

from __future__ import annotations

import argparse
import json
import os
import queue as queue_mod
import sys
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..fields import R_MOD
from ..host.curve import G1
from ..ops import field as F
from ..ops import msm as TM
from ..ops import ntt as NT
from ..parallel import mesh as PM
from ..parallel import msm_dist, ntt_dist
from .device import describe, resolve_device, synchronize

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(_REPO, ".cache", "torch_scaling_report.json")
MESH_SIZES = (1, 2, 4, 8)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def reduced_grid(x_size: int, y_size: int, seed: int, device) -> torch.Tensor:
    """[16, x, y] Fr values: random 16-bit limbs Montgomery-multiplied by
    R mod r, so every value is reduced."""
    raw = np.random.default_rng(seed).integers(0, 1 << 16, (F.FR_L, x_size * y_size),
                                               dtype=np.int32)
    return F.fr_mul(F.tensor(raw, device), F.fr_mont(1)).reshape(F.FR_L, x_size, y_size)


def _canonical_fr(rng, n: int) -> np.ndarray:
    """[16, n] limbs of seeded values below r (the top limb below r's)."""
    lim = rng.integers(0, 1 << 16, (F.FR_L, n), dtype=np.int64)
    lim[F.FR_L - 1] = rng.integers(0, R_MOD >> (16 * (F.FR_L - 1)), n)
    return lim.astype(np.int32)


def _limb_dot(a: np.ndarray, b: np.ndarray) -> int:
    """sum_i a_i b_i over [16, n] limb columns, exactly (n < 2^30 keeps each
    limb-pair sum below 2^62)."""
    a64, b64 = a.astype(np.int64), b.astype(np.int64)
    return sum(int(a64[i] @ b64[j]) << (16 * (i + j))
               for i in range(F.FR_L) for j in range(F.FR_L))


def oracle_msm_inputs(n: int, seed: int, device):
    """n points c_i G (`ops.msm.fixed_base_msm_points`) and scalars k_i,
    both seeded canonical Fr values, and the MSM's O(1) oracle
    (sum k_i c_i) G.  -> (scalars [16, n], px, py, pinf, host affine point)."""
    if n >= 1 << 30:
        raise ValueError(f"oracle_msm_inputs: {n} points overflow the limb sums")
    rng = np.random.default_rng(seed)
    c, k = _canonical_fr(rng, n), _canonical_fr(rng, n)
    px, py, pinf = TM.fixed_base_msm_points(F.tensor(c, device), G1.gen, device)
    total = _limb_dot(k, c) % R_MOD
    want = G1.to_affine(G1.scalar_mul(G1.from_affine(G1.gen), total))
    return F.tensor(k, device), px, py, pinf, want


def _seconds(fn, dev, iters: int):
    """(mean seconds of `iters` calls after one untimed call, the last output)."""
    out = fn()
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    synchronize(dev)
    return (time.perf_counter() - t0) / iters, out


def _slowest(t: float, dev) -> float:
    """The largest `t` over the ranks of the default group."""
    where = dev if dist.get_backend() == "nccl" else "cpu"
    x = torch.tensor([t], dtype=torch.float64, device=where)
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return float(x.item())


def _barrier(dev) -> None:
    if dist.get_backend() == "nccl":  # on this rank's card, named
        dist.barrier(device_ids=[dev.index if dev.index is not None
                                 else torch.cuda.current_device()])
    else:
        dist.barrier()


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"scaling report: {what}")


def _row(op: str, n: int, seconds: float, sharded: bool, base: float, dev) -> dict:
    row = {"op": op, "n_devices": n, "seconds": seconds, "sharded": sharded,
           "efficiency": base / (seconds * n)}
    if n > 1:
        cap = min(n, os.cpu_count() or 1) / n if dev.type == "cpu" else 1.0
        row["efficiency_vs_host_ceiling"] = row["efficiency"] / cap
    if dist.get_rank() == 0:
        log(f"{op} {n}-dev{' sharded' if sharded else ''}: {seconds * 1e3:.3f} ms "
            f"(efficiency {row['efficiency']:.3f})")
    return row


def _rows_for(op: str, dev, iters: int, local, sharded, check) -> list[dict]:
    """The unsharded row (rank 0 alone, the others waiting), then a sharded
    row a mesh size; `sharded(mesh)` runs the dist op on this rank's mesh,
    `check(out, mesh)` holds its output."""
    world = dist.get_world_size()
    _barrier(dev)
    base = 0.0
    if dist.get_rank() == 0:
        base, out = _seconds(local, dev, iters)
        check(out, None)
    base = _slowest(base, dev)
    rows = [_row(op, 1, base, False, base, dev)]
    for n in (m for m in MESH_SIZES if m <= world):
        mesh = PM.make_mesh(n, device=dev)
        _barrier(dev)
        t = 0.0
        if mesh is not None:
            t, out = _seconds(lambda: sharded(mesh), dev, iters)
            check(out, mesh)
        rows.append(_row(op, n, _slowest(t, dev), True, base, dev))
    return rows


def measure(x_size: int = 16384, y_size: int = 512, msm_log2: int = 18, device=None,
            seed: int = 0, iters: int = 3) -> dict:
    """The report, on every rank of the default process group (collective);
    `device` is this rank's device (default: its card)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: see the module docstring for how to run")
    dev = PM.make_mesh(device=device).device
    PM.reset_counts()

    grid = reduced_grid(x_size, y_size, seed, dev)
    want = NT.bintt(grid)

    def check_grid(out, mesh):
        if mesh is None:  # `want` is this very op's output
            return
        _check(torch.equal(out, want),
               f"bintt_dist {x_size} x {y_size} on {mesh.size} rank(s) != bintt")
        back = ntt_dist.bintt_dist(out[:, PM.row_slice(mesh, x_size)], mesh, inverse=True)
        _check(torch.equal(back, grid),
               f"inverse bintt_dist on {mesh.size} rank(s) does not give the grid back")

    rows = _rows_for(f"bintt_{x_size}x{y_size}", dev, iters, lambda: NT.bintt(grid),
                     lambda mesh: ntt_dist.bintt_dist(grid[:, PM.row_slice(mesh, x_size)], mesh),
                     check_grid)
    del grid, want

    n = 1 << msm_log2
    k, px, py, pinf, point = oracle_msm_inputs(n, seed + 1, dev)

    def check_point(out, mesh):
        where = f"msm_dist on {mesh.size} rank(s)" if mesh else "the unsharded MSM"
        _check(out == point, f"{where} of 2^{msm_log2} points != (sum k_i c_i) G")

    rows += _rows_for(f"msm_2^{msm_log2}", dev, 1, lambda: TM.msm(k, px, py, pinf),
                      lambda mesh: msm_dist.msm_dist(k, px, py, pinf, mesh), check_point)
    world, cores = dist.get_world_size(), os.cpu_count()
    if dev.type == "cpu":
        note = (f"gloo ranks on the CPU share the host's {cores} cores, one thread a rank: "
                "N-rank efficiency is capped at cores/N; efficiency_vs_host_ceiling "
                "normalizes by that cap")
    else:
        note = (f"one {dist.get_backend()} rank a card, {world} here"
                + (": one rank, so the sharded rows price the dist path (cost, not scaling)"
                   if world == 1 else ""))
    return {"platform": dev.type, "device": describe(dev), "backend": dist.get_backend(),
            "world": world, "host_cpu_cores": cores, "note": note,
            "dist_calls": PM.counts(), "rows": rows}


def _scratch() -> str:
    cache = os.path.join(_REPO, ".cache")
    os.makedirs(cache, exist_ok=True)
    return tempfile.mkdtemp(prefix="scaling_report_", dir=cache)


def _cpu_rank(rank: int, world: int, store: str, sizes: dict, out) -> None:
    """One spawned gloo rank on the CPU: the report, sent to the parent."""
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world, timeout=timedelta(seconds=900))
        try:
            res = measure(device="cpu", **sizes)
        finally:
            dist.destroy_process_group()
        out.put((rank, "ok", res if rank == 0 else None))
    except Exception:  # reported to the parent, which raises
        out.put((rank, "error", traceback.format_exc()[-3000:]))


def run_cpu_ranks(world: int, timeout: float = 900.0, **sizes) -> dict:
    """The report on `world` spawned gloo ranks on the CPU (`sizes`: the
    arguments of `measure`).  Raises if a rank fails, dies or has not
    reported within `timeout` seconds (the ranks are then killed)."""
    import shutil

    import torch.multiprocessing as mp

    from . import scaling_report as this  # the spawned ranks import it by name

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = _scratch()
    procs = [ctx.Process(target=this._cpu_rank,
                         args=(r, world, os.path.join(tmp, "store"), sizes, out))
             for r in range(world)]
    got = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world - len(got)} of {world} ranks silent after "
                                   f"{timeout:.0f} s")
            try:
                rank, status, res = out.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank exited with code {dead[0]} before reporting")
                continue
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{res}")
            got[rank] = res
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    return got[0]


def run_on_cards(**sizes) -> dict | None:
    """The report on NCCL ranks: torchrun's (or TZK_COORDINATOR's) group,
    else this process alone as a one-rank group.  -> the report on rank 0,
    None on the others."""
    import shutil

    from ..parallel import multihost

    owned, tmp = not dist.is_initialized(), None
    if owned:
        multihost.init_from_env()
    if not dist.is_initialized():  # no launcher: this process alone
        resolve_device("cuda")
        tmp = _scratch()
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
    try:
        report = measure(**sizes)
        return report if dist.get_rank() == 0 else None
    finally:
        if owned:
            dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    msm_log2 = int(os.environ.get("SCALE_MSM_LOG2", "18"))
    if os.environ.get("SCALE_PLATFORM") == "cpu":
        report = run_cpu_ranks(int(os.environ.get("VIRT_DEVICES", "8")), msm_log2=msm_log2)
    else:
        report = run_on_cards(msm_log2=msm_log2)
        if report is None:
            return 0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

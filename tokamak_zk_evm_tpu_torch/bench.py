"""Headline benchmark of the port: the prove wall clock, with the contract
of the repository's `bench.py`.  Run from the repository root:

    python -m tokamak_zk_evm_tpu_torch.bench

Prints ONE JSON line on stdout per completed rung, {"metric", "value",
"unit", "vs_baseline", "detail"}; diagnostics on stderr.  Without
TOKAMAK_BENCH_SCALE it runs the ladder: each rung in a child process, its
line banked as the rung ends (the last parseable line wins), ascending
small -> mid -> full, or full first when the warm marker in the cache
matches the compute path's sources (its CRS is cached and its kernels are
built).

Rungs:
  small, mid  `bench.py`'s synthetic shapes, seed 1;
  full        `build_synthetic()` at its defaults (n=4096, s_max=256,
              m_i=4096, m_D=20424, seed 0), the shape of `chip_smoke.py`'s
              main path and of `testing/synthetic.FULLSHAPE_PROOF_SHA256`.
              `bench.py`'s full rung proves the 14-subcircuit qap-compiler
              library (`testing/real_fixture.py`), which the repository
              does not ship;
  real        that rung (n=4096, s_max=256), run only when
              TOKAMAK_BENCH_SCALE=real asks for it: it needs a library that
              `io/subcircuit_library` resolves, and fails with the
              resolver's error without one.

`vs_baseline` is BASELINE_CUDA_S / value on the real rung (the reference
Rust/ICICLE prover's CUDA prove of that circuit) and 0.0 on the others,
whose circuit is not the one that figure was measured on.

The timed region is `Prover(...)` construction and `prove()` (init counts),
between two `torch.cuda.synchronize()` calls on the card.  The CRS
(generated, or loaded from the cache) and the untimed warm-up prove (which
also takes the first-use nvcc builds and library loads) stay outside it.
`detail.spans` sums `utils/timing` spans by category over the timed
region, traced with `timing.tracing()` (each nested span counted once):
host-clock spans, each ending when its Python returns, not when the card
finishes what it queued.  `detail.launches` counts each kernel's
launches in the timed region (all zero on the CPU, where the wrappers take
the plain versions), and `detail.host_usage` this process's CPU seconds and
garbage collections over it.

Environment knobs:
  TOKAMAK_BENCH_SCALE=small|mid|full|real  one rung, in this process
  TOKAMAK_BENCH_VERIFY=1       preprocess and verify_snark() after the timed
                               region; a proof that does not verify exits
                               non-zero
  TOKAMAK_BENCH_BUDGET_S=N     the ladder's budget (default 2700)
  TOKAMAK_BENCH_DEVICE=cuda|cpu  default cuda; without a card the bench
                               raises, it never drops to the CPU
  TOKAMAK_BENCH_PEROP=0        skip the per-op probes (every rung but small)
  TOKAMAK_BENCH_WARMUP=0       skip the untimed warm-up prove
  TOKAMAK_BENCH_CACHE=DIR      the CRS, fixture and warm-marker cache
                               (default .cache/torch_bench/, never the JAX
                               bench's .cache/ paths: its pickles hold the
                               JAX package's classes)

`bench.py`'s TZK_RELEASE_BINDING_FAMILIES (the JAX prover's release of
binding families to fit a 16 GB device) and its JAX compile-cache variables
have no counterpart here: the port's Prover has no such switch, and
`backend/build.py` keeps the nvcc builds in `tokamak_zk_evm_tpu_torch/build/`.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .utils.device import describe, resolve_device, synchronize


def log(*a):
    print(*a, file=sys.stderr, flush=True)


BASELINE_CUDA_S = 21.082

SHAPES = {
    "full": dict(kind="synthetic", n=4096, s_max=256, m_i=4096, n_synth_kinds=6,
                 priv_per_synth=2700, seed=0),
    "mid": dict(kind="synthetic", n=1024, s_max=64, m_i=1024,
                n_synth_kinds=4, priv_per_synth=700),
    "small": dict(kind="synthetic", n=256, s_max=32, m_i=256,
                  n_synth_kinds=2, priv_per_synth=120),
    "real": dict(kind="real", n=4096, s_max=256),
}
LADDER = ("small", "mid", "full")

_PKG = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_PKG)


def cache_root() -> str:
    return os.environ.get("TOKAMAK_BENCH_CACHE") or os.path.join(_REPO, ".cache", "torch_bench")


def warm_marker() -> str:
    return os.path.join(cache_root(), "full_warm")


def crs_dir(scale: str) -> str:
    shape = SHAPES[scale]
    return os.path.join(cache_root(),
                        f"crs_{scale}_{shape['kind']}_{shape['n']}_{shape['s_max']}")


def fixture_path(s_max: int) -> str:
    return os.path.join(cache_root(), f"fixture_real_{s_max}.pkl")


def metric_name(scale: str, shape: dict) -> str:
    lib = "real_library" if shape["kind"] == "real" else "synthetic"
    return f"prove_wall_clock_{scale}_{lib}_n{shape['n']}_smax{shape['s_max']}"


def code_state_digest() -> str:
    """Digest of the compute path's sources, the kernels' CUDA sources
    included: an edit there changes what nvcc builds.  Frontend and test
    edits leave the warm marker valid."""
    h = hashlib.sha256()
    files = [os.path.join(_PKG, "fields.py")]
    for d in ("ops", "backend", "parallel", "models", "utils"):
        for dirpath, dirs, fs in os.walk(os.path.join(_PKG, d)):
            dirs.sort()
            files += [os.path.join(dirpath, f) for f in sorted(fs)
                      if f.endswith((".py", ".cu", ".cuh"))]
    for p in files:
        h.update(os.path.relpath(p, _PKG).encode())
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def full_is_warm() -> bool:
    try:
        with open(warm_marker()) as f:
            return f.read().strip() == code_state_digest()
    except OSError:
        return False


def mark_full_warm():
    os.makedirs(cache_root(), exist_ok=True)
    with open(warm_marker(), "w") as f:
        f.write(code_state_digest())


def run_ladder() -> int:
    """Bank each completed rung's JSON line at once (the last parseable
    line wins, so the best completed rung does; the order puts the most
    valuable rung first when its caches are warm)."""
    budget = float(os.environ.get("TOKAMAK_BENCH_BUDGET_S", "2700"))
    deadline = time.time() + budget
    if full_is_warm():
        order = ("full", "mid", "small")
        caps = {"full": None, "mid": 900.0, "small": 600.0}
        log("[bench] ladder: full rung is WARM -> running full first")
    else:
        order = LADDER
        caps = {"small": 900.0, "mid": 1500.0, "full": None}
        log("[bench] ladder: no warm marker -> ascending")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (_REPO, os.environ.get("PYTHONPATH")) if p))
    banked = 0
    for scale in order:
        remaining = deadline - time.time()
        if remaining < 60:
            log(f"[bench] ladder: {remaining:.0f}s left; stopping")
            break
        rung_budget = remaining if caps[scale] is None else min(remaining, caps[scale])
        log(f"[bench] ladder: scale={scale} (budget {rung_budget:.0f}s)")
        t0 = time.time()
        try:
            p = subprocess.run([sys.executable, "-m", __spec__.name], stdout=subprocess.PIPE,
                               timeout=rung_budget, cwd=_REPO,
                               env=dict(env, TOKAMAK_BENCH_SCALE=scale))
        except subprocess.TimeoutExpired:
            log(f"[bench] ladder: scale={scale} timed out after {time.time() - t0:.0f}s")
            continue  # smaller rungs may still fit the remaining budget
        out = p.stdout.decode().strip().splitlines()
        line = next((ln for ln in reversed(out) if ln.startswith("{")), None)
        if p.returncode == 0 and line:
            print(line, flush=True)  # bank it NOW
            banked += 1
            log(f"[bench] ladder: scale={scale} banked in {time.time() - t0:.0f}s")
            if scale == "full":
                break  # headline banked; smaller rungs add nothing
        else:
            log(f"[bench] ladder: scale={scale} rc={p.returncode}")
    return 0 if banked else 1


def measure_per_op(dev, msm_log2: int = 22, grid=(4096, 2048)) -> dict:
    """Per-op probes, each timed after an untimed run: one MSM of 2^22
    points c_i G (the whole op, its host combine included) held to the
    O(1) oracle (sum k_i c_i) G, and one bivariate NTT of a 4096 x 2048
    grid of reduced values (2^23 points) held to its inverse; a probe
    that fails raises.  `scaling.mesh_efficiency` is the report of
    `utils/scaling_report.py`, where it has been written."""
    from .ops import msm as TM
    from .ops import ntt as NT
    from .utils import scaling_report as SR

    detail, scaling = {}, {}
    n = 1 << msm_log2
    k, px, py, pinf, want = SR.oracle_msm_inputs(n, 5, dev)
    for run in ("untimed", "timed"):
        synchronize(dev)
        t0 = time.perf_counter()
        got = TM.msm(k, px, py, pinf)  # the point comes back to the host: synchronous
        msm_s = time.perf_counter() - t0
        if got != want:
            raise RuntimeError(f"per-op probe: the {run} MSM of 2^{msm_log2} points "
                               "!= (sum k_i c_i) G")
    del k, px, py, pinf
    detail[f"msm_2p{msm_log2}_s"] = msm_s
    detail[f"msm_2p{msm_log2}_oracle"] = True
    scaling[f"msm_2p{msm_log2}_points_per_s"] = round(n / msm_s)
    log(f"[bench] per-op: 2^{msm_log2} MSM = {msm_s:.4f}s, == (sum k_i c_i) G")

    x, y = grid
    log_n = (x * y).bit_length() - 1
    a = SR.reduced_grid(x, y, 6, dev)
    NT.bintt(a)
    synchronize(dev)
    t0 = time.perf_counter()
    r = NT.bintt(a)
    synchronize(dev)
    ntt_s = time.perf_counter() - t0
    if not torch.equal(NT.bintt(r, inverse=True), a):
        raise RuntimeError(f"per-op probe: the inverse of the {x} x {y} biNTT is not its input")
    detail[f"bintt_2p{log_n}_s"] = ntt_s
    # radix-2 along both axes: N/2 * log2(N) butterflies
    scaling[f"bintt_2p{log_n}_butterflies_per_s"] = round((x * y // 2) * log_n / ntt_s)
    log(f"[bench] per-op: 2^{log_n} biNTT = {ntt_s:.4f}s")

    try:
        with open(SR.DEFAULT_OUT) as f:
            scaling["mesh_efficiency"] = json.load(f)
    except FileNotFoundError:
        pass
    detail["scaling"] = scaling
    return detail


def build_shape(scale):
    shape = SHAPES[scale]
    if shape["kind"] == "real":
        import pickle

        from .testing.real_fixture import build_real_tx_fixture

        # the placements' exact WASM witnesses take minutes: cache the built
        # fixture (deterministic: a seeded PRNG and the resolved library)
        cpath = fixture_path(shape["s_max"])
        if os.path.exists(cpath):
            with open(cpath, "rb") as f:
                return pickle.load(f)
        fx = build_real_tx_fixture(s_max=shape["s_max"])
        try:
            os.makedirs(os.path.dirname(cpath), exist_ok=True)
            with open(cpath, "wb") as f:
                pickle.dump(fx, f)
        except OSError as e:
            log(f"[bench] fixture cache failed: {e}")
        return fx
    from .testing.synthetic import build_synthetic

    args = {k: v for k, v in shape.items() if k != "kind"}
    args.setdefault("seed", 1)
    return build_synthetic(**args)


def host_usage() -> dict:
    """This process's CPU seconds and garbage collections: CPU seconds near
    the wall clock mean the host work ran without waiting for a core."""
    import gc
    import resource

    r = resource.getrusage(resource.RUSAGE_SELF)
    gens = gc.get_stats()
    return {"user_s": r.ru_utime, "sys_s": r.ru_stime,
            "gc_collections": sum(g["collections"] for g in gens),
            "gc_full_collections": gens[-1]["collections"]}


def _since(before: dict) -> dict:
    return {k: round(v - before[k], 3) for k, v in host_usage().items()}


def run_rung(scale: str, dev) -> dict:
    """One rung on `dev`: fixture, CRS, warm-up prove, timed prove, then the
    optional verify and probes.  -> the rung's JSON line as a dict."""
    from .backend import kernels as K
    from .io import crs as crs_io
    from .io.artifacts import canonical_proof_bytes
    from .models.protocol import Mixer
    from .models.prover import Prover
    from .models.setup import Tau, generate_sigma
    from .utils import timing

    t_start = time.time()
    shape = SHAPES[scale]
    log(f"[bench] building {shape['kind']} fixture for scale={scale} on {dev} ...")
    t0 = time.time()
    fx = build_shape(scale)
    log(f"[bench] fixture built in {time.time() - t0:.1f}s; placements={len(fx.placements)} "
        f"perm={len(fx.permutation)} params={fx.params}")

    # ---- setup (cached on disk, outside the prove measurement) ----
    cache_dir = crs_dir(scale)
    crs_load_s = None
    if os.path.exists(os.path.join(cache_dir, "sigma_meta.json")):
        log(f"[bench] loading cached CRS from {cache_dir}")
        t0 = time.time()
        sigma = crs_io.load_sigma(cache_dir, dev)
        synchronize(dev)
        crs_load_s = round(time.time() - t0, 3)
        log(f"[bench] CRS loaded in {crs_load_s}s")
    else:
        log("[bench] generating CRS (fixed tau) ...")
        t0 = time.time()
        sigma = generate_sigma(fx.params, Tau.fixed(), fx.library, fx.infos, device=dev)
        synchronize(dev)
        log(f"[bench] CRS generated in {time.time() - t0:.1f}s")
        try:
            crs_io.save_sigma(sigma, cache_dir)
            log(f"[bench] CRS cached to {cache_dir}")
        except OSError as e:  # the cache is best-effort
            log(f"[bench] CRS cache failed: {e}")

    def prover():
        return Prover(fx.params, sigma, fx.library, fx.infos, fx.placements, fx.permutation,
                      fx.instance, mixer=Mixer.zero(), device=dev)

    # ---- warm-up prove (first-use builds and loads; the reference excludes them) ----
    if os.environ.get("TOKAMAK_BENCH_WARMUP", "1") == "1":
        log("[bench] warm-up prove ...")
        before = host_usage()
        t0 = time.time()
        with timing.tracing():
            prover().prove()
            synchronize(dev)
        log(f"[bench] warm-up done in {time.time() - t0:.1f}s; spans by_name "
            f"{json.dumps({k: round(v, 3) for k, v in timing.summarize()['by_name'].items()})}; "
            f"host {json.dumps(_since(before))}")

    # ---- timed prove ----
    log("[bench] timed prove ...")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    synchronize(dev)
    before = host_usage()
    K.reset_counts()
    with timing.tracing():
        t0 = time.perf_counter()
        proof, _ = prover().prove()
        synchronize(dev)
        prove_s = time.perf_counter() - t0
    launches = K.counts()
    summ = timing.summarize()
    detail = {"spans": {k: round(v, 3) for k, v in summ["by_category"].items()},
              "launches": launches, "host_usage": _since(before),
              "device": describe(dev),
              "proof_sha256": hashlib.sha256(canonical_proof_bytes(proof)).hexdigest()}
    if dev.type == "cuda":
        detail["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    log(f"[bench] prove took {prove_s:.3f}s (total script {time.time() - t_start:.0f}s)")
    log(f"[bench] spans by_category: {json.dumps(detail['spans'])}; "
        f"host {json.dumps(detail['host_usage'])}; launches {json.dumps(launches)}")
    log(f"[bench] spans by_name: "
        f"{json.dumps({k: round(v, 3) for k, v in summ['by_name'].items()})}")
    if scale == "full":
        mark_full_warm()

    if os.environ.get("TOKAMAK_BENCH_VERIFY", "0") == "1":
        from .models.preprocess import preprocess
        from .models.verifier import Verifier

        pre = preprocess(sigma, fx.permutation, fx.instance, fx.params, device=dev)
        ok = Verifier(fx.params, sigma, pre, fx.instance, proof,
                      rng=np.random.default_rng(7), device=dev).verify_snark()
        log(f"[bench] verify_snark: {ok}")
        if not ok:
            raise SystemExit("proof did not verify")
        detail["verify_snark"] = True

    if crs_load_s is not None:
        detail["crs_load_s"] = crs_load_s
    if os.environ.get("TOKAMAK_BENCH_PEROP", "1") == "1" and scale != "small":
        detail.update(measure_per_op(dev))

    return {
        "metric": metric_name(scale, shape),
        "value": round(prove_s, 3),
        "unit": "s",
        "vs_baseline": round(BASELINE_CUDA_S / prove_s, 3) if shape["kind"] == "real" else 0.0,
        "detail": detail,
    }


def main():
    dev = resolve_device(os.environ.get("TOKAMAK_BENCH_DEVICE") or None)
    scale = os.environ.get("TOKAMAK_BENCH_SCALE")
    if scale is None:
        raise SystemExit(run_ladder())
    if scale not in SHAPES:
        raise SystemExit(f"TOKAMAK_BENCH_SCALE={scale!r}: one of {sorted(SHAPES)}")
    print(json.dumps(run_rung(scale, dev)), flush=True)


if __name__ == "__main__":
    main()

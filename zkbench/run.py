"""Run one cell of `BENCHMARK.json` and print its result as one JSON line.

    python3 -m zkbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell names a configuration
(`configs/<name>.json`: its library sizes and its entry adapter,
`entries/<entry>.py`) and a traffic mix (`traffic/<name>.json`).  Set-up
draws the library and tau from the seed, builds what the entry needs, proves
one warm-up job of the mix's largest size twice (the first proof builds the
kernels in a fresh checkout, the second sets the pace), and makes from the
seed as many jobs as the window can use at that pace, with a margin.  The window then proves them back
to back (one in flight) and closes at the first completion after
`--seconds`.
After it, the plain reference (`reference/check.py`) judges a sample of the
window's proofs, drawn from the seed.  `--trace 0` prints the cell's
end-to-end metrics; `--trace 1` runs the same window with spans, op
counters and the device profiler on, and prints the per-layer metrics
(`metrics/<name>.py`) with the device's busy seconds and a breakdown.
Everything but the last line of standard output goes to standard error.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import shutil
import sys
import tempfile
import time

import torch

from . import gen
from .isolation import forbidden_modules
from .reference.check import Reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# knobs of the program that change what it runs; a run fixes them
PROGRAM_ENV = ("TZK_TESTING_MODE", "TZK_TRANSCRIPT_DEBUG", "TZK_SUBCIRCUIT_LIBRARY",
               "TZK_COORDINATOR", "TZK_NUM_PROCESSES", "TZK_PROCESS_ID")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


class Ctx:
    """What an entry adapter gets: the cell's data and where to work."""

    def __init__(self, root, config, traffic, seed, device, workdir):
        self.root, self.traffic = root, traffic
        self.seed, self.device, self.workdir = seed, device, workdir
        self.lib = gen.make_library(**config["library"])
        self.tau = gen.make_tau(gen.rng_for(seed, 0))


class JobPool:
    """The jobs, drawn from the seed and each prepared by the entry in
    set-up; one the window asks for beyond them is made then (logged)."""

    MARGIN = 1.5  # jobs made: this many times what the warm-up's pace fills

    def __init__(self, ctx, with_mixers: bool):
        self.ctx, self.with_mixers = ctx, with_mixers
        self.heavy = tuple(ctx.traffic["heavy_share"])
        self.jobs: list = []
        self.items: list = []
        self.prepare = None

    def _add(self):
        i = len(self.jobs)
        job = gen.job(self.ctx.lib, gen.placement_count(self.ctx.traffic, i), self.ctx.seed,
                      i, self.with_mixers, self.heavy)
        self.jobs.append(job)
        self.items.append(self.prepare(job, i))

    def fill(self, prepare, n: int):
        self.prepare = prepare
        while len(self.jobs) < n:
            self._add()

    def enough(self, warm_s: float, seconds: float) -> int:
        return math.ceil(self.MARGIN * seconds / max(warm_s, 1e-3)) + 1

    def item(self, k: int):
        while len(self.items) <= k:
            log(f"[zkbench] job {len(self.items)} made inside the window")
            self._add()
        return self.items[k]

    def warmup(self):
        """A job of the mix's largest size, from a stream of its own."""
        rng = gen.rng_for(self.ctx.seed, 3)
        job = gen.make_job(self.ctx.lib, self.ctx.traffic["placements"][1], rng, index=-1,
                           heavy=self.heavy)
        if self.with_mixers:
            job.mixer = gen.make_mixer(rng)
        return job


def run_cell(cell: dict, config: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device: str, root: str = ROOT, control: dict | None = None) -> dict:
    """Set-up, the window, the judgement; the result's fields."""
    from .trace import Recorder

    entry_mod = importlib.import_module(f"zkbench.entries.{config['entry']}")
    workdir = tempfile.mkdtemp(prefix="zkbench-", dir=os.environ.get("TMPDIR"))
    try:
        t0 = time.perf_counter()
        ctx = Ctx(root, config, traffic, seed, device, workdir)
        entry = entry_mod.Entry(ctx)
        pool = JobPool(ctx, entry.mixers)
        if control:
            control_setup(entry, control)
        entry.setup()
        warm_item = entry.prepare(pool.warmup(), "warmup")
        for _ in range(2):  # the first proof builds and warms up; the second sets the pace
            t_warm = time.perf_counter()
            warm = entry.run_job(warm_item)
            warm_s = time.perf_counter() - t_warm
            if warm.get("error") or warm["proof"] is None:
                raise RuntimeError(f"the warm-up job failed: {warm.get('error')}")
        pool.fill(entry.prepare, pool.enough(warm_s, seconds))
        if device != "cpu":
            torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        setup_s = time.perf_counter() - t0
        log(f"[zkbench] set-up {setup_s:.3f} s, warm-up {warm_s:.3f} s, "
            f"{len(pool.jobs)} jobs made")

        rec = Recorder(device) if trace else None
        if rec is not None:
            rec.install()
        entry.begin_window(rec)
        done, failed = [], []
        w0_ns, w0 = time.time_ns(), time.perf_counter()
        k = 0
        while True:
            t_job = time.perf_counter()
            try:
                res = entry.run_job(pool.item(k))
            except Exception as e:  # a job that fails is counted, and the window goes on
                res = dict(proof=None, error=f"{type(e).__name__}: {e}", timing={})
            res["k"], res["s"] = k, time.perf_counter() - t_job
            (failed if res.get("error") or res["proof"] is None else done).append(res)
            log(f"[zkbench] job {k}: {pool.jobs[k].n_placements} placements, {res['s']:.3f} s")
            if res.get("error"):
                log(f"[zkbench] job {k} failed: {res['error'][-600:]}")
            k += 1
            if time.perf_counter() - w0 >= seconds:
                break
        window_s = time.perf_counter() - w0
        w1_ns = time.time_ns()
        peak = entry.end_window()
        trace_rec = None
        if rec is not None:
            rec.uninstall()
            trace_rec = entry.trace_record(w0_ns, w1_ns, window_s)
            trace_rec["gaps"] = sorted(trace_rec["gaps"], key=lambda g: -g[1])[:10]
            ok = [r for r in done + failed if r.get("proof") is not None]
            trace_rec.update(jobs=[r["timing"] for r in ok], proofs=len(ok),
                             kind=torch.cuda.get_device_name(0) if device != "cpu" else "cpu")
        loaded = entry.forbidden()
        entry.close()
        del entry
        log(f"[zkbench] window {window_s:.3f} s, {len(done)} proofs, {len(failed)} failed")

        t_ref = time.perf_counter()
        checks = judge(ctx, pool, done, failed, seed)
        log(f"[zkbench] reference {time.perf_counter() - t_ref:.3f} s")
        return dict(setup_s=setup_s, window_s=window_s, done=done, failed=failed,
                    peak=peak, setup_peak=setup_peak, checks=checks, trace=trace_rec,
                    attempted=k, forbidden=loaded)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def control_setup(entry, control: dict):
    """The control and the planted faults (`control.py`), switched on in the
    program's own paths: zero blinding (the service's `Mixer.zero()`, the
    CLI's `--deterministic`), or an answer altered where it is made."""
    if control.get("zero_blinding"):
        entry.zero_blinding = True
    if control.get("alter"):
        run_job = entry.run_job

        def altered(item):
            res = run_job(item)
            if res.get("proof") is not None:
                res["proof"] = control["alter"](res["proof"])
            return res
        entry.run_job = altered


def judge(ctx, pool, done: list, failed: list, seed: int) -> dict:
    """Hold a sample of the window's proofs to the plain reference."""
    sample_n = ctx.traffic["judge"]
    order = list(range(len(done)))
    if len(order) > sample_n:
        rng = gen.rng_for(seed, 4)
        longest = max(order, key=lambda i: pool.jobs[done[i]["k"]].n_placements)
        rest = [i for i in order if i != longest]
        pick = rng.choice(len(rest), size=sample_n - 1, replace=False)
        order = sorted([longest] + [rest[int(i)] for i in pick])
    ref = Reference(ctx.lib, ctx.tau)
    flags = dict(relation_fail=0, unblinded=0, mismatch=0, layout_fail=0)
    for i in order:
        res = done[i]
        job = pool.jobs[res["k"]]
        if res.get("layout_error"):
            flags["layout_fail"] += 1
            continue
        k2 = gen.rand_fr(gen.rng_for(seed, 5, res["k"]))
        mixer = job.mixer if pool.with_mixers else None
        verdict = ref.judge(job, res["proof"], mixer, k2)
        for key in ("relation_fail", "unblinded", "mismatch"):
            flags[key] += verdict[key]
        if verdict["detail"] or verdict["relation_fail"]:
            log(f"[zkbench] job {res['k']}: {verdict}")
    layout_fails = sum(1 for r in failed if r.get("layout_error"))
    flags["layout_fail"] += layout_fails
    flags["missing"] = len(failed) - layout_fails
    flags["judged"] = len(order)
    return flags


# every number compared, with its limit: a count of proofs, exact
LIMITS = dict(relation_fail=0, unblinded=0, mismatch=0, layout_fail=0, missing=0)


def verdict(checks: dict) -> tuple[bool, dict]:
    shown = {k: {"value": checks[k], "limit": lim} for k, lim in LIMITS.items()}
    shown["judged"] = {"value": checks["judged"], "at_least": 1}
    ok = all(checks[k] <= lim for k, lim in LIMITS.items()) and checks["judged"] >= 1
    return ok, shown


def result_line(bench: dict, cell: dict, out: dict, trace: bool, device: str) -> dict:
    ok, shown = verdict(out["checks"])
    kind = torch.cuda.get_device_name(0) if device != "cpu" else "cpu"
    dev = dict(platform="gpu" if device != "cpu" else "cpu", kind=kind, count=cell["chips"],
               memory_peak_bytes=int(max(out["peak"], out["setup_peak"])))
    metrics = {}
    res = dict(correct=ok, attempted=out["attempted"], failed=len(out["failed"]),
               metrics=metrics, device=dev)
    name = cell["name"]

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    if not trace:
        n = len(out["done"])
        values = dict(
            proof_s=out["window_s"] / n if n else None,
            peak_device_gib=out["peak"] / 2**30 if out["peak"] else None,
            setup_s=out["setup_s"],
        )
        for m in bench["end_to_end"]:
            if applies(m) and values.get(m["name"]) is not None:
                metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    else:
        from .metrics import load

        rec = out["trace"]
        for m in bench["per_layer"]:
            if applies(m):
                v = load(m["name"]).read(rec)
                if v is not None:
                    metrics[m["name"]] = dict(value=v, unit=m["unit"])
        dev["busy_s"] = rec["busy_s"]
        dev["window_s"] = rec["window_s"]
        short: dict = {}
        for k, v in rec["by_name"].items():
            k = k.replace("(anonymous namespace)::", "").split("(")[0][:80]
            short[k] = short.get(k, 0.0) + v
        ranked = sorted(short.items(), key=lambda kv: -kv[1])[:10]
        res["breakdown"] = dict(device_ops=[[k, v] for k, v in ranked],
                                idle_gaps=[[g[0], g[1]] for g in rec["gaps"]])
    res["checks"] = shown
    return res


def refused(out: dict) -> list[str]:
    """The forbidden modules that this process or a job's process held."""
    return sorted(set(forbidden_modules()) | set(out["forbidden"]))


def resolve(bench: dict, workload: str, root: str = ROOT) -> tuple[dict, dict, dict]:
    """The cell named `workload`, its configuration file and its mix's file."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(root, "zkbench", "traffic", cell["traffic"] + ".json"))
    return cell, config, traffic


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    try:
        cell, config, traffic = resolve(bench, args.workload)
    except KeyError as e:
        log(f"[zkbench] {e}")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"[zkbench] the cell needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    cache = os.path.join(ROOT, ".cache", "zkbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    for k in PROGRAM_ENV:
        os.environ.pop(k, None)

    out = run_cell(cell, config, traffic, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = refused(out)
    if bad:
        log(f"[zkbench] modules that must not load were loaded: {bad}")
        return 4
    res = result_line(bench, cell, out, bool(args.trace), "cuda")
    for k, v in res["checks"].items():
        bound = f"limit {v['limit']}" if "limit" in v else f"at least {v['at_least']}"
        log(f"[zkbench] check {k} = {v['value']} ({bound})")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The reference's documented flow: one new `prove` process a transaction.

Set-up makes the CRS on the device from the seed's tau, writes it as
`combined_sigma.rkyv` with the program's rkyv writer, and stages the library
in the qap-compiler layout with the benchmark's own writer; every job's
synthesizer files are written in set-up too.  A job runs
`python -m zkbench.entries.cli_child` (a thin wrapper around
`tokamak_zk_evm_tpu_torch.cli.main`) with `prove --library --crs
--synthesizer --output` and reads back `proof.json`.  The CLI draws its
blinding from the OS, so the benchmark never knows it.  Each job's process
reports its device peak, the forbidden modules it held, and in a traced
run its spans, op counts and device trace, which `trace_record` merges.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

from tokamak_zk_evm_tpu_torch.io import rkyv_crs
from tokamak_zk_evm_tpu_torch.models.setup import generate_sigma

from .. import files
from ..reference import layout
from . import base, port


class Entry(base.Entry):
    mixers = False

    def __init__(self, ctx):
        super().__init__(ctx)
        self.dir = ctx.workdir
        self.lib_dir = os.path.join(self.dir, "library")
        self.crs_dir = os.path.join(self.dir, "crs")
        self.children: list = []  # the window's job processes' reports
        self.loaded: set = set()  # forbidden modules any job process held
        self.extra_args: list = []

    @property
    def zero_blinding(self):
        return "--deterministic" in self.extra_args

    @zero_blinding.setter
    def zero_blinding(self, on: bool):
        """The control: the CLI's own zero-blinding switch."""
        self.extra_args = ["--deterministic"] if on else []

    def setup(self):
        lib = self.ctx.lib
        params = port.params(lib)
        sigma = generate_sigma(params, port.tau(self.ctx.tau), port.library(lib),
                               port.infos(lib), device=self.device)
        os.makedirs(self.crs_dir, exist_ok=True)
        rkyv_crs.write_combined_sigma(sigma, params, os.path.join(self.crs_dir,
                                                                  "combined_sigma.rkyv"))
        del sigma
        if self.device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        files.write_library(lib, self.lib_dir)

    def _job_dir(self, key):
        return os.path.join(self.dir, f"job_{key}")

    def prepare(self, job, key):
        files.write_job(job, os.path.join(self._job_dir(key), "in"))
        return key

    def run_job(self, key):
        d = self._job_dir(key)
        out = os.path.join(d, "child.json")
        argv = ([] if self.device == "cuda" else ["--device", self.device]) + [
            "prove", "--library", self.lib_dir, "--crs", self.crs_dir,
            "--synthesizer", os.path.join(d, "in"), "--output", os.path.join(d, "out"),
            *self.extra_args]
        cmd = [sys.executable, "-m", "zkbench.entries.cli_child", out,
               "1" if self.rec is not None else "0", "--", *argv]
        t_spawn = time.time_ns()
        with open(os.path.join(d, "child.log"), "w") as log:
            rc = subprocess.run(cmd, cwd=self.ctx.root, stdout=log,
                                stderr=subprocess.STDOUT).returncode
        t_end = time.time_ns()
        res = dict(proof=None, timing={}, error=None)
        try:
            with open(out) as f:
                child = json.load(f)
        except (OSError, ValueError) as e:
            res["error"] = f"exit {rc}: {e}; " + _tail(os.path.join(d, "child.log"))
            return res
        child["t_spawn"], child["t_end"] = t_spawn, t_end
        self.loaded.update(child["forbidden"])
        self.children.append(child)
        try:
            with open(os.path.join(d, "out", "proof.json")) as f:
                res["proof"] = layout.read(json.load(f))
        except (OSError, ValueError) as e:
            res["error"] = f"exit {rc}: {e}; " + _tail(os.path.join(d, "child.log"))
        except layout.LayoutError as e:
            res["layout_error"] = str(e)
        if rc != 0:
            res["error"] = f"exit {rc}; " + _tail(os.path.join(d, "child.log"))
        spans = child.get("spans", {})
        res["timing"] = dict(start_s=(child["t_ready"] - t_spawn) / 1e9,
                             crs_load_s=spans.get("cli.crs_load"),
                             init_s=spans.get("prover.init"),
                             rounds_s=spans.get("prover.rounds"))
        return res

    def begin_window(self, rec):
        self.rec = rec
        self.children = []

    def end_window(self):
        return max((c["peak"] for c in self.children), default=0)

    def trace_record(self, w0_ns, w1_ns, window_s):
        """The job processes' traces, merged; the window leaves out each
        process's profiler start and its reading of its own trace."""
        busy, kernels, by_name, gaps, msm, ntt = 0.0, 0, {}, [], [], []
        for c in self.children:
            tr = c["trace"]
            busy += tr["busy_s"]
            kernels += tr["kernels"]
            for name, s in tr["by_name"].items():
                by_name[name] = by_name.get(name, 0.0) + s
            gaps += tr["gaps"]
            gaps.append(["cli.start", (c["t_ready"] - c["t_spawn"]) / 1e9])
            gaps.append(["cli.exit", (c["t_end"] - c["t_written"]) / 1e9])
            window_s -= (c["t_main"] - c["t_ready"] + c["t_written"] - c["t_exit"]) / 1e9
            msm += c["counts"]["msm"]
            ntt += c["counts"]["ntt"]
        return dict(window_s=window_s, busy_s=busy, kernels=kernels, by_name=by_name,
                    gaps=gaps, msm=msm, ntt=ntt)

    def forbidden(self):
        return sorted(self.loaded)


def _tail(path: str, n: int = 2000) -> str:
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError:
        return ""

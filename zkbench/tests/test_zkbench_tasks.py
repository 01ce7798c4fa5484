"""A kind of job added as new files only (its task, entry, configuration and
mix, written to a scratch directory) runs through the harness on the CPU
with its own counts, limits and planted fault; `setup_s` does not grow with
the jobs the harness makes; the proof's checks keep their keys and limits."""

from __future__ import annotations

import json
import re
import sys

import pytest

import zkbench.entries
import zkbench.tasks
from zkbench import run
from zkbench.tasks import proof

TOY_TASK = '''"""A toy kind of job: a number drawn from the seed, to be squared mod a prime."""

import numpy as np

SECONDS_PER_JOB = "square_s"
LIMITS = {"wrong": {"limit": 0}, "missing": {"limit": 0}, "judged": {"at_least": 1}}
CONTROLS = {"altered": dict(alter=lambda answer: answer + 1)}


def shared(ctx):
    ctx.modulus = ctx.config["modulus"]


def _draw(ctx, *stream):
    return int(np.random.default_rng([ctx.seed, *stream]).integers(ctx.modulus))


def make_job(ctx, i):
    return dict(x=_draw(ctx, 2, i))


def warmup_job(ctx):
    return dict(x=_draw(ctx, 3))


def judge(ctx, jobs, done, failed, seed):
    wrong = sum(r["proof"] != jobs[r["k"]]["x"] ** 2 % ctx.modulus for r in done)
    return dict(wrong=wrong, missing=len(failed), judged=len(done))
'''

TOY_ENTRY = '''"""The toy kind's entry: squares in process, sleeping as its configuration says."""

import time

from zkbench.entries import base


class Entry(base.Entry):
    def setup(self):
        time.sleep(self.ctx.config["setup_sleep"])

    def prepare(self, job, key):
        time.sleep(self.ctx.config["prepare_sleep"])
        return job

    def run_job(self, item):
        time.sleep(self.ctx.config["job_sleep"])
        return dict(proof=item["x"] ** 2 % self.ctx.modulus, timing={})
'''

TOY_BENCH = {
    "configs": [{"name": "toy", "file": "zkbench/configs/toy.json"}],
    "workloads": [{"name": "toy.few", "config": "toy", "traffic": "few", "chips": 1}],
    "end_to_end": [{"name": "square_s", "unit": "s"}, {"name": "peak_device_gib", "unit": "GiB"},
                   {"name": "setup_s", "unit": "s"}],
    "per_layer": [],
}
TOY_CONFIG = dict(task="toy_square", entry="toy_square", modulus=2**61 - 1, setup_sleep=0.05,
                  prepare_sleep=0.0, job_sleep=0.001)


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy kind's four files in a scratch directory, where the harness
    finds its task and entry by name."""
    for pkg, text in ((zkbench.tasks, TOY_TASK), (zkbench.entries, TOY_ENTRY)):
        d = tmp_path / pkg.__name__.split(".")[-1]
        d.mkdir()
        (d / "toy_square.py").write_text(text)
        monkeypatch.setattr(pkg, "__path__", [str(d), *pkg.__path__])
    for sub, name, data in (("configs", "toy", TOY_CONFIG), ("traffic", "few", {})):
        (tmp_path / "zkbench" / sub).mkdir(parents=True)
        (tmp_path / "zkbench" / sub / f"{name}.json").write_text(json.dumps(data))
    yield tmp_path
    for name in ("zkbench.tasks.toy_square", "zkbench.entries.toy_square"):
        sys.modules.pop(name, None)


def _run_toy(root, seconds=0.02, control=None, **config):
    cell, conf, traffic = run.resolve(TOY_BENCH, "toy.few", root=str(root))
    out = run.run_cell(cell, dict(conf, **config), traffic, 2**31 + 5, seconds, False, "cpu",
                       control=control)
    return out, run.result_line(TOY_BENCH, cell, out, False, "cpu")


def test_a_kind_of_job_added_as_new_files_runs_and_is_judged(toy):
    out, res = _run_toy(toy)
    assert res["correct"], res["checks"]
    assert res["checks"] == {"wrong": {"value": 0, "limit": 0},
                             "missing": {"value": 0, "limit": 0},
                             "judged": {"value": len(out["done"]), "at_least": 1}}
    assert set(res["metrics"]) == {"square_s", "setup_s"}  # no device memory on the CPU
    n = len(out["done"])
    assert res["metrics"]["square_s"]["value"] == pytest.approx(out["window_s"] / n)


def test_a_kind_of_jobs_planted_fault_is_not_correct(toy):
    task = run.task_of(TOY_CONFIG)
    out, res = _run_toy(toy, control=task.CONTROLS["altered"])
    assert not res["correct"]
    assert res["checks"]["wrong"]["value"] == len(out["done"]) >= 1


def test_setup_s_leaves_out_the_jobs_made(toy, capsys):
    """Two paces of the warm-up job give the harness two counts of jobs to
    make, each prepare a sleep: `setup_s` holds the entry's set-up and the
    two warm-up runs, and the logged job making carries the prepares."""
    prepare, setup = 0.05, TOY_CONFIG["setup_sleep"]
    counts = []
    for job in (0.1, 0.02):
        capsys.readouterr()
        out, _ = _run_toy(toy, seconds=0.3, prepare_sleep=prepare, job_sleep=job)
        made = re.search(r"jobs made: (\d+) and the warm-up's in ([0-9.]+) s",
                         capsys.readouterr().err)
        n, jobs_s = int(made.group(1)), float(made.group(2))
        counts.append(n)
        assert setup + 2 * job <= out["setup_s"] < setup + 2 * job + prepare
        assert jobs_s == pytest.approx(out["jobs_s"], abs=1e-3)
        assert jobs_s >= (n + 1) * prepare
    assert counts[1] > 2 * counts[0]


def test_proof_checks_keep_their_keys_and_limits():
    """The proof kind's checks, as the result line shows them."""
    counts = dict(relation_fail=0, unblinded=1, mismatch=0, layout_fail=0, missing=0, judged=4)
    ok, shown = run.verdict(counts, proof.LIMITS)
    assert not ok
    assert json.dumps(shown) == (
        '{"relation_fail": {"value": 0, "limit": 0}, "unblinded": {"value": 1, "limit": 0}, '
        '"mismatch": {"value": 0, "limit": 0}, "layout_fail": {"value": 0, "limit": 0}, '
        '"missing": {"value": 0, "limit": 0}, "judged": {"value": 4, "at_least": 1}}')
    assert run.verdict(dict(counts, unblinded=0), proof.LIMITS)[0]
    assert list(proof.CONTROLS) == ["control", "altered"]

"""BENCHMARK.json's rules of form (keys, names, units, sizes, bounds), and
the harness finding every configuration, mix and metric it names."""

from __future__ import annotations

import json
import os
import re

import pytest

from zkbench import run
from zkbench.metrics import load

ROOT = run.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def _line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p)) and not p.endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 2 + 14 * 24 <= (43200 - 1200 - 24 * 180) / (BENCH["run_seconds"] + 60)
    assert 1 <= cells <= 24


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        assert c["name"] in used and len(c["reduced"]) <= 16
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]


def test_workloads():
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(names)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(names) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metrics(section):
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    keys = {"end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[section]
    for m in BENCH[section]:
        assert set(m) - {"workloads"} == keys
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if section == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            assert _line(m["layer"]) and m["moves"] in e2e
    assert "setup_s" in e2e


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        def has(m):
            return w["name"] in m.get("workloads", [w["name"]])
        e2e = [m["name"] for m in BENCH["end_to_end"] if has(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(has(m) for m in BENCH["per_layer"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cells_resolve_to_their_files(workload):
    cell, config, traffic = run.resolve(BENCH, workload)
    assert os.path.isfile(os.path.join(ROOT, "zkbench", "entries", config["entry"] + ".py"))
    lo, hi = traffic["placements"]
    assert 4 < lo <= hi <= config["library"]["s_max"] and (hi - lo) % 2 == 0
    a, b = traffic["heavy_share"]
    assert 0 <= a <= b and traffic["judge"] >= 1


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(load(metric).read)

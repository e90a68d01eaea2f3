"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds by that name."""

import json
import os
import re

import bench_tiny  # noqa: F401  (puts the repository root on sys.path)
from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    spec = harness.spec()
    assert set(spec) == TOP
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) < 64 * 1024


def test_configs_name_their_files():
    spec = harness.spec()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["why"]) and one_line(c["source"])
        assert c["file"] == "benchmark/configs/%s.json" % c["name"]
        body = harness.config(c["name"])
        assert body["reduced"] == c["reduced"] == []
        assert body["source"] == c["source"]
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}


def test_cells_find_their_files():
    spec = harness.spec()
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        body = harness.workload(w["name"])
        assert body["config"] == w["config"] and body["chips"] == w["chips"]
        assert body["why"] == w["why"]
        assert w["name"] == "%s.%s" % (w["config"], w["traffic"])
        assert hasattr(harness.traffic(body["traffic"]["kind"]), "Client")
        limit = body["check"]["limits"]["caption_mismatch"]
        assert isinstance(limit, float) and 0.0 < limit < 1.0
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= 1


def test_metrics_have_readers_and_arrows():
    spec = harness.spec()
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    names = set()
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for cell in cells:  # one end-to-end metric of its own besides setup_s a cell
        assert len([m for m in spec["end_to_end"] if cell in m.get("workloads", [])]) == 1
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert set(m.get("workloads", cells)) <= cells
        assert callable(harness.reader(m["name"]))
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        ends = [m["name"] for m in harness.metrics_for(spec, cell, False)]
        assert "setup_s" in ends and len(ends) >= 2
        assert harness.metrics_for(spec, cell, True)


def test_files_under_the_benchmark_are_named_from_names():
    for dirpath, _, files in os.walk(harness.BENCH):
        for f in files:
            path = os.path.relpath(os.path.join(dirpath, f), harness.ROOT)
            if "__pycache__" in path:
                continue
            assert re.match(r"^[A-Za-z0-9_./-]+$", path), path

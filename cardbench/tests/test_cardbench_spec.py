"""The benchmark's files: every configuration, traffic mix, cell, limit
and per-layer metric found by its name, and names outside the contract's
characters refused."""

import json
import os
import re

import pytest

from cardbench import harness

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_found_by_name(workload):
    cell = harness.cell_spec(workload)
    assert cell["cfg"]["name"] == cell["config"]
    assert cell["traffic_spec"]["name"] == cell["traffic"]
    assert cell["limits"]
    assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    cfg = harness.program_config(cell["cfg"])
    for key in harness.MODEL_KEYS:
        if key in cell["cfg"]:
            want = cell["cfg"][key]
            if key == "layer_groups":
                want = tuple((tuple(p), c) for p, c in want)
            assert getattr(cfg, key) == want


@pytest.mark.parametrize("name", PER_LAYER)
def test_metric_reader_found_by_name(name):
    read = harness.metric_reader(name)
    assert callable(read)


@pytest.mark.parametrize("name", ["a b", "x/y", "", "-lead", "é", "a" * 65,
                                  "tab\tname", "../up"])
def test_bad_name_refused(name):
    with pytest.raises(ValueError):
        harness.check_name(name)
    with pytest.raises((ValueError, KeyError)):
        harness.cell_spec(name)


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cardbench"]
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for c in BENCH["configs"]:
        assert c["file"].startswith("cardbench/")
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = harness.load_json(harness.ROOT, c["file"])
        assert cfg["reduced"] == c["reduced"]
        for key, value in cfg["published"].items():
            assert key in c["reduced"] and cfg[key] != value
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            e2e_of_cell = [x["name"] for x in
                           harness.cell_spec(cell)["end_to_end"]]
            assert m["moves"] in e2e_of_cell
    for m in BENCH["end_to_end"]:
        assert m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                      "device_trace")
    assert len(json.dumps(BENCH)) < 64 << 10

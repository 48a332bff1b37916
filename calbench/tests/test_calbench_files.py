"""BENCHMARK.json and the files it names: they parse, keep the contract's
limits, and the harness finds each cell, configuration, mix and metric by name."""

import json
import os
import re

import pytest
from calbench_cuts import ROOT

from calbench import harness

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "calbench/run.py"]
    assert BENCH["paths"] == ["calbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_keep_the_contracts_shapes():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("calbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_each_configuration_states_its_source_and_cuts():
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and cfg["assumed"]
        assert all(k in cfg for k in cfg["reduced"])


@pytest.mark.parametrize("name", CELLS)
def test_harness_finds_each_cell_by_name(name):
    cell = harness.Cell(name)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "slice_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert os.path.isfile(os.path.join(ROOT, "calbench", "metrics", f"{m['name']}.py"))
    assert set(cell.cell["limits"]) == set(harness.NUMBERS)
    assert cell.traffic["mode"] in ("serial", "batched")


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_the_port_takes_every_fit_setting_from_the_configuration(conf):
    from calbench import program

    cfg = json.load(open(os.path.join(ROOT, conf["file"])))
    st = program.settings(cfg["fit"], cfg["basis"])
    assert st.remat == cfg["fit"]["remat"] and st.learning_rate == cfg["fit"]["learning_rate"]
    for fit, basis in [({**cfg["fit"], "momentum": 0.9}, cfg["basis"]),
                       ({**cfg["fit"], "model_regularization": "sum"}, cfg["basis"]),
                       ({**cfg["fit"], "comps_precision": "float32"}, cfg["basis"]),
                       (cfg["fit"], {k: v for k, v in cfg["basis"].items() if k != "horizon"})]:
        with pytest.raises(ValueError):
            program.settings(fit, basis)

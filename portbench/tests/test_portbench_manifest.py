"""BENCHMARK.json against the benchmark's contract, and the files each of
its names points to."""

import json
import re

import numpy as np
import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MAN = harness.load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"] and MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_units_and_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_its_metrics_move(cell):
    e2e = {m["name"] for m in harness.reported_metrics(MAN, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.reported_metrics(MAN, cell, True)
    assert layer, "every cell reports a per-layer metric"
    for m in layer:
        assert m["moves"] in e2e, f"{m['name']} moves {m['moves']}, which {cell} does not report"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    spec = harness.cell_spec(MAN, cell)
    assert spec["traffic"]["step"] in __import__("portbench.cells").cells.STEP_KINDS
    assert spec["limits"] and all(v > 0 for v in spec["limits"].values())
    for m in harness.reported_metrics(MAN, cell, False) + harness.reported_metrics(MAN, cell, True):
        assert callable(harness.reader(m["name"]))


def test_configurations_state_their_source_and_cuts():
    for c in MAN["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and cfg["assumed"]
        assert set(cfg["reduced"]) <= set(cfg["source_values"])


def test_per_layer_metrics_list_their_cells():
    for m in MAN["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS), m["name"]


def test_the_cell_follows_the_imagers_rule_on_its_array():
    from portbench import data

    for c in MAN["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        uvw = data.synth_array(cfg["nant"], cfg["ntime"], cfg["array_seed"], cfg["wscale"], cfg["radius_m"])
        max_blength = float(np.abs(uvw[:, :2]).max()) * np.sqrt(2.0)
        nyquist = 1.0 / (2.0 * max_blength * cfg["fmax_hz"] / data.LIGHTSPEED)
        assert abs(cfg["cell_rad"] - nyquist / 2.0) < 1e-9 * cfg["cell_rad"]
        assert float(np.sqrt((uvw[:, :2] ** 2).sum(1)).max()) <= 2.0 * cfg["radius_m"]


def test_layers_are_named_alike():
    for name in {m["layer"] for m in MAN["per_layer"]}:
        assert name == name.strip() and "\n" not in name

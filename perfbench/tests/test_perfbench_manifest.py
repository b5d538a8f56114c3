"""BENCHMARK.json against the files it names and the rules it keeps.

Every cell, configuration, traffic module and per-layer metric is found by
name; every metric's ``moves`` names an end-to-end metric that each of its
cells reports; every cell reports ``setup_s``, another end-to-end metric and
a per-layer one; names, units and bounds are within their limits.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from perfbench.lib import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def reports(entry, cell):
    return "workloads" not in entry or cell in entry["workloads"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    workload = json.loads((ROOT / "perfbench" / "workloads" / f"{cell}.json").read_text())
    assert workload["config"] == entry["config"]
    config = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert (ROOT / config["file"]).is_file()
    assert (ROOT / "perfbench" / "traffic" / f"{workload['traffic']}.py").is_file()
    assert entry["chips"] == 1
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for metric in BENCH["per_layer"]:
        if reports(metric, cell):
            assert harness.reader_path(metric["name"]).is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_it_must(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(m, cell) for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_moves_names_a_metric_its_cells_report(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == entry["moves"])
    for cell in entry["workloads"]:
        assert cell in CELLS and reports(moved, cell)
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(len(layer) <= 200 and "\n" not in layer for layer in layers)


def test_names_units_and_bounds():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_holds_the_configuration(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    body = json.loads((ROOT / entry["file"]).read_text())
    assert body["source"] == entry["source"]
    assert body["reduced"] == entry["reduced"] == []
    assert any(w["config"] == config for w in BENCH["workloads"])

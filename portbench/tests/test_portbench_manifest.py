"""BENCHMARK.json against the benchmark's contract, and every entry
resolved to its files by name (a later cell, configuration or metric is
added by adding files and entries)."""
from __future__ import annotations

import json
import re

import pytest

from portbench.harness import common

BENCH = common.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
METRIC_KEYS = {"name", "unit", "better", "source"}
DRIVER_API = ("run", "end_to_end", "counts", "release", "check", "control")


def _line(text) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells fits into 43,200 s.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    names = [e["name"] for e in entries]
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"])
    for c in BENCH["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(config):
    assert set(config) == CONFIG_KEYS
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    data = common.load_json("configs", config["name"])
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"]
    assert all(k in data for k in config["reduced"])
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    assert set(cell) == CELL_KEYS and cell["chips"] in (1, 4)
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = common.load_json("traffic", cell["traffic"])
    limits = common.load_json("limits", cell["name"])["limits"]
    assert limits and all(v >= 0 for v in limits.values())
    driver = common.load_module("drivers", traffic["driver"])
    assert all(callable(getattr(driver.Cell, f)) for f in DRIVER_API)
    assert traffic["trace_units"] >= 1
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("metric", BENCH["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert set(metric) - {"workloads"} == METRIC_KEYS | {"bound"}
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_resolves(metric):
    assert set(metric) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    reader = common.load_module("metrics", metric["name"])
    assert callable(reader.read)
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", [cell])
    if "roofline" in metric["name"]:
        assert metric["name"].endswith("_roofline") and \
            metric["unit"] == "%"


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_layers_are_spelled_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = (common.ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf

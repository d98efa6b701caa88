"""BENCHMARK.json and the files it names: every cell finds its
configuration, traffic mix, entry and limits; every metric its reader and
the end-to-end metric it moves; names, units and sizes within the limits
of BENCHMARK.json's format."""

import importlib
import json
import re

import pytest

from perfbench import harness

BENCH = harness.benchmark()
HERE = harness.HERE
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E_MADE = {"solves_per_s", "call_ms_p95", "setup_s"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_run_seconds_fits_a_full_check():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == c.workload["config"]
    problem = importlib.import_module(f"perfbench.problems.{c.config['problem']}")
    entry = problem.ENTRIES[c.traffic["entry"]]
    assert entry.control and entry.judge and entry.keep
    assert c.sample >= 1 and c.limits


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    path = harness.ROOT / cfg["file"]
    assert path.parts[-3:-1] == ("perfbench", "configs")
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    for name in names:
        assert NAME.match(name), name
    assert len(set(CELLS)) == len(CELLS)
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in BENCH["workloads"]] + [c["source"] for c in BENCH["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics():
    for m in BENCH["end_to_end"]:
        assert m["name"].split(".")[0] in E2E_MADE
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def _reported(metric, cell):
    return cell in metric.get("workloads", CELLS)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert (HERE / "metrics" / f"{metric['name']}.py").is_file()
    assert callable(harness.reader(metric["name"]))
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
        assert _reported(moved, cell), (metric["name"], cell)
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m for m in BENCH["end_to_end"] if _reported(m, cell)]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert any(_reported(m, cell) for m in BENCH["per_layer"])

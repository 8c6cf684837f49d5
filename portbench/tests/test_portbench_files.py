"""BENCHMARK.json against the files of the harness, and the contract's
rules on names, units and metrics."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = {w["name"]: w for w in BENCH["workloads"]}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def _reports(metric, cell):
    return cell in metric.get("workloads", CELLS)


def test_every_workload_file_has_a_cell_and_the_reverse():
    files = {p.stem for p in (ROOT / "workloads").glob("*.json")}
    assert files == set(CELLS)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_names_its_configuration_and_traffic(cell):
    work = json.loads((ROOT / "workloads" / f"{cell}.json").read_text())
    entry = CELLS[cell]
    assert work["config"] == entry["config"] and work["traffic"] == entry["traffic"]
    assert work["chips"] == entry["chips"] and work["why"] == entry["why"]
    assert (ROOT / "configs" / f"{work['config']}.json").is_file()
    assert (ROOT / "traffic" / f"{work['traffic']}.py").is_file()
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]


def test_configurations_are_their_files():
    for c in BENCH["configs"]:
        conf = json.loads((ROOT.parent / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert any(w["config"] == c["name"] for w in CELLS.values())


def test_names_and_units():
    named = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_end_to_end_bounds_and_sources():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for cell in CELLS:
        reported = [m for m in BENCH["end_to_end"] if _reports(m, cell)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(_reports(m, cell) for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_what_its_cells_report(metric):
    assert (ROOT / "metrics" / f"{metric['name']}.py").is_file()
    moved = E2E[metric["moves"]]
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
        assert _reports(moved, cell), (metric["name"], cell)
    assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]


def test_metric_files_are_listed():
    listed = {m["name"] for m in BENCH["per_layer"]}
    assert {p.name[:-3] for p in (ROOT / "metrics").glob("*.py")} == listed


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert 1 <= s <= 51 and (2 + 14 * 24) * (s + 60) + 24 * 180 + 1200 <= 43200


def test_command_stays_inside_paths():
    assert BENCH["paths"] == ["portbench"]
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word

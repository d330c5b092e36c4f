"""``BENCHMARK.json`` keeps to its contract, and every cell finds its
files by name; a cell, a configuration and a metric added as new files
are picked up with no edit to a file that is there."""

import json
import re
from pathlib import Path

import pytest

from portbench.lib.cells import Cell

REPO = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("name", [x["name"] for x in
                                  MANIFEST["configs"] + MANIFEST["workloads"]
                                  + METRICS])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    if "layer" in metric:
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_cells_report_what_they_move(metric):
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    moved = e2e[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", [cell])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_found(cell):
    c = Cell(cell, REPO)
    assert c.config_path.is_relative_to(REPO / "portbench")
    assert c.traffic["driver"] in ("refine", "detect")
    assert set(c.workload) >= {"sample", "block", "profile", "limits"}
    assert c.driver().Driver
    names = [m["name"] for m in c.per_layer()]
    assert names, cell
    for n in names:
        assert callable(c.reader(n))
    e2e = [m["name"] for m in c.end_to_end()]
    assert "setup_s" in e2e and len(e2e) >= 2


def test_new_files_picked_up(tmp_path):
    from portbench.tests.tiny import make_root

    root = make_root(tmp_path)
    b = json.loads((root / "BENCHMARK.json").read_text())
    (root / "portbench" / "metrics" / "stub_metric.py").write_text(
        "def read(rec):\n    return 1.5\n")
    b["per_layer"].append(dict(name="stub_metric", unit="ms", better="lower",
                               source="device_trace", layer="device",
                               moves="setup_s",
                               workloads=["tiny_v.offline8"]))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    c = Cell("tiny_v.offline8", root)
    assert c.config["vernier"]["backbone"]["name"] == "hrnet-tiny"
    assert "stub_metric" in [m["name"] for m in c.per_layer()]
    assert c.reader("stub_metric")({}) == 1.5
    assert c.workload["limits"]["keep_flips"] == 0

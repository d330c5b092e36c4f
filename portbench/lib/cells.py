"""Everything a cell is made of, found by name.

``BENCHMARK.json`` (the root of the checkout) names each cell's
configuration and traffic mix.  The files are:

* ``portbench/configs/<config>.json``: the configuration (the program's
  config under ``vernier`` or ``stereo``, its source, ``assumed``,
  ``reduced`` and the weights' ``scale``);
* ``portbench/traffic/<traffic>.json``: the traffic mix's parameters and
  the driver (``portbench/drivers/<driver>.py``) that generates and
  serves it;
* ``portbench/workloads/<cell>.json``: the cell's correctness check (the
  requests sampled, the reference's block, the limits) and its traced
  slice;
* ``portbench/metrics/<metric>.py``: one reader per per-layer metric, a
  ``read(record)`` that returns the number or None.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """One entry of ``workloads`` with its files."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = root
        self.bench_dir = root / "portbench"
        self.manifest = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config_path = root / self.config_entry["file"]
        self.config = load_json(self.config_path)
        self.traffic = load_json(
            self.bench_dir / "traffic" / f"{self.entry['traffic']}.json")
        self.workload = load_json(
            self.bench_dir / "workloads" / f"{name}.json")

    def end_to_end(self):
        return [m for m in self.manifest["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        """The per-layer metrics reported in this cell: those that list
        it, and those without a list whose ``moves`` metric it reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.manifest["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def driver(self):
        return importlib.import_module(
            f"portbench.drivers.{self.traffic['driver']}")

    def reader(self, metric: str) -> Callable:
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench.metrics." + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

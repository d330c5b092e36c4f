"""A copy of the benchmark in a temporary root with tiny cells added as
new files only (a configuration, workload files and ``BENCHMARK.json``
entries), for runs on the CPU."""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
from pathlib import Path

import torch

from snvc_tpu_torch.config import tiny_stereo_config, tiny_vernier_config

REPO = Path(__file__).resolve().parents[2]
# tiny cell -> (configuration, traffic, the cell whose workload file it
# copies)
CELLS = {
    "tiny_v.offline8": ("tiny_vernier", "offline8", "refine_w48.offline8"),
    "tiny_v.online_var": ("tiny_vernier", "online_var",
                          "refine_w48.online_var"),
    "tiny_s.offline4": ("tiny_stereo", "offline4", "detect_full.offline4"),
}
# float32 program against the float32 reference at the tiny sizes
TINY_LIMITS = {
    "tiny_v.offline8": dict(ncf_rel=2e-3, occupancy_rel=2e-3, keep_flips=0,
                            finalize_flips=0, unanswered=0),
    "tiny_s.offline4": dict(cls_rel=2e-3, reg_rel=2e-3, ctr_rel=2e-3,
                            depth_rel=2e-3, proposal_flips=0, unanswered=0),
}
TINY_LIMITS["tiny_v.online_var"] = TINY_LIMITS["tiny_v.offline8"]


def make_root(tmp: Path) -> Path:
    root = tmp / "root"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    b = json.loads((root / "BENCHMARK.json").read_text())
    cfgs = root / "portbench" / "configs"
    (cfgs / "tiny_vernier.json").write_text(json.dumps(dict(
        vernier=dataclasses.asdict(tiny_vernier_config()),
        weights=dict(scale={"head.Conv_0.weight": 0.1}))))
    (cfgs / "tiny_stereo.json").write_text(json.dumps(dict(
        stereo=dataclasses.asdict(tiny_stereo_config()))))
    for name in ("tiny_vernier", "tiny_stereo"):
        b["configs"].append(dict(name=name, source="tests",
                                 file=f"portbench/configs/{name}.json",
                                 reduced=[], why="tests"))
    for cell, (cfg, traffic, base) in CELLS.items():
        b["workloads"].append(dict(name=cell, config=cfg, traffic=traffic,
                                   chips=1, why="tests"))
        w = json.loads((root / "portbench" / "workloads" /
                        f"{base}.json").read_text())
        w["limits"] = TINY_LIMITS[cell]
        (root / "portbench" / "workloads" / f"{cell}.json").write_text(
            json.dumps(w))
        for m in b["end_to_end"] + b["per_layer"]:
            if base in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


def run(root: Path, cell: str, seed: int = 2 ** 31 + 11,
        seconds: float = 2.0):
    """One CPU run of ``cell`` (the harness's look for a card skipped)."""
    from portbench import run as bench_run

    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=0)
    return bench_run.run_cell(args, torch.device("cpu"), root)

"""On the card: each cell, run as its command line runs it for a short window,
prints a result line that is correct and carries its metrics, and the
control (the reference rounded to float8) fails its limits at the
cell's own size.  Skips without an NVIDIA card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(cell, trace):
    _card()
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 101), "--seconds", "8", "--trace", str(trace)],
        cwd=REPO, env=dict(os.environ), capture_output=True, text=True,
        timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_card(cell):
    _card()
    from portbench.lib import compare
    from portbench.lib.cells import Cell

    c = Cell(cell, REPO)
    driver = c.driver().Driver(c, 2 ** 31 + 102, torch.device("cuda", 0))
    driver.setup()
    driver.window(6.0, None)
    checks = compare.with_limits(driver.numbers("fp8"), c.workload["limits"])
    assert not compare.passed(checks), checks

"""The port's refinement diagnostic (snvc_tpu_torch/tools/
diagnose_refinement.py) against JAX's (tools/diagnose_refinement.py).

* ``box_errors`` and ``load_kitti_boxes`` equal JAX's exactly (the same
  lists and arrays) on seeded boxes and files.
* Both CLIs on a 4-frame rendered tree (3 cars a frame,
  ``make_synthetic_kitti`` seed 1000) with noisy-GT proposals
  (``write_predictions``, noise 0.2 m) and the trained Vernier checkpoint
  in float32 (JAX restores the Orbax directory
  artifacts/two_stage_r4/vernier_ckpt through scripts/
  convert_jax_checkpoint.restore_jax_variables, the port loads its committed
  conversion artifacts/two_stage_r4_torch/vernier; both with
  ``compute_dtype`` float32 in the copied config.json), every decode and
  both pred types: ``report.json`` has the same keys, counts and step,
  the medians within 1e-4 (m, degrees) and the AP values equal (the same
  evaluator source scores boxes that agree within 1e-4 m).
"""

import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from scripts.convert_jax_checkpoint import restore_jax_variables
from snvc_tpu_torch.data.synthetic import (
    make_synthetic_kitti,
    write_predictions,
)
from snvc_tpu_torch.tools import diagnose_refinement as tdiag

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jdiag = _jax_tool("diagnose_refinement")

JAX_CKPT = os.path.join(ROOT, "artifacts", "two_stage_r4", "vernier_ckpt")
PORT_CKPT = os.path.join(ROOT, "artifacts", "two_stage_r4_torch", "vernier")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread: under the tier-1 command's six workers torch's per-core
    pool runs several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_box_errors_equal_jax():
    rng = np.random.default_rng(0)
    gt = rng.uniform(-10, 30, (5, 7)).astype(np.float32)
    pred = gt[[0, 2, 4, 1]] + rng.normal(0, 0.8, (4, 7)).astype(np.float32)
    pred[3, 3] += 10.0  # no GT within 3 m
    for g in (gt, np.zeros((0, 7), np.float32)):
        assert tdiag.box_errors(pred, g) == jdiag.box_errors(pred, g)
    assert len(tdiag.box_errors(pred, gt)[0]) == 3


def test_load_kitti_boxes_equals_jax(tmp_path):
    make_boxes = [np.random.default_rng(i).uniform(1, 9, (i, 7)).astype(
        np.float32) for i in (1, 3)]
    write_predictions(str(tmp_path), make_boxes, noise=0.2)
    open(tmp_path / "000002.txt", "w").close()  # a frame without a box
    got = tdiag.load_kitti_boxes(str(tmp_path))
    want = jdiag.load_kitti_boxes(str(tmp_path))
    assert list(got) == list(want) == ["000000", "000001", "000002"]
    for k in want:
        assert (got[k].dtype, got[k].shape) == (want[k].dtype, want[k].shape)
        np.testing.assert_array_equal(got[k], want[k])


def _work_dir(path, shared, ckpt_files):
    """A two-stage work dir: the shared tree and proposals, and
    vernier_ckpt with ``ckpt_files`` copied beside a float32 config."""
    os.makedirs(os.path.join(path, "vernier_ckpt"))
    os.symlink(os.path.join(shared, "kitti_val"),
               os.path.join(path, "kitti_val"))
    shutil.copytree(os.path.join(shared, "proposals"),
                    os.path.join(path, "proposals"))
    for src in ckpt_files:
        dst = os.path.join(path, "vernier_ckpt", os.path.basename(src))
        (shutil.copytree if os.path.isdir(src) else shutil.copy)(src, dst)
    cfg = json.load(open(os.path.join(PORT_CKPT, "config.json")))
    cfg["compute_dtype"] = "float32"
    json.dump(cfg, open(os.path.join(path, "vernier_ckpt", "config.json"),
                        "w"))
    return path


def test_cli_reports_match_jax(tmp_path, monkeypatch, capsys):
    import jax

    jax.config.update("jax_platforms", "cpu")
    shared = str(tmp_path / "shared")
    boxes = make_synthetic_kitti(os.path.join(shared, "kitti_val"), 4, 3,
                                 seed=1000, split="val")
    write_predictions(os.path.join(shared, "proposals", "data"), boxes,
                      noise=0.2)
    jwork = _work_dir(str(tmp_path / "jax"), shared,
                      [os.path.join(JAX_CKPT, "8000")])
    twork = _work_dir(str(tmp_path / "port"), shared,
                      [os.path.join(PORT_CKPT, "8000.pt")])

    # the checkpoint was written on a TPU: Orbax's template-free restore,
    # which JAX's CLI calls, looks for that device, so JAX's own template
    # restore (scripts/convert_jax_checkpoint.py) stands in for it
    restored = restore_jax_variables(os.path.join(jwork, "vernier_ckpt"))
    monkeypatch.setattr("snvc_tpu.training.train.load_checkpoint",
                        lambda ckpt_dir, state=None: restored[1:])
    monkeypatch.setattr(sys, "argv", ["diagnose_refinement.py",
                                      "--work_dir", jwork])
    assert jdiag.main() == 0
    got = tdiag.main(["--work_dir", twork, "--device", "cpu"])
    capsys.readouterr()
    want = json.load(open(os.path.join(jwork, "refined_diag",
                                       "report.json")))
    assert json.load(open(os.path.join(twork, "refined_diag",
                                       "report.json"))) == got
    assert list(got) == list(want) and got["step"] == want["step"] == 8000
    assert len(want) == 2 + 3 * 2
    for key, w in want.items():
        if key == "step":
            continue
        g = got[key]
        assert list(g) == list(w), key
        assert g["n"] == w["n"] > 0, key
        for k in ("center_med_m", "yaw_med_deg", "update_med_m"):
            assert abs(g[k] - w[k]) <= 1e-4, (key, k, g[k], w[k])
        for k in ("ap3d", "apbev", "ap3d_iou50"):
            assert g[k] == w[k], (key, k)
    # the refiner moved the boxes
    assert want["argmax/all_parts"]["update_med_m"] > 0.05

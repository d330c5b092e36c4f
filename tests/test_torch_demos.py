"""The port's three end-metric demos (snvc_tpu_torch/tools/demo_ap_lift.py,
demo_tracking.py, demo_two_stage.py) against the JAX package's
(tools/demo_*.py):

* their configs field for field (``build_config``, ``stereo_config``,
  ``vernier_config``) at the default flags and at changed ones;
* ``measure_proposal_error`` on the same proposal files, the noise-bank
  draws of ``--noise_mode empirical`` and the evaluator's AP@0.5;
* each demo end to end at a tiny cut on the CPU (``--device cpu``), which
  writes every key of JAX's result JSON with finite values;
* ``demo_tracking --load_ckpt`` on the model ``demo_ap_lift`` saved, and
  its refusal of a JAX (Orbax) checkpoint directory.
"""

import dataclasses
import importlib.util
import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from snvc_tpu_torch.data.kitti import KittiDataset
from snvc_tpu_torch.data.synthetic import (
    make_synthetic_kitti,
    write_predictions,
)
from snvc_tpu_torch.tools import demo_ap_lift, demo_tracking, demo_two_stage

ROOT = Path(__file__).resolve().parents[1]

# the keys JAX's demos write (tools/demo_ap_lift.py:178-198,
# demo_tracking.py:225-236, demo_two_stage.py:526-553)
AP_LIFT_KEYS = {
    "ap3d_proposals", "apbev_proposals", "steps", "noise_m",
    "ap3d_refined_one_part", "apbev_refined_one_part",
    "ap3d_refined_all_parts", "apbev_refined_all_parts", "lift_3d_moderate",
    "mean_center_err_proposal_m", "mean_center_err_refined_m"}
TRACKING_KEYS = {
    "seq_frames", "motion_m_per_frame", "tracker_err_m",
    "static_prior_err_m", "tracker_err_mean_m", "tracker_err_max_m",
    "static_prior_err_final_m", "kept_frames", "train_steps", "motion"}
TWO_STAGE_KEYS = {
    "ap3d_proposals", "apbev_proposals", "ap3d_proposals_iou50",
    "stereo_steps", "vernier_steps", "proposal_noise_loc_m",
    "proposal_noise_rot_deg", "ncf_decode", "ncf_subvoxel",
    "ap3d_refined_one_part", "apbev_refined_one_part",
    "ap3d_refined_one_part_iou50", "ap3d_refined_all_parts",
    "apbev_refined_all_parts", "ap3d_refined_all_parts_iou50",
    "ap3d_moderate_proposals", "ap3d_moderate_refined_best",
    "lift_3d_moderate"}


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread: under the tier-1 command's six workers torch's per-core
    pool runs the train steps several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_fields(port, jax_cfg):
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(jax_cfg, f.name)
        if f.name == "backbone" and not isinstance(got, str):
            assert (got.name, got.add_xy) == (want.name, want.add_xy)
        else:
            assert got == want, (f.name, got, want)


@pytest.mark.parametrize("flags", [[], ["--noise", "0.4", "--dtype",
                                        "float32", "--ncf_subvoxel",
                                        "--ncf_decode", "soft-argmax"]])
def test_ap_lift_and_tracking_configs_match_jax(flags):
    args = demo_ap_lift.parse_args(flags)
    _assert_same_fields(demo_ap_lift.build_config(args),
                        _jax_tool("demo_ap_lift").build_config(args))
    targs = demo_tracking.parse_args(
        ["--vx", "0.3", "--vz", "-0.2"] if flags else [])
    _assert_same_fields(demo_tracking.build_config(targs),
                        _jax_tool("demo_tracking").build_config(targs))


@pytest.mark.parametrize("flags", [
    [], ["--smoke"],
    ["--classes", "Car,Pedestrian,Cyclist", "--photo_aug",
     "--reg_heading_sym", "--num_hourglasses", "2", "--depth_loss", "sl1",
     "--no-depth_offset", "--ncf_subvoxel", "--dtype", "float32"]])
def test_two_stage_configs_match_jax(flags):
    jax_demo = _jax_tool("demo_two_stage")
    args = demo_two_stage.parse_args(flags)
    _assert_same_fields(demo_two_stage.stereo_config(args),
                        jax_demo.stereo_config(args))
    _assert_same_fields(demo_two_stage.vernier_config(args, 0.31, 7.5),
                        jax_demo.vernier_config(args, 0.31, 7.5))


def test_measure_proposal_error_matches_jax(tmp_path):
    """Proposals of two noise levels over one tree: some off the grid and
    some turned past the cap, which the bank drops."""
    from snvc_tpu.data.kitti import KittiDataset as JDataset

    root = str(tmp_path / "kitti")
    boxes = make_synthetic_kitti(root, num_frames=2, boxes_per_frame=3,
                                 seed=3)
    jax_demo = _jax_tool("demo_two_stage")
    for noise, seed in ((0.3, 1), (2.0, 2)):
        pred = str(tmp_path / f"pred{seed}")
        write_predictions(pred, boxes, noise=noise, seed=seed)
        logs = []
        got = demo_two_stage.measure_proposal_error(
            KittiDataset(root, "val"), pred, logs.append, rot_cap_deg=4.0)
        want = jax_demo.measure_proposal_error(
            JDataset(root, "val"), pred, lambda m: None, rot_cap_deg=4.0)
        assert got[:2] == want[:2]
        if want[2] is None:
            assert got[2] is None
        else:
            np.testing.assert_array_equal(got[2], want[2])
        assert logs


@pytest.mark.parametrize("switches", [{}, dict(dim_aug=True),
                                      dict(rot_aug=False, loc_aug=False)])
def test_perturb_box_from_a_noise_bank_matches_jax(switches):
    """``--noise_mode empirical``: draws from a bank of measured deltas,
    in JAX's order (snvc_tpu/data/instance_db.py:131)."""
    from snvc_tpu.config import VernierConfig as JConfig
    from snvc_tpu.data.instance_db import perturb_box as jperturb
    from snvc_tpu_torch.config import VernierConfig
    from snvc_tpu_torch.data.instance_db import perturb_box

    bank = np.random.default_rng(5).normal(size=(6, 7)) * 0.3
    box = np.array([1.5, 1.6, 3.9, 1.0, 1.6, 20.0, 0.3], np.float32)
    jr, tr = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(20):
        np.testing.assert_array_equal(
            perturb_box(box, VernierConfig(**switches), tr, noise_bank=bank),
            jperturb(box, JConfig(**switches), jr, noise_bank=bank))


def test_evaluator_iou_threshold_matches_jax(tmp_path):
    """``run_kitti_eval(car_min_iou=0.5)``, the demos' AP@0.5 readout."""
    from snvc_tpu.eval.kitti_ap import run_kitti_eval as jeval
    from snvc_tpu_torch.eval.kitti_ap import run_kitti_eval

    root = str(tmp_path / "kitti")
    boxes = make_synthetic_kitti(root, num_frames=2, boxes_per_frame=3,
                                 seed=6)
    write_predictions(str(tmp_path / "res" / "data"), boxes, noise=0.7)
    gt = os.path.join(root, "training", "label_2")
    res = str(tmp_path / "res")
    at_50 = run_kitti_eval(gt, res, car_min_iou=0.5)
    assert at_50 == jeval(gt, res, car_min_iou=0.5)
    assert at_50 != run_kitti_eval(gt, res)


def _assert_result(result, keys, path):
    assert set(result) == keys, set(result) ^ keys
    with open(path) as fh:
        assert json.load(fh) == result
    for k, v in result.items():
        for x in np.ravel(v if not isinstance(v, str) else []):
            assert math.isfinite(x), (k, v)


@pytest.fixture(scope="module")
def ap_lift_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ap_lift"))
    result = demo_ap_lift.main([
        "--work_dir", work, "--steps", "2", "--train_frames", "1",
        "--val_frames", "1", "--log_every", "1", "--device", "cpu"])
    return work, result


def test_demo_ap_lift_writes_jax_keys(ap_lift_run):
    work, result = ap_lift_run
    _assert_result(result, AP_LIFT_KEYS, os.path.join(work, "ap_lift.json"))
    assert result["steps"] == 2
    # the trained model is a flat model directory
    assert os.path.isfile(os.path.join(work, "2.pt"))
    assert os.path.isfile(os.path.join(work, "config.json"))


def test_demo_tracking_loads_the_port_model(ap_lift_run, tmp_path):
    work, _ = ap_lift_run
    out = str(tmp_path / "track")
    result = demo_tracking.main([
        "--work_dir", out, "--load_ckpt", work, "--seq_frames", "2",
        "--motion", "cv", "--device", "cpu"])
    _assert_result(result, TRACKING_KEYS, os.path.join(out, "tracking.json"))
    assert result["train_steps"] == 2 and len(result["tracker_err_m"]) == 2
    # the same model as a <step>.pt file
    again = demo_tracking.main([
        "--work_dir", str(tmp_path / "track_pt"), "--load_ckpt",
        os.path.join(work, "2.pt"), "--seq_frames", "2", "--motion", "cv",
        "--device", "cpu"])
    assert again["tracker_err_m"] == result["tracker_err_m"]
    # an Orbax directory is refused with the converter's name
    with pytest.raises(SystemExit, match="convert_jax_checkpoint"):
        demo_tracking.main([
            "--work_dir", out, "--device", "cpu", "--load_ckpt",
            str(ROOT / "artifacts" / "two_stage_r4" / "vernier_ckpt")])


def test_demo_tracking_trains_and_tracks(tmp_path):
    out = str(tmp_path / "track")
    result = demo_tracking.main([
        "--work_dir", out, "--steps", "1", "--train_frames", "1",
        "--seq_frames", "2", "--device", "cpu"])
    _assert_result(result, TRACKING_KEYS, os.path.join(out, "tracking.json"))
    assert result["train_steps"] == 1 and result["motion"] == "static"


def test_demo_two_stage_writes_jax_keys(tmp_path):
    work = str(tmp_path / "two_stage")
    argv = ["--work_dir", work, "--smoke", "--stereo_steps", "1",
            "--vernier_steps", "1", "--train_frames", "1", "--val_frames",
            "1", "--boxes_per_frame", "2", "--dtype", "float32",
            "--device", "cpu"]
    result = demo_two_stage.main(argv)
    _assert_result(result, TWO_STAGE_KEYS,
                   os.path.join(work, "two_stage.json"))
    for d in ("stereo_ckpt", "vernier_ckpt"):
        assert sorted(os.listdir(os.path.join(work, d))) == [
            "1.pt", "config.json"]
    # stage 1 again from its checkpoint and the proposals it wrote
    stage1 = demo_two_stage.main(argv + ["--reuse_stereo", "--stage1_only"])
    assert stage1["ap3d_proposals"] == result["ap3d_proposals"]
    assert os.path.isfile(os.path.join(work, "stage1.json"))

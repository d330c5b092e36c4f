"""Serving parity: the port's RefineRunner.step against the JAX
RefineRunner (snvc_tpu/inference/refine.py:187-224) on a tiny synthetic
batch: ROI warps + grid projection, encoder, BEV_type3 head and the
NCF -> pose update.  Float32 on both sides; boxes agree to 1e-4 m / rad,
per-part confidences to 1e-4 of their scale.

With targets (validation losses, JAX refine.py:89-118, :254-311): the
step's losses, the loss log of ``run(with_targets=True)`` over a KITTI
tree (the GT as proposals, each given its nearest GT box, LiDAR loaded)
and the inference_agnostic CLI's ``--report_loss``, each to 1e-4
relative of JAX's, for the plain head and with the offset and bbox
heads."""

import os

import numpy as np
import pytest
import torch

import __graft_entry__
import chip_smoke
from snvc_tpu.config import tiny_vernier_config as jtiny
from snvc_tpu.data.instance_db import attach_nearest_gt as jattach
from snvc_tpu.data.instance_db import build_db_from_predictions as jbuild_db
from snvc_tpu.data.kitti import KittiDataset as JDataset
from snvc_tpu.data.pipeline import InstanceBatch as JBatch
from snvc_tpu.data.pipeline import RefinementPipeline as JPipe
from snvc_tpu.inference.refine import RefineRunner as JRunner
from snvc_tpu.models.vernier import VernierScale as JVernier
from snvc_tpu_torch.config import TrainConfig
from snvc_tpu_torch.data.instance_db import (
    attach_nearest_gt,
    build_db_from_predictions,
)
from snvc_tpu_torch.data.kitti import KittiDataset
from snvc_tpu_torch.data.pipeline import RefinementPipeline
from snvc_tpu_torch.data.synthetic import synthetic_batch_arrays
from snvc_tpu_torch.inference.refine import RefineRunner as TRunner
from snvc_tpu_torch.tools import inference_agnostic as cli_refine
from snvc_tpu_torch.training.train import create_train_state, save_checkpoint
from snvc_tpu_torch.models.vernier import VernierScale as TVernier
from snvc_tpu_torch.ops.assemble import assemble_instances, make_grid_local
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_port_helpers import random_variables, torch_vernier_config


def _jax_batch(a, targets=False):
    I = a["samples"].shape[0]
    extra = (dict(gt_boxes=a["gt_boxes"], points=a["points"],
                  points_valid=a["points_valid"]) if targets else
             dict(gt_boxes=np.zeros((I, 7), np.float32),
                  points=np.zeros((I, 8, 3), np.float32),
                  points_valid=np.zeros((I, 8), bool)))
    return JBatch(
        images_left=a["images_left"], images_right=a["images_right"],
        P_left=a["P_left"], P_right=a["P_right"], image_idx=a["image_idx"],
        trans_l=a["trans_l"], trans_r=a["trans_r"], samples=a["samples"],
        valid=a["valid"], **extra)


def _runners(jcfg, seed):
    """The JAX runner and the port's on the same random variables."""
    tcfg = torch_vernier_config(jcfg)
    jmod = JVernier(jcfg)
    H, W = jcfg.resolution
    nh, nw, nl = jcfg.grid_resolution
    x = np.zeros((2, H, W, 3), np.float32)
    p = np.zeros((2, nh * nw * nl, 2), np.float32)
    v = random_variables(jmod, x, x, p, p, seed=seed)
    tmod = TVernier(tcfg, device="cpu")
    tmod.load_state_dict(convert_variables(v), strict=True)
    return (JRunner(jmod, v, jcfg), TRunner(tmod, tcfg, device="cpu"),
            tcfg)


@pytest.fixture(scope="module")
def runners():
    return _runners(__graft_entry__._tiny_cfg(max_instances=2), 21)


@pytest.fixture(scope="module", params=["plain", "heads"])
def target_runners(request):
    """At the KITTI tree's image size: the plain head, and the offset and
    bbox heads."""
    heads = request.param == "heads"
    return _runners(jtiny(max_instances=4, image_size=(384, 1248),
                          use_part_reg_head=heads, use_bbox_head=heads), 23)


def _assert_losses_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        w = float(w)
        assert abs(float(got[k]) - w) <= 1e-4 * abs(w), (k, got[k], w)


def _pipelines(jcfg, cfg, root):
    """Both packages' pipelines over the tree's GT as proposals, each
    proposal given its nearest GT box, LiDAR loaded."""
    props = os.path.join(root, "gt", "data")
    jdb = jattach(jbuild_db(JDataset(root, "val"), jcfg, props), jcfg)
    db = attach_nearest_gt(
        build_db_from_predictions(KittiDataset(root, "val"), cfg, props), cfg)
    return (JPipe(jdb, jcfg, seed=1, load_lidar=True),
            RefinementPipeline(db, cfg, seed=1, load_lidar=True))


def test_refine_step_with_targets_matches_jax(target_runners, loss_tree):
    """On a batch of the tree: chip_smoke's LiDAR points lie on the cars'
    faces, and a point exactly on a face or a voxel boundary can fall on
    either side in two float32 implementations; at the tree's points none
    does (a synthetic batch of data/synthetic.py, whose points lie on the
    faces too, flipped a few occupancy voxels, 4 of 8192 in one batch,
    and so moved the offset loss by ~4e-3)."""
    jrun, trun, cfg = target_runners
    jpipe, pipe = _pipelines(jrun.cfg, cfg, loss_tree)
    jb, b = next(iter(jpipe.batches())), next(iter(pipe.batches()))
    want = jrun.step(jb, with_targets=True)
    got = trun.step(b, with_targets=True)
    heads = {"offset", "bbox"} if cfg.use_bbox_head else set()
    assert set(got["losses"]) == {"ncf", "occupancy", "coordinates",
                                  "total"} | heads
    _assert_losses_close(got["losses"], want["losses"])
    plain = trun.step(b)  # the boxes as without targets
    assert "losses" not in plain
    for k in ("one_part", "all_parts"):
        np.testing.assert_array_equal(got[k], plain[k])


@pytest.fixture(scope="module")
def loss_tree(tmp_path_factory):
    """chip_smoke.py's seeded tree (2 frames x 3 cars) with its GT as
    proposals."""
    root = str(tmp_path_factory.mktemp("report_loss"))
    chip_smoke.write_kitti_tree(root, frames=2)
    chip_smoke.write_gt_as_predictions(
        os.path.join(root, "training", "label_2"), os.path.join(root, "gt"))
    return root


def test_run_with_targets_and_report_loss_match_jax(target_runners,
                                                    loss_tree, capsys):
    jrun, trun, cfg = target_runners
    root, props = loss_tree, os.path.join(loss_tree, "gt", "data")
    jpipe, pipe = _pipelines(jrun.cfg, cfg, root)
    want = jrun.run(jpipe, with_targets=True, progress=False, prefetch=2)
    capsys.readouterr()
    got = trun.run(pipe, with_targets=True, prefetch=2)
    printed = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 2  # a frame a batch
    for g, w in zip(got, want):
        _assert_losses_close(g, w)
    assert printed == [f"batch {i}: " + ", ".join(
        f"{k}={v:.4f}" for k, v in g.items()) for i, g in enumerate(got)]
    model_dir = os.path.join(root, f"model_{cfg.use_bbox_head}")
    save_checkpoint(model_dir, create_train_state(trun.model, cfg,
                                                  TrainConfig()), cfg, 1)
    trun.model.eval()
    res = cli_refine.main([
        "--model_dir", model_dir, "--data_path", root, "--pred_dir", props,
        "--output_dir", os.path.join(root, f"out_{cfg.use_bbox_head}"),
        "--device", "cpu", "--report_loss", "--prefetch", "0"])
    assert res["losses"] == got

@pytest.mark.parametrize("seed", [0, 1])
def test_refine_step_matches_jax(runners, seed):
    jrun, trun, cfg = runners
    arrays = synthetic_batch_arrays(cfg, seed=seed)
    want = jrun.step(_jax_batch(arrays))
    got = trun.step(arrays)
    for k in ("one_part", "all_parts"):
        assert got[k].shape == (2, 7)
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0,
                                   err_msg=k)
    scale = np.abs(want["confidence"]).max()
    np.testing.assert_allclose(got["confidence"], want["confidence"],
                               atol=1e-4 * scale, rtol=0)
    np.testing.assert_array_equal(got["keep"], want["keep"])
    # the dense outputs stay on the device (here: CPU tensors)
    assert isinstance(got["ncf"], torch.Tensor)
    np.testing.assert_allclose(got["ncf"].numpy(), np.asarray(want["ncf"]),
                               atol=1e-4 * np.abs(want["ncf"]).max(), rtol=0)


def test_assemble_matches_jax():
    import jax.numpy as jnp

    from snvc_tpu.ops.assemble import assemble_instances as jassemble
    from snvc_tpu.ops.assemble import make_grid_local as jgrid

    jcfg = __graft_entry__._tiny_cfg(max_instances=2)
    tcfg = torch_vernier_config(jcfg)
    a = synthetic_batch_arrays(tcfg, seed=5)
    keys = ("images_left", "images_right", "image_idx", "trans_l", "trans_r",
            "samples", "P_left", "P_right")
    grid = make_grid_local(tcfg)
    np.testing.assert_array_equal(grid, jgrid(jcfg))
    want = jassemble(*(jnp.asarray(a[k]) for k in keys), jnp.asarray(grid),
                     jcfg)
    got = assemble_instances(*(torch.as_tensor(a[k]) for k in keys),
                             torch.from_numpy(grid), tcfg)
    names = ("left_rois", "right_rois", "grid_proj_l", "grid_proj_r")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_runner_default_device_needs_cuda(runners):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is valid")
    _, trun, cfg = runners
    with pytest.raises(RuntimeError, match="cuda"):
        TRunner(trun.model, cfg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("values", [(0.485, 0.456, 0.406),
                                    np.array([[0.0, 0.5], [-0.5, 1.65]])])
def test_constant_equals_torch_tensor(values, dtype):
    """The serving path's sync-free constants hold the bits that
    ``torch.tensor(values, dtype=dtype)`` gives."""
    from snvc_tpu_torch.utils.device import constant

    got = constant(values, torch.device("cpu"), dtype)
    want = torch.tensor(values, dtype=dtype)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)

"""The port's data pipelines against the JAX package on the same KITTI
tree: snvc_tpu_torch/data/{instance_db,pipeline,stereo_pipeline}.py
against snvc_tpu/data/{instance_db,pipeline,stereo_pipeline}.py.

Host numpy code on the same inputs and the same ``np.random.Generator``
streams, so every array is held to equality: the instance DBs from
prediction files and from the GT, the Vernier batches at inference and
with seeded ``sup_type="synthetic"`` perturbations (also with the FOV
check and two frames a batch), and the stereo batches for serving and
for training with the exact stereo flip at a seed.
"""

import dataclasses
import os

import numpy as np
import pytest

from snvc_tpu import config as jconfig
from snvc_tpu.data import instance_db as jdb
from snvc_tpu.data.kitti import KittiDataset as JDataset
from snvc_tpu.data.pipeline import RefinementPipeline as JPipe
from snvc_tpu.data.stereo_pipeline import StereoPipeline as JStereoPipe
from snvc_tpu.data.synthetic import make_synthetic_kitti, write_predictions
from snvc_tpu_torch import config as tconfig
from snvc_tpu_torch.data import instance_db as tdb
from snvc_tpu_torch.data.kitti import KittiDataset
from snvc_tpu_torch.data.pipeline import RefinementPipeline
from snvc_tpu_torch.data.stereo_pipeline import StereoPipeline
from tests.torch_port_helpers import torch_vernier_config


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_pipe"))
    boxes = make_synthetic_kitti(root, num_frames=2, boxes_per_frame=2,
                                 seed=6)
    pred_dir = os.path.join(root, "proposals")
    write_predictions(pred_dir, boxes, noise=0.2)
    return root, pred_dir


def _configs(**kw):
    jc = jconfig.tiny_vernier_config(max_instances=2, image_size=(384, 1248),
                                     **kw)
    return jc, torch_vernier_config(jc)


def _same_records(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.scene.index == w.scene.index
        for k in ("label", "pred", "box2d"):
            a, b = getattr(g, k), getattr(w, k)
            assert (a is None) == (b is None), k
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=k)
        np.testing.assert_array_equal(g.score, w.score)
        np.testing.assert_array_equal(g.calib_left.P, w.calib_left.P)
        np.testing.assert_array_equal(g.calib_right.P, w.calib_right.P)


def test_db_from_predictions_equals_jax(tree):
    root, pred_dir = tree
    jc, tc = _configs()
    want = jdb.build_db_from_predictions(JDataset(root, "val"), jc, pred_dir)
    got = tdb.build_db_from_predictions(KittiDataset(root, "val"), tc,
                                        pred_dir)
    _same_records(got, want)
    _same_records(tdb.attach_nearest_gt(got, tc),
                  jdb.attach_nearest_gt(want, jc))


def test_db_from_gt_equals_jax(tree):
    root, _ = tree
    jc, tc = _configs(usage="train", augment=True, augment_times=2)
    want = jdb.build_db_from_gt(JDataset(root, "val"), jc)
    got = tdb.build_db_from_gt(KittiDataset(root, "val"), tc)
    assert len(got) == 8
    _same_records(got, want)


def _same_batches(got_pipe, want_pipe):
    assert len(got_pipe) == len(want_pipe)
    n = 0
    for g, w in zip(got_pipe.batches(), want_pipe.batches()):
        ga, wa = g.arrays(), w.arrays()
        assert ga.keys() == wa.keys()
        for k in wa:
            assert ga[k].dtype == wa[k].dtype, k
            np.testing.assert_array_equal(ga[k], wa[k], err_msg=k)
        assert g.scene_names == w.scene_names
        np.testing.assert_array_equal(g.box2d, w.box2d)
        np.testing.assert_array_equal(g.scores, w.scores)
        n += 1
    assert n == len(want_pipe) > 0


def test_refinement_batches_at_inference_equal_jax(tree):
    root, pred_dir = tree
    jc, tc = _configs()
    want = JPipe(jdb.build_db_from_predictions(JDataset(root, "val"), jc,
                                               pred_dir),
                 jc, training=False, load_lidar=True, max_points=512)
    got = RefinementPipeline(
        tdb.build_db_from_predictions(KittiDataset(root, "val"), tc,
                                      pred_dir),
        tc, training=False, load_lidar=True, max_points=512)
    _same_batches(got, want)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(check_fov=True, dim_aug=True, frames_per_batch=2),
])
def test_refinement_batches_synthetic_equal_jax(tree, kw):
    """Seeded perturbations around the GT: the same draws in order."""
    root, _ = tree
    jc, tc = _configs(sup_type="synthetic", usage="train", std_rot=15.0,
                      **kw)
    want = JPipe(jdb.build_db_from_gt(JDataset(root, "val"), jc), jc,
                 training=True, seed=3, max_points=256)
    got = RefinementPipeline(tdb.build_db_from_gt(KittiDataset(root, "val"),
                                                  tc),
                             tc, training=True, seed=3, max_points=256)
    _same_batches(got, want)


def _stereo_configs(**kw):
    jc = jconfig.tiny_stereo_config(z_max=38.0, max_depth=40.0, **kw)
    tc = tconfig.StereoConfig(**{f.name: getattr(jc, f.name)
                                 for f in dataclasses.fields(
                                     tconfig.StereoConfig)})
    return jc, tc


@pytest.mark.parametrize("training,flip,input_size", [
    (False, False, (64, 128)),
    (False, False, (384, 1248)),
    (True, True, (64, 128)),
    (True, True, (384, 1248)),
])
def test_stereo_batches_equal_jax(tree, training, flip, input_size):
    root, _ = tree
    jc, tc = _stereo_configs(input_size=input_size)
    kw = dict(batch_size=2 if training else 1, training=training,
              augment_flip=flip, seed=4)
    want = JStereoPipe(JDataset(root, "val"), jc, **kw)
    got = StereoPipeline(KittiDataset(root, "val"), tc, **kw)
    assert len(got) == len(want)
    seen = set()
    for rep in range(2 if flip else 1):
        for g, w in zip(got.batches(), want.batches()):
            ga, wa = g.arrays(), w.arrays()
            assert ga.keys() == wa.keys()
            for k in wa:
                assert ga[k].dtype == wa[k].dtype, k
                np.testing.assert_array_equal(ga[k], wa[k], err_msg=k)
            assert g.scene_names == w.scene_names
            if training:
                assert ga["gt_valid"].any() and (ga["depth_gt"] > 0).any()
            seen |= set(ga["P_left"][:, 0, 3].tolist())
    # a flipped frame's P_left is F @ P_right @ M, with another x offset
    assert len(seen) == (2 if flip else 1)


@pytest.mark.parametrize("batch_size", [1, 3])
def test_stereo_index_groups_equal_jax(tree, batch_size):
    """``StereoPipeline.index_groups`` (JAX stereo_pipeline.py:102-113):
    the frame groups of each batch, the last padded with its final
    frame."""
    root, _ = tree
    jc, tc = _stereo_configs()
    want = JStereoPipe(JDataset(root, "val"), jc, batch_size=batch_size)
    got = StereoPipeline(KittiDataset(root, "val"), tc,
                         batch_size=batch_size)
    assert got.index_groups() == want.index_groups()
    assert all(len(g) == batch_size for g in got.index_groups())


@pytest.mark.parametrize("make", ["tiny", "tiny_8x16x16", "default"])
def test_vernier_derived_quantities_equal_jax(make):
    """``VernierConfig.n_sample_h / _w / _l``, ``grid_range`` and
    ``spacing`` (JAX config.py:232-260)."""
    jc = {"tiny": jconfig.tiny_vernier_config,
          "tiny_8x16x16": lambda: jconfig.tiny_vernier_config(
              grid_resolution=(8, 16, 16), x_range=(-1.5, 2.0)),
          "default": jconfig.VernierConfig}[make]()
    tc = torch_vernier_config(jc)
    for k in ("n_sample_h", "n_sample_w", "n_sample_l", "grid_range",
              "spacing"):
        assert getattr(tc, k) == getattr(jc, k), k

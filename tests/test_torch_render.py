"""The port's synthetic KITTI world (snvc_tpu_torch/data/synthetic.py)
against the JAX package's (snvc_tpu/data/synthetic.py), which renders
with cv2:

* ``render_scene``: the uint8 image bit for bit, left and right, for a
  few seeds and box counts, with boxes near the image edges and one
  behind another;
* ``make_synthetic_kitti`` (two frames; Car alone and all three classes)
  and ``make_synthetic_sequence`` (three frames): every label, calib,
  velodyne, split and stamp file byte for byte, every PNG decoded by the
  port's ``decode_png`` equal to what cv2 reads from JAX's tree, the
  returned boxes equal;
* reuse: a complete tree is read back without a render, a changed stamp
  renders again.
"""

import filecmp
import json
import os

import cv2
import numpy as np
import pytest

from snvc_tpu.data import synthetic as jsyn
from snvc_tpu.geometry.calib import Calibration as JCalib
from snvc_tpu_torch.data import synthetic as tsyn
from snvc_tpu_torch.data.png import decode_png
from snvc_tpu_torch.geometry.calib import Calibration as TCalib


def _boxes(seed):
    rng = np.random.default_rng(seed)
    n = 1 + seed % 4
    boxes = np.stack([jsyn.random_box(rng) for _ in range(n)])
    if n >= 2:  # one box at the left edge, close
        boxes[0, 3:6] = [-9.0, 1.7, 12.0]
    if n >= 3:  # one straight behind another
        boxes[1, 3:6] = boxes[2, 3:6] + [0.3, 0.0, 6.0]
    if n >= 4:  # at the right edge, far
        boxes[3, 3:6] = [14.0, 1.6, 34.0]
    return boxes


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("camera", ["left", "right"])
def test_render_scene_matches_jax_bits(seed, camera):
    boxes = _boxes(seed)
    tex = [1000 + 7 * i for i in range(len(boxes))]
    jc = JCalib.default() if camera == "left" else JCalib.default_right()
    tc = TCalib.default() if camera == "left" else TCalib.default_right()
    want = jsyn.render_scene(boxes, jc, np.random.default_rng(seed + 50),
                             tex_ids=tex)
    rng = np.random.default_rng(seed + 50)
    got = tsyn.render_scene(boxes, tc, rng, tex_ids=tex)
    assert got.dtype == np.uint8 and got.shape == (tsyn.IMG_H, tsyn.IMG_W, 3)
    bad = np.argwhere(got != want)
    assert not len(bad), f"{len(bad)} values differ, first {bad[:4]}"
    # the noise is the stream's one draw: the two streams stay in step
    jr = np.random.default_rng(seed + 50)
    jsyn.render_scene(boxes, jc, jr, tex_ids=tex)
    assert rng.integers(1 << 30) == jr.integers(1 << 30)


def test_constants_match_jax():
    assert (tsyn.IMG_H, tsyn.IMG_W) == (jsyn.IMG_H, jsyn.IMG_W)
    assert tsyn.GROUND_Y == jsyn.GROUND_Y
    assert tsyn.SYNTH_VERSION == jsyn.SYNTH_VERSION
    for tid, fi in [(0, 0), (17, 3), (2**31 - 2, 5)]:
        np.testing.assert_array_equal(tsyn._face_texture(tid, fi),
                                      jsyn._face_texture(tid, fi))
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_array_equal(tsyn.random_car_box(a),
                                  jsyn.random_car_box(b))


def _assert_trees_equal(jroot, troot):
    """Every file of JAX's tree has its twin in the port's: PNGs decode to
    the same pixels, everything else is equal byte for byte."""
    n = 0
    for dirpath, _, files in os.walk(jroot):
        for f in files:
            jp = os.path.join(dirpath, f)
            tp = os.path.join(troot, os.path.relpath(jp, jroot))
            assert os.path.isfile(tp), tp
            if f.endswith(".png"):
                want = cv2.cvtColor(cv2.imread(jp), cv2.COLOR_BGR2RGB)
                np.testing.assert_array_equal(decode_png(tp), want,
                                              err_msg=tp)
            else:
                assert filecmp.cmp(jp, tp, shallow=False), tp
            n += 1
    m = sum(len(files) for _, _, files in os.walk(troot))
    assert n == m, (n, m)
    return n


@pytest.mark.parametrize("classes", [("Car",),
                                     ("Car", "Pedestrian", "Cyclist")])
def test_make_synthetic_kitti_matches_jax_files(tmp_path, classes):
    kw = dict(num_frames=2, boxes_per_frame=3, seed=4, split="val",
              classes=classes)
    want = jsyn.make_synthetic_kitti(str(tmp_path / "jax"), **kw)
    got = tsyn.make_synthetic_kitti(str(tmp_path / "port"), **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # 2 frames x (2 images, calib, label, velodyne) + split + stamp
    assert _assert_trees_equal(str(tmp_path / "jax"),
                               str(tmp_path / "port")) == 12
    stamp = json.load(open(tmp_path / "port" / "val.stamp.json"))
    assert ("classes" in stamp) == (classes != ("Car",))


def test_make_synthetic_sequence_matches_jax_files(tmp_path):
    kw = dict(num_frames=3, seed=9, velocity=(0.2, 0.0, -0.5),
              yaw_rate=0.03)
    want = jsyn.make_synthetic_sequence(str(tmp_path / "jax"), **kw)
    got = tsyn.make_synthetic_sequence(str(tmp_path / "port"), **kw)
    for g, w in zip(got, want):
        assert g.shape == (1, 7)
        np.testing.assert_array_equal(g, w)
    assert _assert_trees_equal(str(tmp_path / "jax"),
                               str(tmp_path / "port")) == 16


def test_reuse_reads_a_complete_tree_and_rerenders_a_changed_stamp(
        tmp_path, monkeypatch):
    root = str(tmp_path)
    first = tsyn.make_synthetic_kitti(root, num_frames=2, boxes_per_frame=2,
                                      seed=1, split="train")
    renders = []
    real = tsyn.render_scene
    monkeypatch.setattr(tsyn, "render_scene",
                        lambda *a, **k: renders.append(1) or real(*a, **k))
    again = tsyn.make_synthetic_kitti(root, num_frames=2, boxes_per_frame=2,
                                      seed=1, split="train")
    assert renders == []
    # read back from the labels' 8 significant digits, as JAX reads them
    jback = jsyn.make_synthetic_kitti(root, num_frames=2, boxes_per_frame=2,
                                      seed=1, split="train")
    for a, j, b in zip(again, jback, first):
        np.testing.assert_array_equal(a, j)
        np.testing.assert_allclose(a, b, rtol=1e-6)
    # another seed: the stamp differs, the tree is rendered again
    other = tsyn.make_synthetic_kitti(root, num_frames=2, boxes_per_frame=2,
                                      seed=2, split="train")
    assert len(renders) == 4  # 2 frames x 2 views
    assert not np.array_equal(other[0], first[0])
    assert json.load(open(os.path.join(root, "train.stamp.json")))["seed"] == 2
    # reuse=False renders even under the same stamp
    tsyn.make_synthetic_kitti(root, num_frames=2, boxes_per_frame=2, seed=2,
                              split="train", reuse=False)
    assert len(renders) == 8

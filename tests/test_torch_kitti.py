"""The port's KITTI host layer against the JAX package on the same tree:
snvc_tpu_torch/{data/kitti,geometry/calib,config}.py against
snvc_tpu/{data/kitti,geometry/calib,config}.py.

Host numpy code on the same inputs, so everything is held to equality:
the split, labels, calibration matrices, LiDAR, the native image size,
the decoded / padded / downscaled images, label strings and the
annotation filter.  ``load_config`` reads both committed ``config.json``
files and refuses what the port cannot honour.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from snvc_tpu import config as jconfig
from snvc_tpu.data.kitti import KittiDataset as JDataset
from snvc_tpu.data.synthetic import make_synthetic_kitti
from snvc_tpu.geometry import calib as jcalib
from snvc_tpu_torch import config as tconfig
from snvc_tpu_torch.data.kitti import KittiDataset, read_split
from snvc_tpu_torch.geometry import calib as tcalib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = os.path.join(ROOT, "artifacts", "two_stage_r4")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_layer"))
    make_synthetic_kitti(root, num_frames=2, boxes_per_frame=2, seed=5)
    return root


def test_dataset_and_scenes_equal_jax(tree):
    jds, tds = JDataset(tree, "val"), KittiDataset(tree, "val")
    assert tds.indices == jds.indices == read_split(
        os.path.join(tree, "val.txt"))
    assert len(tds) == len(jds) == 2
    for attr in ("image_dir", "right_image_dir", "calib_dir", "lidar_dir",
                 "label_dir"):
        assert getattr(tds, attr) == getattr(jds, attr), attr
    for js, ts in zip(jds.scenes(), tds.scenes()):
        assert ts.name == js.name
        assert ts.native_image_size() == js.native_image_size() == (375, 1242)
        np.testing.assert_array_equal(ts.lidar(), js.lidar())
        for jl, tl in zip(js.labels(), ts.labels()):
            assert dataclasses.astuple(tl)[:4] == dataclasses.astuple(jl)[:4]
            np.testing.assert_array_equal(tl.box2d, jl.box2d)
            np.testing.assert_array_equal(tl.box3d, jl.box3d)
            assert tl.score == jl.score
        for cam in ("left", "right"):
            jc, tc = js.calibration(cam), ts.calibration(cam)
            for m in ("P", "V2C", "C2V", "R0"):
                np.testing.assert_array_equal(getattr(tc, m), getattr(jc, m))
            assert tc.baseline == jc.baseline
            np.testing.assert_array_equal(tc.as_array(), jc.as_array())
            np.testing.assert_array_equal(ts.load_image(cam),
                                          js.load_image(cam))
            for hw in ((384, 1248), (300, 1000)):
                np.testing.assert_array_equal(
                    ts.load_image_padded(cam, hw),
                    js.load_image_padded(cam, hw))
            for hw in ((96, 320), (64, 128), (384, 1248)):
                (ti, tsc), (ji, jsc) = (ts.load_image_scaled(cam, hw),
                                        js.load_image_scaled(cam, hw))
                assert tsc == jsc
                np.testing.assert_array_equal(ti, ji)


def test_calibration_transforms_equal_jax(tree):
    ts = KittiDataset(tree, "val").scene(0)
    tc = ts.calibration("left")
    jc = jcalib.Calibration.from_file(ts.calib_path, "left")
    rng = np.random.default_rng(0)
    pts = rng.uniform([-10, -2, 2], [10, 3, 40], size=(50, 3))
    uvd = np.concatenate([rng.uniform(0, 1200, (50, 2)),
                          rng.uniform(2, 40, (50, 1))], axis=1)
    for fn, arg in (("velo_to_rect", pts), ("rect_to_velo", pts),
                    ("rect_to_image", pts), ("image_to_rect", uvd)):
        np.testing.assert_array_equal(getattr(tc, fn)(arg),
                                      getattr(jc, fn)(arg), err_msg=fn)
    np.testing.assert_array_equal(tc.rect_to_image(pts, keep_z=True),
                                  jc.rect_to_image(pts, keep_z=True))
    for x, z, a in rng.uniform([-10, 2, -3], [10, 40, 3], size=(20, 3)):
        assert tcalib.alpha_to_ry(x, z, a) == jcalib.alpha_to_ry(x, z, a)
        assert tcalib.ry_to_alpha(x, z, a) == jcalib.ry_to_alpha(x, z, a)


_LINES = [
    "Car 0.00 0 -1.58 587.01 173.33 614.12 200.12 1.65 1.67 3.64 -0.65 "
    "1.71 46.70 -1.59",
    "Van 0.90 1 1.20 100.0 150.0 200.0 250.0 2.1 1.9 5.0 3.0 1.7 20.0 1.1",
    "Pedestrian 0.10 2 0.30 700.5 160.2 720.0 230.0 1.8 0.6 0.8 2.0 1.6 "
    "12.0 0.2 0.734",
    "DontCare -1 -1 -10 503.89 169.71 590.61 190.13 -1 -1 -1 -1000 -1000 "
    "-1000 -10",
    "Truck 0.0 0 0.1 1 2 3 4 3.0 2.5 8.0 1.0 1.7 30.0 0.0",
    "Car 0.99 0 0.5 10 20 30 40 1.5 1.6 4.0 -5.0 1.7 70.0 0.4 0.25",
    "Cyclist 0.2 1 -0.4 300 170 340 240 1.7 0.6 1.8 -3.0 1.6 15.0 -0.3",
    "Misc 0 0 0 1 2 3 4 1 1 1 1 1 10 0",
]


def test_label_lines_equal_jax():
    for line in _LINES:
        jl, tl = jcalib.parse_label_line(line), tcalib.parse_label_line(line)
        assert tcalib.format_label(tl) == jcalib.format_label(jl)
        assert tcalib.format_label(tl, 4) == jcalib.format_label(jl, 4)
        np.testing.assert_array_equal(tl.box3d, jl.box3d)
        assert (tl.h, tl.w, tl.l, tl.ry) == (jl.h, jl.w, jl.l, jl.ry)
        np.testing.assert_array_equal(tl.location, jl.location)
    assert tcalib.CLASS_IDS == jcalib.CLASS_IDS
    assert tcalib.SKIP_TYPES == jcalib.SKIP_TYPES


@pytest.mark.parametrize("kw", [
    dict(),
    dict(valid_classes=(2,), depth_range=(0.0, 60.0),
         truncation_threshold=0.8),
    dict(valid_classes=(2,), ignore_truncation=False),
    dict(valid_classes=(1, 3, 4), depth_range=(10.0, 50.0)),
])
def test_filter_annotations_equal_jax(kw):
    jl = [jcalib.parse_label_line(s) for s in _LINES]
    tl = [tcalib.parse_label_line(s) for s in _LINES]
    want = jcalib.filter_annotations(jl, **kw)
    got = tcalib.filter_annotations(tl, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_filter_annotations_rejects_unknown_type():
    bad = tcalib.parse_label_line("Boat 0 0 0 1 2 3 4 1 1 1 1 1 10 0")
    with pytest.raises(ValueError, match="Boat"):
        tcalib.filter_annotations([bad])


@pytest.mark.parametrize("name,cls,jcls", [
    ("vernier_ckpt", tconfig.VernierConfig, jconfig.VernierConfig),
    ("stereo_ckpt", tconfig.StereoConfig, jconfig.StereoConfig),
])
def test_load_config_reads_committed_files(name, cls, jcls):
    path = os.path.join(CKPTS, name, "config.json")
    got = tconfig.load_config(path, cls)
    want = jconfig.load_config(path, jcls)
    for f in dataclasses.fields(cls):
        if f.name == "backbone" and cls is tconfig.VernierConfig:
            assert got.backbone.name == want.backbone.name
            assert got.backbone.add_xy == want.backbone.add_xy
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_load_config_reads_port_files_and_nested(tmp_path):
    cfg = tconfig.tiny_vernier_config(pred_type=("one_part", "all_parts"),
                                      valid_classes=(1, 2))
    p = tmp_path / "config.json"
    p.write_text(json.dumps(dataclasses.asdict(cfg)))
    assert tconfig.load_config(str(p), tconfig.VernierConfig) == cfg
    scfg = tconfig.tiny_stereo_config(class_names=("Car",))
    p.write_text(json.dumps({"vernier": dataclasses.asdict(cfg),
                             "stereo": dataclasses.asdict(scfg)}))
    assert tconfig.load_config(str(p), tconfig.StereoConfig) == scfg


@pytest.mark.parametrize("cls,jcls", [
    (tconfig.VernierConfig, jconfig.VernierConfig),
    (tconfig.StereoConfig, jconfig.StereoConfig),
    (tconfig.BackboneConfig, jconfig.BackboneConfig),
])
def test_every_jax_field_is_held_or_listed_unread(cls, jcls):
    """The JAX schema is covered: each field is the port's or in the one
    list of unread fields, and every default the port holds is JAX's."""
    jf = {f.name for f in dataclasses.fields(jcls)}
    tf = {f.name for f in dataclasses.fields(cls)}
    assert jf - tf == set(tconfig._UNREAD[cls.__name__])
    if cls is not tconfig.BackboneConfig:
        jd, td = jcls(), cls()
        for name in tf - {"backbone"}:
            assert getattr(td, name) == getattr(jd, name), name


def _config_file(tmp_path, d, key, value):
    if key.startswith("backbone."):
        d["backbone"][key.split(".")[1]] = value
    else:
        d[key] = value
    p = tmp_path / "config.json"
    p.write_text(json.dumps(d))
    return str(p)


@pytest.mark.parametrize("cls,key,value", [
    (tconfig.StereoConfig, "no_such_field", True),
    (tconfig.VernierConfig, "no_such_field", 1),
])
def test_load_config_refuses(tmp_path, cls, key, value):
    p = _config_file(tmp_path, dataclasses.asdict(cls()), key, value)
    with pytest.raises(ValueError, match=key.split(".")[-1]):
        tconfig.load_config(p, cls)


@pytest.mark.parametrize("key,value", [
    ("vernier_type", "3D"),
    ("vernier_type", "BEV"),
    ("vernier_type", "BEV_type2"),
    ("feature_aggregation", "concat-atten"),
    ("backbone.head_type", "heatmap_regression"),
    ("backbone.head_type", "classification"),
    ("backbone.add_xy", True),
    ("backbone.name", "hrnet-w48"),
])
def test_load_config_takes_variants(tmp_path, key, value):
    """A JAX config.json of each variant loads with its value."""
    p = _config_file(tmp_path, jconfig.VernierConfig().to_dict(), key, value)
    cfg = tconfig.load_config(p, tconfig.VernierConfig)
    owner = cfg.backbone if key.startswith("backbone.") else cfg
    assert getattr(owner, key.split(".")[-1]) == value


def test_load_config_takes_photometric_aug(tmp_path):
    """A stereo config.json with the jitter on loads with it on (the port
    trains with it: training/train_stereo.augment_normalize)."""
    d = dataclasses.asdict(jconfig.StereoConfig(photometric_aug=True))
    p = tmp_path / "config.json"
    p.write_text(json.dumps(d))
    assert tconfig.load_config(str(p), tconfig.StereoConfig).photometric_aug

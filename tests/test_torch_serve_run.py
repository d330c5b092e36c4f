"""Two-stage serving over a KITTI tree, the port against the JAX package:
``DetectRunner.run`` -> proposal files, ``build_db_from_predictions`` ->
``RefinementPipeline`` -> ``RefineRunner.run`` + ``PredictionWriter`` on
those proposals, then ``run_kitti_eval``; each in JAX and in the port,
float32 on the CPU, with the same weights (tiny configs).

* Stage 1 writes the same files as JAX's, and stage 2 on JAX's proposals
  the same files as JAX's stage 2, with the same lines in the same order; every number agrees within 1e-4 of its output's scale (the
  rule of test_torch_vernier.py: the largest magnitude of the 3D boxes,
  of the 2D boxes, of alpha and of the scores, each over the file) plus
  1e-6, the last printed digit; truncation and occlusion exactly.
* The port's evaluator gives JAX's dict on the same directories.
* ``prefetch=2`` writes the same bytes as ``prefetch=0``.
* chip_smoke.py's seeded tree: the decoder gives the written arrays back,
  and its pinned AP values are JAX's.
* Each CLI's ``main(argv)`` with ``--device cpu`` writes what the runners
  wrote; without ``--device`` it asks for the card and raises here.
"""

import os

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from snvc_tpu.config import tiny_stereo_config as jax_stereo_tiny
from snvc_tpu.config import tiny_vernier_config as jax_vernier_tiny
from snvc_tpu.data.instance_db import build_db_from_predictions as jbuild_db
from snvc_tpu.data.kitti import KittiDataset as JDataset
from snvc_tpu.data.pipeline import RefinementPipeline as JPipe
from snvc_tpu.data.synthetic import make_synthetic_kitti
from snvc_tpu.eval.kitti_ap import run_kitti_eval as jax_eval
from snvc_tpu.geometry.calib import Calibration as JCalib
from snvc_tpu.inference.detect import DetectRunner as JDetect
from snvc_tpu.inference.kitti_writer import PredictionWriter as JWriter
from snvc_tpu.inference.refine import RefineRunner as JRefine
from snvc_tpu.models.stereonet import StereoNet as JNet
from snvc_tpu.models.vernier import VernierScale as JVernier
from snvc_tpu_torch.config import TrainConfig
from snvc_tpu_torch.data.instance_db import build_db_from_predictions
from snvc_tpu_torch.data.kitti import KittiDataset
from snvc_tpu_torch.data.pipeline import RefinementPipeline
from snvc_tpu_torch.data.png import decode_png
from snvc_tpu_torch.eval.kitti_ap import run_kitti_eval
from snvc_tpu_torch.inference.detect import DetectRunner
from snvc_tpu_torch.inference.kitti_writer import PredictionWriter
from snvc_tpu_torch.inference.refine import RefineRunner
from snvc_tpu_torch.models.stereonet import StereoNet
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.tools import detect as cli_detect
from snvc_tpu_torch.tools import evaluate as cli_evaluate
from snvc_tpu_torch.tools import inference_agnostic as cli_refine
from snvc_tpu_torch.training.train import create_train_state, save_checkpoint
from snvc_tpu_torch.training.train_stereo import create_stereo_state
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_port_helpers import random_variables, torch_vernier_config

DETECT = dict(max_boxes=4, score_threshold=0.0, nms_iou=0.5)
PRED_TYPES = ("one_part", "all_parts")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: the tier-1 command runs this file
    beside five other workers, and torch's thread pool, one thread a core,
    then runs ~20x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read_dir(d):
    return {f: open(os.path.join(d, f)).read() for f in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both packages' two stages over one 2-frame tree; the port's with
    prefetch 2 and 0."""
    root = str(tmp_path_factory.mktemp("serve_run"))
    make_synthetic_kitti(root, num_frames=2, boxes_per_frame=2, seed=2)
    jds, tds = JDataset(root, "val"), KittiDataset(root, "val")

    jscfg = jax_stereo_tiny(z_max=38.0, max_depth=40.0)
    H, W = jscfg.input_size
    x = np.zeros((1, H, W, 3), np.float32)
    P = JCalib.default().as_array()[None]
    svars = random_variables(JNet(jscfg), x, x, P, P, seed=31)
    smodel = StereoNet(_torch_stereo_cfg(jscfg), device="cpu")
    smodel.load_state_dict(convert_variables(svars), strict=True)
    tscfg = smodel.cfg

    # the filter gate opened: a random model's NCF would reject every
    # update, and the refined files would repeat the proposals
    jvcfg = jax_vernier_tiny(max_instances=2, image_size=(384, 1248),
                             pred_type=PRED_TYPES, filter_min=-1e9,
                             filter_max=1e9)
    tvcfg = torch_vernier_config(jvcfg)
    jvmod = JVernier(jvcfg)
    h, w = jvcfg.resolution
    nh, nw, nl = jvcfg.grid_resolution
    r = np.zeros((1, h, w, 3), np.float32)
    p = np.zeros((1, nh * nw * nl, 2), np.float32)
    vvars = random_variables(jvmod, r, r, p, p, seed=32)
    vmodel = VernierScale(tvcfg, device="cpu")
    vmodel.load_state_dict(convert_variables(vvars), strict=True)

    out = {}
    JDetect(jscfg, svars, **DETECT).run(jds, os.path.join(root, "j1"),
                                        prefetch=2)
    jdb = jbuild_db(jds, jvcfg, os.path.join(root, "j1", "data"))
    jw = JWriter(jvcfg)
    JRefine(jvmod, vvars, jvcfg).run(JPipe(jdb, jvcfg, load_lidar=False),
                                     writer=jw, progress=False, prefetch=2)
    jw.write(os.path.join(root, "j2"))

    tdet = DetectRunner(smodel, tscfg, device="cpu", **DETECT)
    tref = RefineRunner(vmodel, tvcfg, device="cpu")

    def refine(pred_dir, out_dir, prefetch):
        db = build_db_from_predictions(tds, tvcfg, pred_dir)
        tw = PredictionWriter(tvcfg)
        tref.run(RefinementPipeline(db, tvcfg, load_lidar=False), writer=tw,
                 progress=False, prefetch=prefetch)
        tw.write(os.path.join(root, out_dir))

    for pf in (2, 0):
        out[f"t1_{pf}"] = tdet.run(tds, os.path.join(root, f"t1_{pf}"),
                                   prefetch=pf)
        # stage 2 on JAX's proposals: the stage is compared alone
        refine(os.path.join(root, "j1", "data"), f"t2_{pf}", pf)
    # and on the port's own, for the CLIs
    refine(os.path.join(root, "t1_2", "data"), "chain", 2)
    return dict(root=root, smodel=smodel, vmodel=vmodel, counts=out)


def _torch_stereo_cfg(jc):
    import dataclasses

    from snvc_tpu_torch.config import StereoConfig

    return StereoConfig(**{f.name: getattr(jc, f.name)
                           for f in dataclasses.fields(StereoConfig)})


def _assert_files_close(got_dir, want_dir):
    got, want = _read_dir(got_dir), _read_dir(want_dir)
    assert list(got) == list(want) and want
    n_lines = 0
    for f in want:
        gl, wl = got[f].splitlines(), want[f].splitlines()
        assert len(gl) == len(wl), f
        if not wl:
            continue
        gv = np.array([[float(v) for v in ln.split()[1:]] for ln in gl])
        wv = np.array([[float(v) for v in ln.split()[1:]] for ln in wl])
        assert [ln.split()[0] for ln in gl] == [ln.split()[0] for ln in wl]
        # columns: trunc, occ | alpha | 2D box | h w l x y z ry | score
        scale = np.zeros(wv.shape[1])
        for cols in (slice(2, 3), slice(3, 7), slice(7, 14), slice(14, 15)):
            scale[cols] = np.abs(wv[:, cols]).max()
        tol = 1e-4 * scale + 1e-6
        assert (np.abs(gv - wv) <= tol).all(), (f, np.abs(gv - wv).max(0))
        n_lines += len(wl)
    return n_lines


def test_stage1_files_match_jax(run):
    root = run["root"]
    n = _assert_files_close(os.path.join(root, "t1_2", "data"),
                            os.path.join(root, "j1", "data"))
    assert n == run["counts"]["t1_2"] == 2 * DETECT["max_boxes"]


def test_stage2_files_match_jax(run):
    """Both refiners on JAX's proposals (on each package's own, stage 1's
    differences move the crops, and an argmax can step a voxel)."""
    root = run["root"]
    props = _read_dir(os.path.join(root, "j1", "data"))
    for t in PRED_TYPES:
        d = os.path.join(root, "t2_2", t, "data")
        n = _assert_files_close(d, os.path.join(root, "j2", t, "data"))
        assert n == 2 * DETECT["max_boxes"]
        assert _read_dir(d) != props  # the boxes moved


def test_prefetch_writes_the_same_bytes(run):
    root = run["root"]
    assert (_read_dir(os.path.join(root, "t1_2", "data"))
            == _read_dir(os.path.join(root, "t1_0", "data")))
    for t in PRED_TYPES:
        assert (_read_dir(os.path.join(root, "t2_2", t, "data"))
                == _read_dir(os.path.join(root, "t2_0", t, "data")))


def test_evaluator_dicts_equal_jax(run):
    root = run["root"]
    gt = os.path.join(root, "training", "label_2")
    for res in (os.path.join(root, "t2_2", "all_parts"),
                os.path.join(root, "j2", "all_parts"),
                os.path.join(root, "t1_2")):
        want = jax_eval(gt, res)
        assert run_kitti_eval(gt, res) == want
        assert set(want["car"]) == {"detection", "detection_ground",
                                    "detection_3d", "orientation"}


def test_chip_smoke_tree_decodes_and_scores_as_pinned(tmp_path):
    """The tree chip_smoke.py writes on the card: every PNG reads back as
    written (by the port and by cv2), and JAX's evaluator gives the values
    chip_smoke.py holds the port's evaluator to there."""
    root = str(tmp_path)
    tree = chip_smoke.write_kitti_tree(root)
    assert len(tree["images"]) == 2 * chip_smoke.TREE_FRAMES
    for path, img in tree["images"].items():
        np.testing.assert_array_equal(decode_png(path), img)
        np.testing.assert_array_equal(
            cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB), img)
    gt = os.path.join(root, "training", "label_2")
    chip_smoke.write_gt_as_predictions(gt, os.path.join(root, "gt_as_pred"))
    props = os.path.join(root, "props")
    chip_smoke.write_predictions(os.path.join(props, "data"), tree["boxes"])
    for res, pinned in (("gt_as_pred", chip_smoke.GT_AS_PRED_AP3D),
                        ("props", chip_smoke.PROPOSALS_AP3D)):
        want = jax_eval(gt, os.path.join(root, res))
        assert want["car"]["detection_3d"] == pinned, res
        assert run_kitti_eval(gt, os.path.join(root, res)) == want


@pytest.fixture(scope="module")
def model_dirs(run):
    root = run["root"]
    stereo, vernier = os.path.join(root, "m_stereo"), os.path.join(
        root, "m_vernier")
    smodel, vmodel = run["smodel"], run["vmodel"]
    save_checkpoint(stereo, create_stereo_state(smodel, TrainConfig()),
                    smodel.cfg, 3)
    save_checkpoint(vernier, create_train_state(vmodel, vmodel.cfg,
                                                TrainConfig()),
                    vmodel.cfg, 5)
    smodel.eval()
    vmodel.eval()
    return stereo, vernier


def test_clis_on_cpu_write_what_the_runners_wrote(run, model_dirs):
    root = run["root"]
    stereo, vernier = model_dirs
    n = cli_detect.main([
        "--model_dir", stereo, "--data_path", root, "--device", "cpu",
        "--output_dir", os.path.join(root, "c1"), "--prefetch", "2",
        "--score_threshold", "0", "--nms_iou", "0.5", "--max_boxes", "4"])
    assert n == run["counts"]["t1_2"]
    assert (_read_dir(os.path.join(root, "c1", "data"))
            == _read_dir(os.path.join(root, "t1_2", "data")))
    scores = cli_refine.main([
        "--model_dir", vernier, "--data_path", root, "--device", "cpu",
        "--pred_dir", os.path.join(root, "c1", "data"),
        "--output_dir", os.path.join(root, "c2"), "--pred_type", *PRED_TYPES,
        "--prefetch", "1", "--evaluate"])
    gt = os.path.join(root, "training", "label_2")
    for t in PRED_TYPES:
        assert (_read_dir(os.path.join(root, "c2", t, "data"))
                == _read_dir(os.path.join(root, "chain", t, "data")))
        assert scores[t] == jax_eval(gt, os.path.join(root, "c2", t))
    res = cli_evaluate.main([gt, os.path.join(root, "c2", "all_parts")])
    assert res == scores["all_parts"]


def test_cli_default_device_needs_cuda(run, model_dirs):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is valid")
    stereo, vernier = model_dirs
    root = run["root"]
    with pytest.raises(RuntimeError, match="cuda"):
        cli_detect.main(["--model_dir", stereo, "--data_path", root,
                         "--output_dir", os.path.join(root, "x1")])
    with pytest.raises(RuntimeError, match="cuda"):
        cli_refine.main(["--model_dir", vernier, "--data_path", root,
                         "--pred_dir", os.path.join(root, "t1_2", "data"),
                         "--output_dir", os.path.join(root, "x2")])

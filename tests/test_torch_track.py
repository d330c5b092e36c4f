"""The port's tracker (snvc_tpu_torch/inference/track.py) and its CLI
(snvc_tpu_torch/tools/track.py) against the JAX package's
(snvc_tpu/inference/track.py).

* A tiny float32 Vernier model (hrnet-tiny, 8x16x16 grid, 64x64 ROIs)
  with random JAX variables, converted for the port, tracks one car over
  a rendered 3-frame sequence from a pose 0.3 m off, with the static and
  the constant-velocity prior and both decodes: each frame's proposal and
  box within 1e-4 m / rad of JAX's float32 ``Tracker``, ``kept`` equal,
  the confidence within 1e-5 (each frame refining JAX's proposal: see
  ``test_tracker_matches_jax``).
* The CLI on that model saved as a flat model directory gives the
  tracker's boxes.
* The motion prior alone (JAX tests/test_tracking.py:47-117): a simulated
  refiner that corrects a fixed fraction of the gap; the constant-velocity
  prior bounds the error where the static one drifts, and wraps the yaw
  across +-pi.
"""

import os

import numpy as np
import pytest
import torch

from snvc_tpu.config import tiny_vernier_config as jtiny
from snvc_tpu.data.kitti import KittiDataset as JDataset
from snvc_tpu.inference.refine import RefineRunner as JRunner
from snvc_tpu.inference.track import Tracker as JTracker
from snvc_tpu.models.vernier import VernierScale as JVernier
from snvc_tpu_torch.config import save_config
from snvc_tpu_torch.data.kitti import KittiDataset
from snvc_tpu_torch.data.synthetic import make_synthetic_sequence
from snvc_tpu_torch.inference.refine import RefineRunner
from snvc_tpu_torch.inference.track import Tracker, TrackState
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.tools import track as cli_track
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_port_helpers import random_variables, torch_vernier_config


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread: under the tier-1 command's six workers torch's per-core
    pool runs several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 3-frame sequence, the JAX model's variables and the port's model
    holding them, and the initial pose."""
    root = str(tmp_path_factory.mktemp("seq"))
    gts = make_synthetic_sequence(root, num_frames=3, seed=5)
    # random weights give NCF values past the default keep window
    # [-1, 2]: widened, so the refiner's boxes are kept and followed
    jcfg = jtiny(max_instances=1, image_size=(384, 1248), filter_min=-1e4,
                 filter_max=1e4)
    jmod = JVernier(jcfg)
    H, W = jcfg.resolution
    nh, nw, nl = jcfg.grid_resolution
    x = np.zeros((1, H, W, 3), np.float32)
    p = np.zeros((1, nh * nw * nl, 2), np.float32)
    v = random_variables(jmod, x, x, p, p, seed=31)
    tcfg = torch_vernier_config(jcfg)
    tmod = VernierScale(tcfg, device="cpu")
    tmod.load_state_dict(convert_variables(v), strict=True)
    init = gts[0][0].copy()
    init[3] += 0.3
    return dict(root=root, jcfg=jcfg, jmod=jmod, v=v, tcfg=tcfg, tmod=tmod,
                init=init)


def _recorded(tracker, forced=None):
    """Wraps ``tracker.step_frame``: records each frame's proposal and
    state; with ``forced``, refines ``forced[k]`` at frame k instead of the
    tracker's own proposal (which is still recorded)."""
    log = []
    step = tracker.step_frame

    def step_frame(scene, box, calib_left=None, calib_right=None):
        use = box if forced is None else forced[len(log)]
        st = step(scene, use)
        log.append((np.array(box), st))
        return st

    tracker.step_frame = step_frame
    return log


@pytest.mark.parametrize("motion", ["static", "cv"])
@pytest.mark.parametrize("decode", ["coordinates", "argmax"])
def test_tracker_matches_jax(world, motion, decode):
    """Frame k of the port refines JAX's frame-k proposal (teacher
    forcing): one step of this random model leaves the two float32
    implementations micrometres apart, and the next crop, placed by that
    box, magnifies the difference past the tolerance, so free-running
    sequences of two correct trackers part after a frame.  The port's own
    proposals (its motion prior applied to its refined boxes) are held to
    JAX's too."""
    jcfg = world["jcfg"].replace(ncf_decode=decode)
    tcfg = world["tcfg"].replace(ncf_decode=decode)
    jtr = JTracker(JRunner(world["jmod"], world["v"], jcfg), jcfg)
    jlog = _recorded(jtr)
    want = jtr.track(JDataset(world["root"], "val").scenes(), world["init"],
                     motion=motion, beta=0.5)
    tr = Tracker(RefineRunner(world["tmod"], tcfg, device="cpu"), tcfg)
    tlog = _recorded(tr, forced=[p for p, _ in jlog])
    got = tr.track(KittiDataset(world["root"], "val").scenes(),
                   world["init"], motion=motion, beta=0.5)
    assert len(got) == len(want) == 3
    for (tp, g), (jp, w) in zip(tlog, jlog):
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
        assert g.kept == w.kept
        assert abs(g.confidence - w.confidence) <= 1e-5
        assert g.box.shape == (7,) and np.isfinite(g.box).all()
        np.testing.assert_allclose(g.box, np.asarray(w.box), rtol=0,
                                   atol=1e-4)
    # the refiner moved the box: the comparison is not of the priors alone
    assert all(st.kept for st in got)
    assert np.abs(got[0].box - world["init"]).max() > 1e-3


def test_track_cli_gives_the_tracker_boxes(world, tmp_path, capsys):
    model_dir = str(tmp_path / "model")
    os.makedirs(model_dir)
    torch.save({"step": 0, "model": world["tmod"].state_dict()},
               os.path.join(model_dir, "0.pt"))
    save_config(world["tcfg"], os.path.join(model_dir, "config.json"))
    tr = Tracker(RefineRunner(world["tmod"], world["tcfg"], device="cpu"),
                 world["tcfg"], update="one_part")
    want = tr.track(KittiDataset(world["root"], "val").scenes(),
                    world["init"], motion="cv", beta=0.3)
    got = cli_track.main([
        "--model_dir", model_dir, "--data_path", world["root"],
        "--frames", "0", "1", "2", "--init_box",
        *[str(float(v)) for v in world["init"]], "--update", "one_part",
        "--motion", "cv", "--motion_beta", "0.3", "--device", "cpu"])
    for g, w in zip(got, want):
        assert g.kept == w.kept
        np.testing.assert_allclose(g.box, w.box, rtol=0, atol=1e-6)
    assert capsys.readouterr().out.count("frame 00000") == 3


class _FractionalRefiner(Tracker):
    """A tracker whose refinement is simulated: it corrects a fixed
    fraction of the proposal -> GT gap (position and yaw), isolating the
    motion prior of ``track`` from the model."""

    def __init__(self, gts, correct=0.7):
        # no runner or pipeline: Tracker.__init__ is skipped
        self.gts = gts
        self.correct = correct
        self.update = "all_parts"
        self.fi = 0

    def step_frame(self, scene, box, calib_left=None, calib_right=None):
        gt = self.gts[self.fi]
        self.fi += 1
        new = box.copy()
        new[3:6] += self.correct * (gt[3:6] - box[3:6])
        dyaw = (gt[6] - box[6] + np.pi) % (2 * np.pi) - np.pi
        new[6] += self.correct * dyaw
        return TrackState(box=new, confidence=1.0, kept=True)


def _moving_gts(n, v=(0.15, 0.0, -0.45), yaw_rate=0.02):
    g = np.array([1.5, 1.6, 3.9, 1.0, 1.6, 28.0, 0.3], np.float32)
    gts = []
    for i in range(n):
        gi = g.copy()
        gi[3:6] += np.asarray(v, np.float32) * i
        gi[6] += yaw_rate * i
        gts.append(gi)
    return gts


def test_cv_motion_prior_bounds_error_where_static_drifts():
    """A refiner correcting 70 % of the gap at 0.47 m/frame of motion: the
    static prior settles at motion (1 - c) / c ~ 0.2 m, the constant-
    velocity prior locks on to a near-zero error."""
    gts = _moving_gts(30)
    init = gts[0].copy()

    def run(motion):
        tr = _FractionalRefiner(gts, correct=0.7)
        states = tr.track([None] * len(gts), init, motion=motion, beta=0.5)
        return [float(np.linalg.norm(s.box[[3, 5]] - g[[3, 5]]))
                for s, g in zip(states, gts)]

    err_static, err_cv = run("static"), run("cv")
    assert err_static[-1] > 0.15
    assert err_cv[-1] < 0.02, err_cv[-5:]
    assert err_cv[-1] < err_static[-1] / 5


def test_cv_motion_prior_wraps_yaw():
    """The yaw velocity wraps the frame-to-frame difference: a GT yaw
    crossing +-pi gives no 2 pi velocity."""
    gts = _moving_gts(12, v=(0.0, 0.0, 0.0), yaw_rate=0.0)
    for i, g in enumerate(gts):
        g[6] = np.pi - 0.05 + 0.02 * i  # crosses +pi at frame ~3
    tr = _FractionalRefiner(gts, correct=0.7)
    states = tr.track([None] * len(gts), gts[0].copy(), motion="cv",
                      beta=0.5)
    for s, g in zip(states, gts):
        d = (s.box[6] - g[6] + np.pi) % (2 * np.pi) - np.pi
        assert abs(d) < 0.1, (s.box[6], g[6])

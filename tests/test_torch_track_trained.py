"""Both trackers from the same trained weights: JAX's Tracker with the
Vernier checkpoint artifacts/two_stage_r4/vernier_ckpt (step 8000,
restored by scripts/convert_jax_checkpoint.restore_jax_variables) and the
port's with its committed conversion (artifacts/two_stage_r4_torch/
vernier), both in float32 on the CPU at demo_tracking's inference config
(one instance, argmax decode), free-running over the first 4 frames of
demo_tracking's sequence (seed 99, 0.47 m a frame), from the frame-0 GT
box, with the static and the constant-velocity prior.  Each frame's box
within 1e-4 m / rad of JAX's, ``kept`` equal, the confidence within
1e-5.

A random model's next crop magnifies the two packages' float32 step
difference (test_torch_track.py pins each frame to JAX's proposal for that
reason); the trained model is no such amplifier: demo_tracking over 10
frames, free-running in both packages, gives per-frame errors 4e-6 m
apart (tracker error mean / max 0.4386 / 0.7795 m in both).
"""

import os

import numpy as np
import pytest
import torch

from scripts.convert_jax_checkpoint import restore_jax_variables
from snvc_tpu.data.kitti import KittiDataset as JDataset
from snvc_tpu.inference.refine import RefineRunner as JRunner
from snvc_tpu.inference.track import Tracker as JTracker
from snvc_tpu.models.vernier import VernierScale as JVernier
from snvc_tpu_torch.config import VernierConfig
from snvc_tpu_torch.data.kitti import KittiDataset
from snvc_tpu_torch.data.synthetic import make_synthetic_sequence
from snvc_tpu_torch.inference.refine import RefineRunner
from snvc_tpu_torch.inference.track import Tracker
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.tools._model_dir import read_model_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CKPT = os.path.join(ROOT, "artifacts", "two_stage_r4", "vernier_ckpt")
PORT_CKPT = os.path.join(ROOT, "artifacts", "two_stage_r4_torch", "vernier")
# demo_tracking's inference config (tools/demo_tracking.py:187-189)
INFER = dict(usage="inference", sup_type="real", augment=False,
             max_instances=1, ncf_decode="argmax", compute_dtype="float32")
FRAMES = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread: under the tier-1 command's six workers torch's per-core
    pool runs several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trackers(tmp_path_factory):
    """(JAX tracker, port tracker, sequence root, GT boxes)."""
    root = str(tmp_path_factory.mktemp("seq"))
    # demo_tracking: seed + 99, its default velocity and yaw rate
    gts = make_synthetic_sequence(root, num_frames=FRAMES, seed=99,
                                  velocity=(0.15, 0.0, -0.45),
                                  yaw_rate=0.02)
    jcfg, variables, step = restore_jax_variables(JAX_CKPT)
    jcfg = jcfg.replace(**INFER)
    jtr = JTracker(JRunner(JVernier(jcfg), variables, jcfg), jcfg)
    tcfg, tree, tstep = read_model_dir(PORT_CKPT, VernierConfig)
    assert step == tstep == 8000
    tcfg = tcfg.replace(**INFER)
    model = VernierScale(tcfg, device="cpu")
    model.load_state_dict(tree["model"], strict=True)
    ttr = Tracker(RefineRunner(model, tcfg, device="cpu"), tcfg)
    return jtr, ttr, root, gts


@pytest.mark.parametrize("motion", ["static", "cv"])
def test_trained_trackers_agree_free_running(trackers, motion):
    jtr, ttr, root, gts = trackers
    init = gts[0][0].copy()
    want = jtr.track(JDataset(root, "val").scenes(), init, motion=motion,
                     beta=0.5)
    got = ttr.track(KittiDataset(root, "val").scenes(), init, motion=motion,
                    beta=0.5)
    assert len(got) == len(want) == FRAMES
    for g, w in zip(got, want):
        assert g.kept == w.kept
        assert abs(g.confidence - w.confidence) <= 1e-5
        np.testing.assert_allclose(g.box, np.asarray(w.box), rtol=0,
                                   atol=1e-4)
    # the trained refiner follows the car: under 0.5 m of it every frame
    # while the frame-0 box falls 1.4 m behind
    err = [float(np.linalg.norm(s.box[[3, 5]] - gt[0][[3, 5]]))
           for s, gt in zip(got, gts)]
    assert max(err) < 0.5, err
    assert np.linalg.norm(init[[3, 5]] - gts[-1][0][[3, 5]]) > 1.4

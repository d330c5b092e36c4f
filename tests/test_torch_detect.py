"""The port's proposal decoding and detection serving
(snvc_tpu_torch/{ops/rotated_iou,ops/nms,inference/detect}.py) against the
JAX package on the same inputs, float32 on the CPU.

* ``corners24_to_box3d``, ``bev_iou``, ``nms_from_iou`` and
  ``decode_proposals`` on random inputs: float32 noise (1e-5), keep masks
  and classes exact.  Tied scores are included: both sides sort stably.
* ``DetectRunner(device="cpu").forward`` against the JAX
  ``DetectRunner.forward`` on one tiny request with the same weights: the
  RPN maps agree to ~1e-4 of their scale (tests/test_torch_stereonet.py),
  so the selected boxes are the same and agree to 1e-3 m / rad, the scores
  to 1e-4.
* ``DetectRunner`` without a GPU raises instead of running on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snvc_tpu.config import tiny_stereo_config as jax_tiny
from snvc_tpu.geometry.calib import Calibration as JCalib
from snvc_tpu.inference import detect as jdet
from snvc_tpu.models.stereonet import StereoNet as JNet
from snvc_tpu.ops.nms import nms_from_iou as jax_nms
from snvc_tpu.ops.rotated_iou import bev_iou as jax_bev_iou
from snvc_tpu_torch.config import tiny_stereo_config
from snvc_tpu_torch.data.stereo import normalize_images, synthetic_stereo_request
from snvc_tpu_torch.geometry.calib import Calibration
from snvc_tpu_torch.inference import detect as tdet
from snvc_tpu_torch.models.stereonet import StereoNet
from snvc_tpu_torch.ops.nms import nms_from_iou
from snvc_tpu_torch.ops.rotated_iou import bev_iou
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_port_helpers import random_variables


def _t(a):
    return torch.from_numpy(np.array(a))


def _bev_boxes(rng, n):
    boxes = np.stack([rng.uniform(-3, 3, n), rng.uniform(5, 11, n),
                      rng.uniform(1.0, 4.5, n), rng.uniform(1.0, 2.0, n),
                      rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)
    boxes[1] = boxes[0]  # identical pair
    boxes[2, :2] = (40.0, 40.0)  # far from all others
    boxes[3] = boxes[0]
    boxes[3, 4] += np.pi / 2  # same center, rotated
    return boxes


def test_corners24_to_box3d_matches_jax():
    rng = np.random.default_rng(0)
    corners = rng.standard_normal((3, 5, 24)).astype(np.float32) * 2
    want = np.asarray(jdet.corners24_to_box3d(jnp.asarray(corners)))
    got = tdet.corners24_to_box3d(_t(corners)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_bev_iou_matches_jax():
    rng = np.random.default_rng(1)
    a, b = _bev_boxes(rng, 12), _bev_boxes(rng, 7)
    want = np.asarray(jax.jit(jax_bev_iou)(a, b))
    got = bev_iou(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    self_iou = bev_iou(_t(a), _t(a)).numpy()
    np.testing.assert_allclose(np.diag(self_iou), 1.0, atol=1e-5)
    assert self_iou[0, 2] == 0.0


@pytest.mark.parametrize("threshold", [0.1, 0.5])
def test_nms_from_iou_matches_jax(threshold):
    rng = np.random.default_rng(2)
    boxes = _bev_boxes(rng, 32)
    iou = np.asarray(jax.jit(jax_bev_iou)(boxes, boxes))
    scores = rng.uniform(0, 1, 32).astype(np.float32)
    scores[5:9] = scores[4]  # ties keep the index order on both sides
    valid = scores > 0.2
    want = np.asarray(jax.jit(jax_nms, static_argnums=3)(
        iou, scores, valid, threshold))
    got = nms_from_iou(_t(iou), _t(scores), _t(valid), threshold).numpy()
    np.testing.assert_array_equal(got, want)


def _rpn_outputs(seed, cfg):
    rng = np.random.default_rng(seed)
    nz, nx = cfg.bev_size
    A, K = cfg.num_angles, cfg.num_classes
    out = dict(
        cls=rng.standard_normal((2, nz, nx, A * K)) * 2,
        reg=rng.standard_normal((2, nz, nx, A * K * 24)) * 0.5,
        centerness=rng.standard_normal((2, nz, nx, A)))
    out = {k: v.astype(np.float32) for k, v in out.items()}
    out["cls"][1, :4] = 1.5  # tied scores
    out["centerness"][1, :4] = 0.5
    return out


@pytest.mark.parametrize("max_boxes,threshold", [(8, 0.1), (16, 0.6)])
def test_decode_proposals_matches_jax(max_boxes, threshold):
    jcfg, cfg = jax_tiny(), tiny_stereo_config()
    out = _rpn_outputs(3, cfg)
    decode = jax.jit(jdet.decode_proposals,
                     static_argnames=("cfg", "max_boxes", "score_threshold"))
    want = jax.tree.map(np.asarray, decode(
        out, cfg=jcfg, max_boxes=max_boxes, score_threshold=threshold))
    got = tdet.decode_proposals({k: _t(v) for k, v in out.items()}, cfg,
                                max_boxes=max_boxes, score_threshold=threshold)
    boxes, scores, classes, valid = (g.numpy() for g in got)
    np.testing.assert_array_equal(valid, want[3])
    np.testing.assert_array_equal(classes, want[2])
    np.testing.assert_allclose(scores, want[1], atol=1e-6, rtol=0)
    np.testing.assert_allclose(boxes, want[0], atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def runners():
    jcfg, cfg = jax_tiny(), tiny_stereo_config()
    H, W = jcfg.input_size
    x = np.zeros((1, H, W, 3), np.float32)
    P = JCalib.default().as_array()[None]
    variables = random_variables(JNet(jcfg), x, x, P, P, seed=11)
    model = StereoNet(cfg, device="cpu")
    model.load_state_dict(convert_variables(variables), strict=True)
    return (jdet.DetectRunner(jcfg, variables),
            tdet.DetectRunner(model, cfg, device="cpu"), cfg)


def test_detect_runner_forward_matches_jax(runners):
    jrun, trun, cfg = runners
    request = synthetic_stereo_request(cfg, seed=4)
    want = jax.tree.map(np.asarray, jrun.forward(request))
    boxes, scores, classes, valid = (g.numpy() for g in trun.forward(request))
    assert boxes.shape == (1, 8, 7) and valid.any()
    np.testing.assert_array_equal(valid, want[3])
    np.testing.assert_array_equal(classes, want[2])
    np.testing.assert_allclose(scores, want[1], atol=1e-4, rtol=0)
    np.testing.assert_allclose(boxes, want[0], atol=1e-3, rtol=0)


def test_normalize_images_matches_jax():
    from snvc_tpu.training.train_stereo import normalize_images as jnorm

    img = np.random.default_rng(5).integers(0, 255, (1, 4, 6, 3), np.uint8)
    np.testing.assert_allclose(normalize_images(_t(img)).numpy(),
                               np.asarray(jnorm(jnp.asarray(img))),
                               atol=1e-6, rtol=0)


def test_synthetic_request_keys_and_calibration():
    cfg = tiny_stereo_config()
    req = synthetic_stereo_request(cfg, seed=0)
    assert set(req) == {"images_left", "images_right", "P_left", "P_right",
                        "gt_boxes", "gt_valid", "gt_classes", "depth_gt"}
    assert req["images_left"].shape == (1, 64, 128, 3)
    assert req["images_left"].dtype == np.uint8
    np.testing.assert_array_equal(req["P_right"][0],
                                  JCalib.default_right().as_array())
    again = synthetic_stereo_request(cfg, seed=0)
    assert np.array_equal(req["images_right"], again["images_right"])


def test_proposals_to_kitti_matches_jax(runners):
    _, trun, cfg = runners
    boxes, scores, classes, valid = (
        g.numpy() for g in trun.forward(synthetic_stereo_request(cfg, seed=6)))
    names = jax_tiny().class_names
    want = jdet.proposals_to_kitti(boxes[0], scores[0], valid[0],
                                   JCalib.default(), classes=classes[0],
                                   class_names=names)
    got = tdet.proposals_to_kitti(boxes[0], scores[0], valid[0],
                                  Calibration.default(), classes=classes[0],
                                  class_names=names)
    assert got == want and len(got) == int(valid[0].sum())


def test_detect_runner_rejects_unrectified_projection(runners):
    _, trun, cfg = runners
    request = synthetic_stereo_request(cfg, seed=0)
    request["P_left"] = request["P_left"].copy()
    request["P_left"][0, 2, 0] = 1e-3
    with pytest.raises(ValueError, match="rectified"):
        trun.forward(request)


def test_detect_runner_rejects_negative_disparity(runners):
    """Swapped views give shifts fu*B/z/4 < 0, which the plane sweep (K3)
    does not take: the host copy of P is checked before upload."""
    _, trun, cfg = runners
    request = synthetic_stereo_request(cfg, seed=0)
    request["P_left"], request["P_right"] = (request["P_right"],
                                             request["P_left"])
    with pytest.raises(ValueError, match="negative disparity"):
        trun.forward(request)


def test_default_device_needs_cuda(runners, monkeypatch):
    """Without a GPU the default device raises: no silent CPU run."""
    _, trun, cfg = runners
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tdet.DetectRunner(trun.model, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        StereoNet(cfg)

"""The port's stereo losses and target assignment
(snvc_tpu_torch/models/stereo_losses.py) against the JAX package
(snvc_tpu/models/stereo_losses.py), float32 on the CPU, on seeded numpy
inputs: padded GT sets with valid and invalid boxes at the tiny config's
BEV grid, random head outputs, and depth maps with masked pixels.

Targets are compared exactly where they are discrete (labels, the
positives) and within 1e-5 of scale where they are float32 geometry
(corner offsets, centerness); losses within 1e-5 relative and their
gradients with respect to the head outputs within 1e-5 of the largest
(float32 summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snvc_tpu.config import tiny_stereo_config as jax_tiny
from snvc_tpu.models import stereo_losses as J
from snvc_tpu_torch.config import tiny_stereo_config
from snvc_tpu_torch.data.synthetic import random_box
from snvc_tpu_torch.models import stereo_losses as T
from snvc_tpu_torch.models.stereonet import bev_locations

CFG = dict(z_max=38.0, max_depth=40.0)


def _gt(seed, N=2, G=6, per_frame=(3, 2)):
    """Padded GT of N frames: cars inside the tiny BEV range (x +-8 m),
    one frame's boxes overlapping so that ties go to the nearest center."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((N, G, 7), np.float32)
    valid = np.zeros((N, G), bool)
    for n in range(N):
        for g in range(per_frame[n]):
            b = random_box(rng)
            b[3] *= 0.5
            boxes[n, g] = b
            valid[n, g] = True
    boxes[0, 1, 3:6] = boxes[0, 0, 3:6] + [0.6, 0.0, 0.9]  # overlap
    boxes[1, G - 1] = boxes[1, 0]  # a padded slot holding a box: invalid
    classes = rng.integers(0, 2, size=(N, G)).astype(np.int32)
    return boxes, valid, classes


def _outputs(seed, cfg, N=2):
    rng = np.random.default_rng(seed)
    nz, nx = cfg.bev_size
    A, K = cfg.num_angles, cfg.num_classes
    return {"cls": rng.standard_normal((N, nz, nx, A * K)),
            "reg": rng.standard_normal((N, nz, nx, A * K * 24)),
            "centerness": rng.standard_normal((N, nz, nx, A))}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rel, name=""):
    want = np.asarray(want, np.float64)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def test_gt_corners_match_jax():
    boxes, _, _ = _gt(0)
    _close(T.gt_corners_24(_t(boxes)), J.gt_corners_24(jnp.asarray(boxes)),
           1e-6)


@pytest.mark.parametrize("num_classes,anchors_y", [(1, (1.65,)),
                                                   (2, (1.65, 1.2))])
def test_assign_targets_match_jax(num_classes, anchors_y):
    """Per frame as JAX calls it, and the batch at once."""
    boxes, valid, classes = _gt(1)
    classes = classes % num_classes
    loc = bev_locations(tiny_stereo_config(**CFG))
    angles = np.array([0.0, 1.5707963], np.float32)
    got = T.assign_targets(_t(loc), anchors_y, *map(_t, (boxes, valid,
                                                          classes)),
                           num_classes, _t(angles))
    for n in range(boxes.shape[0]):
        want = J.assign_targets(jnp.asarray(loc), jnp.asarray(anchors_y),
                                boxes[n], valid[n], classes[n], num_classes,
                                jnp.asarray(angles))
        labels, reg, ctr = (g[n] for g in got)
        np.testing.assert_array_equal(labels.numpy(), np.asarray(want[0]))
        assert labels.sum() > 0
        _close(reg, want[1], 1e-5, "reg")
        _close(ctr, want[2], 1e-5, "centerness")
        single = T.assign_targets(_t(loc), anchors_y,
                                  *map(_t, (boxes[n], valid[n], classes[n])),
                                  num_classes, _t(angles))
        for a, b in zip(single, (labels, reg, ctr)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("sym", [False, True])
def test_rpn3d_loss_and_grads_match_jax(sym):
    jcfg = jax_tiny(reg_heading_sym=sym, **CFG)
    tcfg = tiny_stereo_config(reg_heading_sym=sym, **CFG)
    boxes, valid, classes = _gt(2)
    classes[:] = 0
    out = {k: v.astype(np.float32) for k, v in _outputs(3, tcfg).items()}
    loc = bev_locations(tcfg)

    def jloss(o):
        return J.rpn3d_loss(o, boxes, valid, classes, jcfg, jnp.asarray(loc))

    want = jloss({k: jnp.asarray(v) for k, v in out.items()})
    jgrad = jax.grad(lambda o: jloss(o)["total"])(
        {k: jnp.asarray(v) for k, v in out.items()})
    tout = {k: _t(v).requires_grad_() for k, v in out.items()}
    got = T.rpn3d_loss(tout, *map(_t, (boxes, valid, classes)), tcfg,
                       _t(loc))
    assert float(got["num_pos"]) == float(want["num_pos"]) > 0
    for k in ("total", "cls", "reg", "centerness"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    got["total"].backward()
    for k, v in tout.items():
        _close(v.grad, jgrad[k], 1e-5, k)


def _depth_case(seed, N=2, D=16, H=8, W=12):
    rng = np.random.default_rng(seed)
    levels = np.linspace(2.0, 40.0, D).astype(np.float32)
    gt = rng.uniform(3.0, 38.0, size=(N, H, W)).astype(np.float32)
    gt[rng.random((N, H, W)) < 0.6] = -1.0  # pixels without a point
    logits = rng.standard_normal((N, D, H, W)).astype(np.float32)
    offset = 0.3 * rng.standard_normal((N, D, H, W)).astype(np.float32)
    preds = [rng.uniform(2.0, 40.0, size=(N, H, W)).astype(np.float32)
             for _ in range(3)]
    return levels, gt, logits, offset, preds


@pytest.mark.parametrize("loss", ["sl1", "multistage", "w1", "w1_offset"])
def test_depth_losses_and_grads_match_jax(loss):
    levels, gt, logits, offset, preds = _depth_case(4)
    jmask, tmask = jnp.asarray(gt > 0), _t(gt > 0)

    def jfn(x):
        if loss == "sl1":
            return J.depth_sl1_loss(x[0], gt, jmask)
        if loss == "multistage":
            return J.depth_multistage_sl1_loss(x, gt, jmask)
        prob = jax.nn.softmax(x[0], axis=1)
        off = x[1] if loss == "w1_offset" else None
        return J.depth_w1_loss(prob, jnp.asarray(levels), gt, jmask, off)

    def tfn(x):
        if loss == "sl1":
            return T.depth_sl1_loss(x[0], _t(gt), tmask)
        if loss == "multistage":
            return T.depth_multistage_sl1_loss(x, _t(gt), tmask)
        prob = torch.softmax(x[0], dim=1)
        off = x[1] if loss == "w1_offset" else None
        return T.depth_w1_loss(prob, _t(levels), _t(gt), tmask, off)

    args = preds if loss in ("sl1", "multistage") else [logits, offset]
    want, jg = jax.value_and_grad(jfn)([jnp.asarray(a) for a in args])
    targs = [_t(a).requires_grad_() for a in args]
    got = tfn(targs)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    got.backward()
    for i, (a, b) in enumerate(zip(targs, jg)):
        if a.grad is None:  # an argument this loss does not read
            assert not np.asarray(b).any()
            continue
        _close(a.grad, b, 1e-5, f"grad {i}")

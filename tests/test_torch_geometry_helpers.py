"""The port's host geometry helpers and the last IoU / NMS helpers against
the JAX package on the CPU: ``geometry/boxes2d`` (all eight functions) and
``geometry/transforms`` (float64, 1e-10), ``ops/rotated_iou.{iou3d,
diou_bev}`` (1e-5), ``ops/nms.axis_aligned_iou`` (1e-6) and
``normal_nms``' keep mask (equal), and ``transforms.pnp_refine`` (numpy:
DLT, then Levenberg-Marquardt) against JAX's ``cv2.solvePnP`` one on
non-planar 8-point sets: noiseless within 1e-6 of scale, with pixel noise
and with lens distortion within 1e-4 (where OpenCV's pose lies in front
of the camera), and the failure branch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snvc_tpu.geometry import boxes2d as jb2
from snvc_tpu.geometry import transforms as jtf
from snvc_tpu.ops import nms as jnms
from snvc_tpu.ops import rotated_iou as jiou
from snvc_tpu_torch.geometry import boxes2d as tb2
from snvc_tpu_torch.geometry import transforms as ttf
from snvc_tpu_torch.ops import nms as tnms
from snvc_tpu_torch.ops import rotated_iou as tiou

K = np.array([[721.5377, 0.0, 609.5593], [0.0, 721.5377, 172.854],
              [0.0, 0.0, 1.0]])


def _xyxy(rng, n):
    xy = rng.uniform(0, 300, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(5, 80, (n, 2))], axis=1)


def test_boxes2d_equals_jax():
    rng = np.random.default_rng(0)
    a, b = _xyxy(rng, 12), _xyxy(rng, 7)
    a[3] = a[5]  # a duplicate for NMS
    xywh = rng.uniform(0, 100, (5, 4))
    cases = [
        ("xywh_to_xyxy", (xywh,)),
        ("xyxy_to_xywh", (a,)),
        ("resize_boxes", (a, (1242, 375), (1280, 384))),
        ("hflip_boxes", (a, 1242)),
        ("clip_boxes", (a * 5 - 100, (1242, 375))),
        ("clip_boxes", (a * 5 - 100, (1242, 375), True)),
        ("box_area", (a,)),
        ("iou_matrix", (a, b)),
        ("nms_2d", (a, rng.uniform(size=12), 0.3)),
    ]
    for name, args in cases:
        got = getattr(tb2, name)(*args)
        want = getattr(jb2, name)(*args)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10,
                                   err_msg=name)


def test_transforms_equal_jax():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(3, 10))
    ang = 0.7
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    dst = R @ src + rng.normal(size=(3, 1)) + 0.01 * rng.normal(size=(3, 10))
    w = rng.uniform(0.1, 1.0, 10)
    for args in ((src, dst), (src, dst, w)):
        for g, x in zip(ttf.rigid_transform(*args),
                        jtf.rigid_transform(*args)):
            np.testing.assert_allclose(g, x, atol=1e-10)
        np.testing.assert_allclose(ttf.procrustes(*args),
                                   jtf.procrustes(*args), atol=1e-10)
        s2, d2 = args[0][:2], args[1][:2]
        for g, x in zip(ttf.rigid_transform_2d(s2, d2, *args[2:]),
                        jtf.rigid_transform_2d(s2, d2, *args[2:])):
            np.testing.assert_allclose(g, x, atol=1e-10)
    for scale in (False, True):
        got = ttf.similarity_transform(dst.T, 1.3 * src.T, scale)
        want = jtf.similarity_transform(dst.T, 1.3 * src.T, scale)
        for g, x in zip(got, want):
            np.testing.assert_allclose(g, x, atol=1e-10)
    R2, _ = jtf.rigid_transform_2d(src[:2], dst[:2])
    assert ttf.rotation_angle_2d(R2) == jtf.rotation_angle_2d(R2)


def _boxes3d(rng, n):
    return np.stack([
        rng.uniform(1.3, 1.8, n), rng.uniform(1.5, 1.9, n),
        rng.uniform(3.2, 4.6, n), rng.uniform(-2, 2, n),
        rng.uniform(1.4, 2.0, n), rng.uniform(10, 14, n),
        rng.uniform(-np.pi, np.pi, n)], axis=1).astype(np.float32)


def test_iou3d_and_diou_bev_equal_jax():
    rng = np.random.default_rng(2)
    a, b = _boxes3d(rng, 9), _boxes3d(rng, 6)
    b[0] = a[0]  # identical boxes: IoU 1
    got = tiou.iou3d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jiou.iou3d(jnp.asarray(a), jnp.asarray(b)))
    assert (want > 0.05).sum() >= 3  # overlaps are exercised
    np.testing.assert_allclose(got, want, atol=1e-5)
    pa = np.array(jiou.bev_from_box3d(jnp.asarray(a[:6])))
    pb = np.array(jiou.bev_from_box3d(jnp.asarray(b)))
    loss, iou = tiou.diou_bev(torch.from_numpy(pa), torch.from_numpy(pb))
    wl, wi = jiou.diou_bev(jnp.asarray(pa), jnp.asarray(pb))
    np.testing.assert_allclose(loss.numpy(), np.asarray(wl), atol=1e-5)
    np.testing.assert_allclose(iou.numpy(), np.asarray(wi), atol=1e-5)


def test_axis_aligned_iou_and_normal_nms_equal_jax():
    rng = np.random.default_rng(3)
    xz = rng.uniform(0, 10, (16, 2))
    boxes = np.concatenate([xz, xz + rng.uniform(1, 4, (16, 2))],
                           axis=1).astype(np.float32)
    boxes[5] = boxes[2]
    scores = rng.uniform(size=16).astype(np.float32)
    scores[7] = scores[9]  # a tie: stable order in both
    valid = rng.uniform(size=16) > 0.2
    got = tnms.axis_aligned_iou(torch.from_numpy(boxes)).numpy()
    want = np.asarray(jnms.axis_aligned_iou(jnp.asarray(boxes)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    for thr in (0.1, 0.3, 0.7):
        keep = tnms.normal_nms(torch.from_numpy(boxes),
                               torch.from_numpy(scores),
                               torch.from_numpy(valid), thr).numpy()
        wkeep = np.asarray(jnms.normal_nms(jnp.asarray(boxes),
                                           jnp.asarray(scores),
                                           jnp.asarray(valid), thr))
        np.testing.assert_array_equal(keep, wkeep)


def _pnp_case(rng, noise=0.0, dist=None):
    import cv2

    X = rng.uniform(-1.0, 1.0, (8, 3)) * [0.9, 0.8, 2.2]  # a car's parts
    rvec = rng.normal(0, 0.4, 3)
    tvec = np.array([rng.uniform(-4, 4), rng.uniform(0.5, 2),
                     rng.uniform(8, 35)])
    d = np.zeros(4) if dist is None else np.asarray(dist, np.float64)
    x = cv2.projectPoints(X, rvec, tvec, K, d)[0][:, 0]
    return X, x + rng.normal(0, noise, x.shape), d


@pytest.mark.parametrize("noise,dist,tol", [
    (0.0, None, 1e-6),
    (1.0, None, 1e-4),
    (0.5, (-0.25, 0.08, 1e-3, -5e-4), 1e-4),
], ids=["noiseless", "pixel_noise", "distortion"])
def test_pnp_refine_matches_cv2(noise, dist, tol):
    """OpenCV's solver does not hold the points in front of the camera: on
    an ill-posed noisy set (a car at 30+ m) it can settle on a mirrored
    pose behind it (z < 0).  The port's linear start keeps them in front;
    such a case is checked for that, every other against OpenCV."""
    rng = np.random.default_rng(4)
    compared = 0
    for _ in range(5):
        X, x, d = _pnp_case(rng, noise, dist)
        want = jtf.pnp_refine(X, x, K, d)
        got = ttf.pnp_refine(X, x, K, d)
        assert got.shape == want.shape == (3, 8)
        assert (got[2] > 0).all()
        if (want[2] < 0).all():
            continue
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= tol, err
        compared += 1
    assert compared >= 4


def test_pnp_refine_failure_returns_prediction(monkeypatch):
    import cv2

    X, x, d = _pnp_case(np.random.default_rng(5))
    # JAX's branch: solvePnP reports failure
    monkeypatch.setattr(cv2, "solvePnP",
                        lambda *a, **k: (False, None, None))
    np.testing.assert_array_equal(jtf.pnp_refine(X, x, K, d), X)
    # the port's: a non-finite observation or too few points
    bad = x.copy()
    bad[2, 0] = np.nan
    out = ttf.pnp_refine(X, bad, K, d)
    assert out.shape == X.shape and np.array_equal(out, X)
    np.testing.assert_array_equal(ttf.pnp_refine(X[:3], x[:3], K), X[:3])

"""The last host helpers of the port against the JAX package, one
parametrised test a module, over seeded numpy inputs:

* geometry/boxes.py: the twelve box, frame and quaternion helpers (host
  numpy with JAX's formulas: equal within 1e-12);
* geometry/imgproc.py: invert_affine, apply_affine, gaussian_heatmap_2d
  (1e-12);
* ops/warp.py: affine_resample, separable on crop affines and by gather
  on rotated ones (float32, 1e-5 of the image's scale: the sums round in
  another order);
* ops/heatmaps.py: soft_argmax_2d at two temperatures (float32, 1e-5 of
  the grid's extent);
* models/losses.py: shape_loss (float32, 1e-6 relative);
* inference/refine.py: refinement_step at tiny_vernier_config with the
  same random weights (converted), with and without targets, against
  JAX's refinement_step: float32, every output within 1e-4 of its scale
  (the keep mask equal), the losses within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from snvc_tpu.geometry import boxes as jboxes
from snvc_tpu.geometry import imgproc as jimgproc
from snvc_tpu.inference.refine import refinement_step as jstep
from snvc_tpu.models import losses as jlosses
from snvc_tpu.models.vernier import VernierScale as JVernier
from snvc_tpu.ops import heatmaps as jheatmaps
from snvc_tpu.ops import warp as jwarp
from snvc_tpu.ops.assemble import make_grid_local as jgrid_local
from snvc_tpu_torch.data.synthetic import synthetic_batch_arrays
from snvc_tpu_torch.geometry import boxes, imgproc
from snvc_tpu_torch.inference.refine import refinement_step
from snvc_tpu_torch.models import losses
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.ops import heatmaps, warp
from snvc_tpu_torch.ops.assemble import make_grid_local
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_port_helpers import random_variables, torch_vernier_config


def _boxes(rng, n=5):
    return np.concatenate([rng.uniform(1.2, 2.0, (n, 1)),
                           rng.uniform(1.4, 2.0, (n, 1)),
                           rng.uniform(3.0, 5.0, (n, 1)),
                           rng.uniform(-8, 8, (n, 1)),
                           rng.uniform(1.0, 2.0, (n, 1)),
                           rng.uniform(5, 40, (n, 1)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], axis=1)


def _box_cases():
    rng = np.random.default_rng(0)
    b = _boxes(rng)
    corners = jboxes.box_corners_cam(b)
    pts = b[:, None, 3:6] + rng.uniform(-3, 3, (5, 200, 3))
    q = rng.standard_normal((4, 6))
    q /= np.linalg.norm(q, axis=0)
    e = rng.uniform(-1.5, 1.5, (3, 6))
    return {
        "parts_object_frame": (b,),
        "object_basis": (b,),
        "grid_to_cam": (rng.uniform(-2, 2, (5, 30, 3)), b),
        "cuboid_planes": (corners,),
        "points_in_cuboid": (pts, corners),
        # one box (JAX's half-dims do not broadcast over a batch of boxes)
        "points_in_box3d": (pts[0], b[0]),
        "canonical_bev_parts": (1.6, 3.9),
        "corners_to_dims": (corners,),
        "fcos_centerness": tuple(rng.uniform(0, 10, (4, 50))),
        "quat_to_euler": tuple(q),
        "euler_to_quat": tuple(e),
        "quat_to_rotation": tuple(q),
    }


BOX_CASES = _box_cases()


@pytest.mark.parametrize("name", sorted(BOX_CASES))
def test_boxes_helper_matches_jax(name):
    args = BOX_CASES[name]
    got, want = getattr(boxes, name)(*args), getattr(jboxes, name)(*args)
    if name == "points_in_box3d":  # the tolerance argument too
        np.testing.assert_array_equal(boxes.points_in_box3d(*args, tol=0.3),
                                      jboxes.points_in_box3d(*args, tol=0.3))
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    assert isinstance(got, tuple) and len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w)
            assert w.any() and not w.all()
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


def _imgproc_cases():
    rng = np.random.default_rng(1)
    t = np.array([[2.5, 0.3, 10.0], [-0.2, 1.7, -4.0]])
    return {
        "invert_affine": (t,),
        "apply_affine": (rng.uniform(0, 100, (3, 20, 2)),
                         np.stack([t, 2 * t, t + 1])),
        "gaussian_heatmap_2d": ((40, 50), (17.3, 22.8), 2.0),
    }


IMGPROC_CASES = _imgproc_cases()


@pytest.mark.parametrize("name", sorted(IMGPROC_CASES))
def test_imgproc_helper_matches_jax(name):
    args = IMGPROC_CASES[name]
    got, want = (getattr(imgproc, name)(*args),
                 getattr(jimgproc, name)(*args))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _affines(separable: bool):
    """Source->ROI affines of a 40x64 image to 16x24 ROIs: crop boxes
    (scale + translate), or those turned by a few degrees."""
    rng = np.random.default_rng(2)
    out = []
    for _ in range(3):
        k = rng.uniform(0.3, 1.2)
        t = np.array([[k, 0.0, -k * rng.uniform(0, 30)],
                      [0.0, k, -k * rng.uniform(0, 20)]])
        if not separable:
            a = rng.uniform(-0.3, 0.3)
            R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
            t = np.concatenate([R @ t[:, :2], t[:, 2:]], axis=1)
        out.append(t)
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("separable", [True, False])
def test_warp_affine_resample_matches_jax(separable):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (40, 64, 3)).astype(np.float32)
    trans = _affines(separable)
    want = np.asarray(jwarp.affine_resample(jnp.asarray(img),
                                            jnp.asarray(trans), (16, 24),
                                            separable=separable))
    got = warp.affine_resample(torch.from_numpy(img), torch.from_numpy(trans),
                               (16, 24), separable=separable).numpy()
    assert got.shape == want.shape == (3, 16, 24, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 255)
    assert np.abs(want).max() > 10  # the ROIs see the image


@pytest.mark.parametrize("temperature", [1.0, 5.0])
def test_heatmaps_soft_argmax_matches_jax(temperature):
    h = np.random.default_rng(4).standard_normal((2, 9, 12, 10)).astype(
        np.float32)
    (wxy, wmax) = jheatmaps.soft_argmax_2d(jnp.asarray(h), temperature)
    gxy, gmax = heatmaps.soft_argmax_2d(torch.from_numpy(h), temperature)
    np.testing.assert_allclose(gxy.numpy(), np.asarray(wxy), rtol=0,
                               atol=1e-5 * 12)
    np.testing.assert_array_equal(gmax.numpy(), np.asarray(wmax))


@pytest.mark.parametrize("scaling", [1e4, 1.0])
def test_losses_shape_loss_matches_jax(scaling):
    rng = np.random.default_rng(5)
    pred = rng.standard_normal((6, 10)).astype(np.float32)
    target = (rng.standard_normal((6, 10)) * scaling).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 0, 1], bool)
    want = float(jlosses.shape_loss(jnp.asarray(pred), jnp.asarray(target),
                                    jnp.asarray(valid), scaling))
    got = float(losses.shape_loss(torch.from_numpy(pred),
                                  torch.from_numpy(target),
                                  torch.from_numpy(valid), scaling))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.fixture(scope="module")
def step_models():
    """JAX's VernierScale with random variables and the port's with them
    converted, at the tiny config."""
    jcfg = __graft_entry__._tiny_cfg(max_instances=2)
    tcfg = torch_vernier_config(jcfg)
    jmod = JVernier(jcfg)
    H, W = jcfg.resolution
    nh, nw, nl = jcfg.grid_resolution
    x = np.zeros((2, H, W, 3), np.float32)
    p = np.zeros((2, nh * nw * nl, 2), np.float32)
    v = random_variables(jmod, x, x, p, p, seed=31)
    tmod = VernierScale(tcfg, device="cpu")
    tmod.load_state_dict(convert_variables(v), strict=True)
    return jcfg, jmod, v, tcfg, tmod


@pytest.mark.parametrize("with_targets", [False, True])
def test_refine_refinement_step_matches_jax(step_models, with_targets):
    jcfg, jmod, v, tcfg, tmod = step_models
    a = synthetic_batch_arrays(tcfg, seed=12)
    # the synthetic LiDAR points lie on the cars' faces, where two float32
    # implementations may put a point on either side of a face or voxel
    # boundary (tests/test_torch_refine.py): move them off by ~1 cm
    a["points"] = a["points"] + np.random.default_rng(13).normal(
        0.0, 0.01, a["points"].shape).astype(np.float32)
    want = jax.jit(lambda b: jstep(v, b, jmod, jcfg, jgrid_local(jcfg),
                                   with_targets))(
        {k: jnp.asarray(x) for k, x in a.items()})
    with torch.no_grad():
        got = refinement_step(
            tmod, {k: torch.from_numpy(x) for k, x in a.items()}, tcfg,
            torch.from_numpy(make_grid_local(tcfg)), with_targets)
    keys = {"one_part", "all_parts", "confidence", "keep", "occupancy",
            "ncf", "coordinates"} | ({"losses"} if with_targets else set())
    assert set(got) == set(want) == keys
    np.testing.assert_array_equal(got["keep"].numpy(),
                                  np.asarray(want["keep"]))
    for k in keys - {"keep", "losses"}:
        w = np.asarray(want[k], np.float32)
        np.testing.assert_allclose(got[k].float().numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1.0),
                                   err_msg=k)
    if with_targets:
        assert set(got["losses"]) == set(want["losses"])
        for k, w in want["losses"].items():
            assert abs(float(got["losses"][k]) - float(w)) <= \
                1e-4 * abs(float(w)), (k, got["losses"][k], w)

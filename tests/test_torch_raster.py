"""The port's cv2-free rasterization (snvc_tpu_torch/geometry/raster.py)
against OpenCV itself, element for element, on seeded cases.

The models were derived on OpenCV 5.0.0 on an x86-64 host with AVX-512:
``warpPerspective``'s vector body covers each row in blocks of 16 columns
(``raster.LANES``) and its scalar loop the last ``width % 16``; at
KITTI's 1242 columns that is columns 1232-1241, which the cases below
cover.

* ``perspective_transform``: the 3x3 matrix bit for bit (and its
  ``invert3`` against ``cv2.invert``);
* ``warp_perspective``: the float32 image bit for bit at 1242x375, 64^2
  and 560^2 sources, borders 0 and 1, quads inside, across and around
  the frame, tail columns included; a window equals the full warp's block;
* ``fill_convex_poly``: convex quads on, across and off the image,
  collinear and repeated points, coordinates far outside;
* ``polylines``: closed quads on a float32 3-channel image, clipped.
"""

import cv2
import numpy as np
import pytest

from snvc_tpu_torch.geometry import raster

W, H = 1242, 375


def _quads(rng, n, lo=-300.0, hi=1500.0):
    """Random convex-ish destination quads (float32, [n, 4, 2]): a jittered
    axis box, its corners in cv2's order."""
    out = []
    for _ in range(n):
        c = rng.uniform([lo, lo / 3], [hi, hi / 3])
        r = rng.uniform(10, 700, 2)
        box = c + np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]]) * r
        out.append(box + rng.uniform(-0.3, 0.3, (4, 2)) * r)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_perspective_transform_and_inverse_match_cv2(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        src = rng.uniform(-50, 600, (4, 2)).astype(np.float32)
        dst = rng.uniform(-300, 1500, (4, 2)).astype(np.float32)
        want = cv2.getPerspectiveTransform(src, dst)
        got = raster.perspective_transform(src, dst)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(raster.invert3(want),
                                      cv2.invert(want)[1])


@pytest.mark.parametrize("size", [64, 560])
@pytest.mark.parametrize("border", [0.0, 1.0])
@pytest.mark.parametrize("seed", range(2))
def test_warp_perspective_matches_cv2_bits(size, border, seed):
    """Six homographies a case: three local quads and three that cover the
    right edge of the frame (the scalar tail)."""
    rng = np.random.default_rng(100 * seed + size + int(border))
    src = rng.uniform(0.5, 1.5, (size, size)).astype(np.float32)
    s = size - 1
    corners = np.array([[0, 0], [s, 0], [s, s], [0, s]], np.float32)
    wide = np.array([[-200, -100], [1500, -50], [1400, 500], [-100, 450]],
                    np.float32)
    dsts = list(_quads(rng, 3)) + [
        wide + rng.uniform(-80, 80, (4, 2)).astype(np.float32)
        for _ in range(3)]
    tail_px = 0
    for dst in dsts:
        Hm = cv2.getPerspectiveTransform(corners, dst)
        want = cv2.warpPerspective(src, Hm, (W, H), flags=cv2.INTER_LINEAR,
                                   borderMode=cv2.BORDER_CONSTANT,
                                   borderValue=border)
        got = raster.warp_perspective(src, Hm, (W, H), border_value=border)
        assert got.dtype == np.float32 and got.shape == (H, W)
        bad = np.argwhere(got != want)
        assert not len(bad), f"{len(bad)} pixels differ, first {bad[:4]}"
        tail_px += int((want[:, W - W % raster.LANES:] != border).sum())
        # a window keeps each pixel's absolute-column arithmetic
        y0, x0 = rng.integers(0, H - 40), rng.integers(W - 300, W - 20)
        win = raster.warp_perspective(src, Hm, (W, H), border_value=border,
                                      window=(y0, H, x0, W))
        np.testing.assert_array_equal(win, want[y0:, x0:])
    assert tail_px > 0  # the tail columns were exercised


def _fill_cases(rng):
    for t in range(300):
        kind = t % 5
        if kind == 0:  # anywhere, across the edges
            p = cv2.convexHull(rng.integers(-100, 1400, (4, 2))
                               .astype(np.int32)).reshape(-1, 2)
        elif kind == 1:  # small, on the image
            c = rng.integers([0, 0], [W, H])
            p = cv2.convexHull((c + rng.integers(-60, 60, (4, 2)))
                               .astype(np.int32)).reshape(-1, 2)
        elif kind == 2:  # collinear
            a, b = rng.integers(-50, 1300, 2), rng.integers(-50, 1300, 2)
            p = np.stack([a, b, a + (b - a) // 2, a]).astype(np.int32)
        elif kind == 3:  # a repeated point
            p = cv2.convexHull(rng.integers(0, 600, (3, 2))
                               .astype(np.int32)).reshape(-1, 2)
            p = np.concatenate([p, p[:1]])
        else:  # far outside, in any order
            p = rng.integers(-2000, 3000, (4, 2)).astype(np.int32)
        yield kind, p


@pytest.mark.parametrize("seed", range(2))
def test_fill_convex_poly_matches_cv2(seed):
    rng = np.random.default_rng(seed)
    for kind, pts in _fill_cases(rng):
        want = np.zeros((H, W), np.uint8)
        got = want.copy()
        cv2.fillConvexPoly(want, pts, 1)
        raster.fill_convex_poly(got, pts, 1)
        assert np.array_equal(got, want), (kind, pts.tolist(),
                                           int((got != want).sum()))


@pytest.mark.parametrize("seed", range(2))
def test_polylines_matches_cv2(seed):
    rng = np.random.default_rng(seed)
    for t in range(100):
        img = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
        want = img.copy()
        if t % 2:
            pts = rng.integers(-800, 2000, (4, 2)).astype(np.int32)
        else:
            pts = rng.integers([0, 0], [W, H], (4, 2)).astype(np.int32)
        color = tuple(float(c) for c in rng.uniform(0, 255, 3))
        cv2.polylines(want, [pts], True, color, 1)
        raster.polylines(img, pts, color)
        assert np.array_equal(img, want), (pts.tolist(),
                                           int((img != want).sum()))


def test_clip_line_matches_cv2():
    rng = np.random.default_rng(7)
    for _ in range(300):
        p1 = tuple(int(v) for v in rng.integers(-3000, 4000, 2))
        p2 = tuple(int(v) for v in rng.integers(-3000, 4000, 2))
        want = cv2.clipLine((0, 0, W, H), p1, p2)
        inside, q1, q2 = raster.clip_line((W, H), p1, p2)
        assert inside == want[0]
        if inside:
            assert (q1, q2) == (tuple(want[1]), tuple(want[2])), (p1, p2)

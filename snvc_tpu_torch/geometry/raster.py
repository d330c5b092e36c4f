"""Host rasterization without cv2: the four OpenCV calls of the synthetic
renderer (JAX snvc_tpu/data/synthetic.py:99-205), reproduced to OpenCV's
bits so the port renders the JAX package's images exactly.

* ``perspective_transform``: ``cv2.getPerspectiveTransform``, the 8x8
  system built as OpenCV builds it (the products ``-x * u`` rounded in
  float32) and solved by its Gaussian elimination with partial pivoting in
  float64 (``hal::LU``).
* ``warp_perspective``: ``cv2.warpPerspective`` of a float32
  single-channel image, ``INTER_LINEAR``, ``BORDER_CONSTANT``.  OpenCV
  inverts the matrix in float64 (``cv::invert``'s 3x3 cofactor form),
  rounds it to float32 and maps each destination pixel in float32 with
  fused multiply-adds.  Its vector body covers each row in blocks of
  ``LANES`` columns from column 0; the last ``width % LANES`` columns go
  through a scalar loop that adds the constant term after the fused pair.
  A tap off the source reads the border value.
* ``fill_convex_poly``: ``cv2.fillConvexPoly`` with integer points,
  ``LINE_8``, ``shift=0``: the outline drawn as 8-connected lines, then a
  scan-line fill in 16.16 fixed point.
* ``polylines``: ``cv2.polylines`` of one closed polygon, thickness 1,
  ``LINE_8``: the 8-connected lines of ``LineIterator``, clipped to the
  image as ``cv::clipLine`` clips them.

A fused multiply-add of float32 operands is computed as
``float32(float64(a) * float64(b) + float64(c))``: the product is exact in
float64.  These were derived on OpenCV 5.0.0 on an x86-64 host with
AVX-512 (16 float32 lanes at the vector body's unroll) and are held to it
in tests/test_torch_raster.py.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

LANES = 16  # columns per block of OpenCV's vector warp body
XY_SHIFT = 16  # OpenCV's fixed-point fraction bits in the polygon fill
XY_ONE = 1 << XY_SHIFT


def _fma(a, b, c) -> np.ndarray:
    """float32 fused multiply-add ``a * b + c`` of float32 operands."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _lu_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``hal::LU`` of OpenCV on a float64 system, in its operation order."""
    a = [list(map(float, row)) for row in a]
    b = list(map(float, b))
    m = len(b)
    for i in range(m):
        k = max(range(i, m), key=lambda j: (abs(a[j][i]), -j))
        if abs(a[k][i]) < np.finfo(np.float64).eps * 10:
            raise np.linalg.LinAlgError("singular perspective system")
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, m):
            alpha = a[j][i] * d
            for kk in range(i + 1, m):
                a[j][kk] += alpha * a[i][kk]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for kk in range(i + 1, m):
            s -= a[i][kk] * b[kk]
        b[i] = s / a[i][i]
    return np.array(b, np.float64)


def perspective_transform(src4, dst4) -> np.ndarray:
    """The [3, 3] float64 homography taking the 4 points ``src4`` to
    ``dst4`` (float32 [4, 2] each), as ``cv2.getPerspectiveTransform``."""
    src = np.asarray(src4, np.float32).reshape(4, 2)
    dst = np.asarray(dst4, np.float32).reshape(4, 2)
    a = np.zeros((8, 8), np.float64)
    b = np.zeros(8, np.float64)
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        a[i, :3] = a[i + 4, 3:6] = (x, y, 1.0)
        # OpenCV multiplies the Point2f coordinates in float32
        a[i, 6], a[i, 7] = -(x * u), -(y * u)
        a[i + 4, 6], a[i + 4, 7] = -(x * v), -(y * v)
        b[i], b[i + 4] = u, v
    return np.append(_lu_solve(a, b), 1.0).reshape(3, 3)


def invert3(m) -> np.ndarray:
    """``cv::invert`` of a float64 [3, 3] matrix (DECOMP_LU takes the
    cofactor form at n = 3)."""
    s = np.asarray(m, np.float64).tolist()

    def e(i, j):
        return s[i][j]

    det = (e(0, 0) * (e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1))
           - e(0, 1) * (e(1, 0) * e(2, 2) - e(1, 2) * e(2, 0))
           + e(0, 2) * (e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0)))
    if det == 0.0:
        return np.zeros((3, 3), np.float64)
    d = 1.0 / det
    return np.array([
        [(e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1)) * d,
         (e(0, 2) * e(2, 1) - e(0, 1) * e(2, 2)) * d,
         (e(0, 1) * e(1, 2) - e(0, 2) * e(1, 1)) * d],
        [(e(1, 2) * e(2, 0) - e(1, 0) * e(2, 2)) * d,
         (e(0, 0) * e(2, 2) - e(0, 2) * e(2, 0)) * d,
         (e(0, 2) * e(1, 0) - e(0, 0) * e(1, 2)) * d],
        [(e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0)) * d,
         (e(0, 1) * e(2, 0) - e(0, 0) * e(2, 1)) * d,
         (e(0, 0) * e(1, 1) - e(0, 1) * e(1, 0)) * d]], np.float64)


def warp_perspective(src: np.ndarray, H, dsize: Tuple[int, int],
                     border_value: float = 0.0,
                     window: Optional[Tuple[int, int, int, int]] = None
                     ) -> np.ndarray:
    """``cv2.warpPerspective(src, H, dsize, INTER_LINEAR,
    BORDER_CONSTANT, border_value)`` of a float32 [h, w] image.

    ``window`` = (y0, y1, x0, x1) computes only those destination rows and
    columns and returns that [y1 - y0, x1 - x0] block; each pixel keeps
    the arithmetic of its absolute column (the last ``width % LANES``
    columns of a row are the scalar tail's)."""
    src = np.asarray(src, np.float32)
    width, height = dsize
    y0, y1, x0, x1 = window if window is not None else (0, height, 0, width)
    M = invert3(H).astype(np.float32)
    cols = np.arange(x0, x1)
    x = cols.astype(np.float32)[None, :]
    y = np.arange(y0, y1).astype(np.float32)[:, None]
    tail = (cols >= width - width % LANES)[None, :]

    def mapped(r):
        m0, m1, m2 = M[r]
        body = _fma(m0, x, m1 * y + m2)
        scalar = _fma(m0, x, m1 * y) + m2
        return np.where(tail, scalar, body)

    w = mapped(2)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = mapped(0) / w
        v = mapped(1) / w
        fx, fy = np.floor(u), np.floor(v)
        a, b = u - fx, v - fy
    h_src, w_src = src.shape
    bval = np.float32(border_value)

    def tap(ty, tx):
        ok = (tx >= 0) & (tx < w_src) & (ty >= 0) & (ty < h_src)
        xi = np.where(ok, tx, 0).astype(np.int64)
        yi = np.where(ok, ty, 0).astype(np.int64)
        return np.where(ok, src[yi, xi], bval)

    v00, v01 = tap(fy, fx), tap(fy, fx + 1)
    v10, v11 = tap(fy + 1, fx), tap(fy + 1, fx + 1)
    top = _fma(a, v01 - v00, v00)
    bot = _fma(a, v11 - v10, v10)
    out = _fma(b, bot - top, top)
    touches = (fx >= -1) & (fx < w_src) & (fy >= -1) & (fy < h_src)
    return np.where(touches, out, bval).astype(np.float32)


def clip_line(size: Tuple[int, int], p1, p2):
    """``cv::clipLine`` of the segment p1-p2 to an image of ``size`` =
    (width, height): (inside, p1, p2), clipped in its order (C's truncating
    conversions of double)."""
    right, bottom = size[0] - 1, size[1] - 1
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))

    def code_x(x):
        return (x < 0) + (x > right) * 2

    c1 = code_x(x1) + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = code_x(x2) + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = code_x(x1)
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = code_x(x2)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def line_pixels(size: Tuple[int, int], p1, p2
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(ys, xs) of ``cv::LineIterator(p1, p2, 8, leftToRight=true)`` on an
    image of ``size`` = (width, height)."""
    w, h = size
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, (x1, y1), (x2, y2) = clip_line(size, (x1, y1), (x2, y2))
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    # Bresenham: the minor coordinate steps where the error was negative
    err = dx - 2 * dy
    steps = np.zeros(dx + 1, np.int64)
    for i in range(1, dx + 1):
        steps[i] = err < 0
        err += -2 * dy + (2 * dx if err < 0 else 0)
    major = np.arange(dx + 1, dtype=np.int64)
    minor = np.cumsum(steps)
    if vert:
        return y1 + sy * major, x1 + sx * minor
    return y1 + sy * minor, x1 + sx * major


def _c_div(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def fill_convex_poly(img: np.ndarray, pts, value) -> None:
    """``cv2.fillConvexPoly(img, pts, value)`` in place: int32 points,
    ``LINE_8``, ``shift=0``."""
    v = [(int(p[0]), int(p[1])) for p in np.asarray(pts).reshape(-1, 2)]
    n = len(v)
    height, width = img.shape[:2]
    p0 = v[-1]
    for p in v:  # the outline
        ys, xs = line_pixels((width, height), p0, p)
        img[ys, xs] = value
        p0 = p
    xs_, ys_ = [p[0] for p in v], [p[1] for p in v]
    imin = int(np.argmin(ys_))  # the first vertex of least y
    xmin, xmax, ymin, ymax = min(xs_), max(xs_), min(ys_), max(ys_)
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= width or ymin >= height:
        return
    ymax = min(ymax, height - 1)
    half = XY_ONE >> 1
    # [idx, di, x, dx, ye] of the left- and right-going edges
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    edges = n
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = (idx0 + di) % n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = v[idx][1]
                    if ty > y:
                        xs = v[idx0][0] << XY_SHIFT
                        xe = v[idx][0] << XY_SHIFT
                        e[4] = ty
                        e[3] = _c_div((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            xx1 = (edge[left][2] + half) >> XY_SHIFT
            xx2 = (edge[right][2] + half) >> XY_SHIFT
            if xx2 >= 0 and xx1 < width:
                img[y, max(xx1, 0):min(xx2, width - 1) + 1] = value
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def polylines(img: np.ndarray, pts, color: Sequence[float]) -> None:
    """``cv2.polylines(img, [pts], True, color, 1)`` in place on an
    [H, W, C] image: one closed polygon of int32 points, thickness 1,
    ``LINE_8``, ``color`` of C values (rounded to ``img``'s dtype)."""
    v = [(int(p[0]), int(p[1])) for p in np.asarray(pts).reshape(-1, 2)]
    height, width = img.shape[:2]
    value = np.asarray(color, img.dtype)
    p0 = v[-1]
    for p in v:
        ys, xs = line_pixels((width, height), p0, p)
        img[ys, xs] = value
        p0 = p

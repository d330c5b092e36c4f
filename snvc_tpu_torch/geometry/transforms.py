"""Rigid / similarity transform estimation and PnP refinement on the host
(port of snvc_tpu/geometry/transforms.py; reference
snvc/utils/transformation.py:104-208).

Host numpy in float64, as in JAX: no device work, so no ``device``.  The
batched device versions are ``ops/registration.py``.  ``pnp_refine``
replaces JAX's ``cv2.solvePnP(SOLVEPNP_ITERATIVE)`` (the card's machine has
no cv2) by the same two steps in numpy: a linear start (DLT on the
undistorted normalized points; a homography for a coplanar set), then
Levenberg-Marquardt on the Rodrigues vector and the translation with
OpenCV's projection and (k1, k2, p1, p2[, k3]) distortion.
"""

from __future__ import annotations

import numpy as np


def rigid_transform(src, dst, weights=None):
    """Least-squares rigid transform (R, t) mapping src -> dst via SVD.

    src, dst: [d, N] point sets; weights: optional [N] importance weights.
    Reflections are corrected by flipping the last singular direction
    (reference: transformation.py:153-188).
    Returns R [d, d] and t [d, 1] with dst ~= R @ src + t.
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    assert src.shape == dst.shape
    mu_s = src.mean(axis=1, keepdims=True)
    mu_d = dst.mean(axis=1, keepdims=True)
    xs = src - mu_s
    xd = dst - mu_d
    if weights is None:
        H = xs @ xd.T
    else:
        w = np.asarray(weights, dtype=np.float64).reshape(-1)
        H = (xs * w) @ xd.T
    U, S, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        Vt = Vt.copy()
        Vt[-1, :] *= -1
        R = Vt.T @ U.T
    t = mu_d - R @ mu_s
    return R, t


def rigid_transform_2d(src, dst, weights=None):
    """Closed-form 2D weighted rigid transform (no SVD).

    For d=2 the optimal rotation angle is atan2 of the weighted
    cross-/dot-covariance; mathematically identical to the SVD route and
    the form used on-device (ops.registration).
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    w = (
        np.ones(src.shape[1])
        if weights is None
        else np.asarray(weights, dtype=np.float64).reshape(-1)
    )
    # NOTE: centroids are unweighted to match the reference exactly
    # (transformation.py:166-175 weights only the covariance).
    mu_s = src.mean(axis=1, keepdims=True)
    mu_d = dst.mean(axis=1, keepdims=True)
    xs = src - mu_s
    xd = dst - mu_d
    # covariance terms
    a = (w * (xs[0] * xd[0] + xs[1] * xd[1])).sum()  # trace term
    b = (w * (xs[0] * xd[1] - xs[1] * xd[0])).sum()  # cross term
    theta = np.arctan2(b, a)
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s], [s, c]])
    t = mu_d - R @ mu_s
    return R, t


def procrustes(src, dst, weights=None):
    """Apply the estimated rigid transform to src."""
    R, t = rigid_transform(src, dst, weights)
    return R @ src + t


def similarity_transform(X, Y, compute_optimal_scale: bool = False):
    """Procrustes alignment of Y onto X with optional uniform scaling
    (reference compute_similarity_transform, transformation.py:104-151).

    X, Y: [N, d] point sets (targets, inputs).
    Returns (d, Z, T, b, c): normalized squared error after alignment, the
    transformed Y, the rotation T (applied as ``Y @ T``), the scale b, and
    the translation c, with Z = b * Y @ T + c.
    """
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    muX, muY = X.mean(0), Y.mean(0)
    X0, Y0 = X - muX, Y - muY
    ssX = (X0**2).sum()
    ssY = (Y0**2).sum()
    normX, normY = np.sqrt(ssX), np.sqrt(ssY)
    X0 /= normX
    Y0 /= normY
    A = X0.T @ Y0
    U, s, Vt = np.linalg.svd(A, full_matrices=False)
    V = Vt.T
    # reflection correction on the last singular direction
    detT = np.linalg.det(V @ U.T)
    V[:, -1] *= np.sign(detT)
    s[-1] *= np.sign(detT)
    T = V @ U.T
    traceTA = s.sum()
    if compute_optimal_scale:
        b = traceTA * normX / normY
        d = 1 - traceTA**2
        Z = normX * traceTA * (Y0 @ T) + muX
    else:
        b = 1.0
        d = 1 + ssY / ssX - 2 * traceTA * normY / normX
        Z = normY * (Y0 @ T) + muX
    c = muX - b * (muY @ T)
    return d, Z, T, b, c


def rodrigues(rvec) -> np.ndarray:
    """Rotation matrix of the axis-angle vector ``rvec`` [3]
    (``cv2.Rodrigues``)."""
    r = np.asarray(rvec, dtype=np.float64).reshape(3)
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        return np.eye(3) + _skew(r)
    k = r / theta
    K = _skew(k)
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def _skew(v) -> np.ndarray:
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]])


def _rotation_vector(R) -> np.ndarray:
    """Axis-angle vector of the rotation matrix ``R`` (inverse of
    ``rodrigues``)."""
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(c)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if theta < 1e-8:
        return w / 2.0
    if np.pi - theta < 1e-6:
        # near pi: the axis is the column of R + I of largest norm
        B = R + np.eye(3)
        k = B[:, np.argmax(np.linalg.norm(B, axis=0))]
        return theta * k / np.linalg.norm(k)
    return theta * w / (2.0 * np.sin(theta))


def _distort(xy, dist) -> np.ndarray:
    """OpenCV's lens model on normalized points [N, 2]: (k1, k2, p1, p2
    [, k3])."""
    d = np.zeros(5)
    d[: len(dist)] = dist
    k1, k2, p1, p2, k3 = d
    x, y = xy[:, 0], xy[:, 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([xd, yd], axis=1)


def _undistort(xy, dist, iters: int = 20) -> np.ndarray:
    """Normalized points [N, 2] with the lens model undone by fixed-point
    iteration (the linear start only; the refinement uses the model
    itself)."""
    und = xy.copy()
    for _ in range(iters):
        und = und + (xy - _distort(und, dist))
    return und


def _project(params, X, K, dist) -> np.ndarray:
    """Pixels [N, 2] of the model points X [N, 3] under the pose params =
    (rvec, t) [6] (``cv2.projectPoints``)."""
    Xc = X @ rodrigues(params[:3]).T + params[3:]
    xy = _distort(Xc[:, :2] / Xc[:, 2:3], dist)
    return np.stack([K[0, 0] * xy[:, 0] + K[0, 2],
                     K[1, 1] * xy[:, 1] + K[1, 2]], axis=1)


def _linear_pose(X, xn):
    """(R, t) with xn ~ (R X + t)_xy / z from normalized points: DLT for a
    general set, a plane-induced homography for a coplanar one."""
    mu = X.mean(axis=0)
    Xc = X - mu
    _, s, Vt = np.linalg.svd(Xc, full_matrices=False)
    if s[2] > 1e-3 * s[0] and len(X) >= 6:
        rows = []
        for (a, b, c), (x, y) in zip(Xc, xn):
            rows.append([a, b, c, 1, 0, 0, 0, 0, -x * a, -x * b, -x * c, -x])
            rows.append([0, 0, 0, 0, a, b, c, 1, -y * a, -y * b, -y * c, -y])
        P = np.linalg.svd(np.asarray(rows))[2][-1].reshape(3, 4)
        U, S, Wt = np.linalg.svd(P[:, :3])
        R = U @ Wt
        t = P[:, 3] / S.mean()
        if np.linalg.det(R) < 0:
            R, t = -R, -t
        return R, t - R @ mu
    # coplanar: the plane's own frame (a, b, 0), then H ~ [r1 r2 t]
    B = Vt.T  # columns: the plane's axes, then its normal
    if np.linalg.det(B) < 0:
        B[:, 2] = -B[:, 2]
    ab = Xc @ B[:, :2]
    rows = []
    for (a, b), (x, y) in zip(ab, xn):
        rows.append([a, b, 1, 0, 0, 0, -x * a, -x * b, -x])
        rows.append([0, 0, 0, a, b, 1, -y * a, -y * b, -y])
    H = np.linalg.svd(np.asarray(rows))[2][-1].reshape(3, 3)
    lam = 2.0 / (np.linalg.norm(H[:, 0]) + np.linalg.norm(H[:, 1]))
    H = H * lam
    if H[2, 2] < 0:  # the plane's origin in front of the camera
        H = -H
    M = np.stack([H[:, 0], H[:, 1], np.cross(H[:, 0], H[:, 1])], axis=1)
    U, _, Wt = np.linalg.svd(M)
    Rp = U @ Wt
    if np.linalg.det(Rp) < 0:
        Rp = U @ np.diag([1.0, 1.0, -1.0]) @ Wt
    R = Rp @ B.T
    return R, H[:, 2] - R @ mu


def _refine(params, X, x, K, dist, max_iter: int = 100) -> np.ndarray:
    """Levenberg-Marquardt on the reprojection error in pixels, with a
    central-difference Jacobian."""

    def residual(p):
        return (_project(p, X, K, dist) - x).ravel()

    r = residual(params)
    cost = r @ r
    lam = 1e-3
    for _ in range(max_iter):
        J = np.empty((r.size, 6))
        for j in range(6):
            h = 1e-6 * max(1.0, abs(params[j]))
            e = np.zeros(6)
            e[j] = h
            J[:, j] = (residual(params + e) - residual(params - e)) / (2 * h)
        A = J.T @ J
        g = J.T @ r
        while True:
            delta = np.linalg.solve(A + lam * np.diag(np.diag(A) + 1e-12), -g)
            cand = params + delta
            rc = residual(cand)
            cc = rc @ rc
            if np.isfinite(cc) and cc <= cost:
                lam = max(lam / 10.0, 1e-12)
                break
            lam *= 10.0
            if lam > 1e12:
                return params
        step = np.abs(delta).max()
        params, r, cost = cand, rc, cc
        if step <= 1e-15 * max(1.0, np.abs(params).max()):
            break
    return params


def pnp_refine(prediction, observation, intrinsics, dist_coeffs=None):
    """Refine a 3D keypoint prediction against observed 2D keypoints with
    iterative PnP (reference pnp_refine, transformation.py:195-208; JAX
    ``cv2.solvePnP(..., SOLVEPNP_ITERATIVE)``).

    prediction: [N, 3] model points; observation: [N, 2] image points;
    intrinsics: [3, 3]; dist_coeffs: OpenCV's (k1, k2, p1, p2[, k3]),
    zeros by default.  Returns the model points expressed in the
    estimated camera pose ([3, N], reference layout), or ``prediction``
    unchanged if the solve fails (fewer than 4 points, non-finite input
    or a non-finite pose).
    """
    prediction = np.ascontiguousarray(prediction, dtype=np.float64)
    x = np.ascontiguousarray(observation, dtype=np.float64)
    K = np.asarray(intrinsics, dtype=np.float64)
    dist = np.zeros(4) if dist_coeffs is None else np.asarray(
        dist_coeffs, dtype=np.float64).ravel()
    if (len(prediction) < 4 or not np.isfinite(prediction).all()
            or not np.isfinite(x).all()):
        return prediction
    xn = np.stack([(x[:, 0] - K[0, 2]) / K[0, 0],
                   (x[:, 1] - K[1, 2]) / K[1, 1]], axis=1)
    with np.errstate(all="ignore"):
        try:
            R, t = _linear_pose(prediction, _undistort(xn, dist))
            params = _refine(np.concatenate([_rotation_vector(R), t]),
                             prediction, x, K, dist)
        except np.linalg.LinAlgError:
            return prediction
    if not np.isfinite(params).all():
        return prediction
    return rodrigues(params[:3]) @ prediction.T + params[3:, None]


def rotation_angle_2d(R) -> float:
    """Planar rotation angle from a 2x2 rotation matrix
    (reference: vernier.py:624-627)."""
    return float(np.arctan2(R[1, 0], R[0, 0]))

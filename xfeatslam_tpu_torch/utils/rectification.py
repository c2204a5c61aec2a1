"""Stereo rectification without OpenCV, on the host in numpy float64.

The JAX package rectifies an unrectified pinhole stereo rig with
``cv2.stereoRectify`` (``CALIB_ZERO_DISPARITY``, ``alpha=-1``),
``cv2.initUndistortRectifyMap`` (``CV_32FC1``) and ``cv2.remap``
(``INTER_LINEAR``, a constant 0 border) (``slam/settings.py``
``precompute_rectification`` and ``rectify``, the role of ORB-SLAM3's
Settings::precomputeRectificationMaps). The port does not depend on
OpenCV, so these are OpenCV's algorithms written out:

- ``stereo_rectify``: Bouguet's method. Each camera turns by half the
  relative rotation, then both by the rotation that puts the baseline on
  the x (or y) axis. The new focal length is the mean of the two cameras'
  fy. The principal points come from the undistorted image corners, and
  with zero disparity both cameras share their mean. With ``alpha=-1`` no
  scaling follows.
- ``undistort_points``: OpenCV's fixed-point iteration (5 steps), as
  ``cv2.undistortPoints`` without R and P.
- ``init_undistort_rectify_map``: for each rectified pixel, the source
  pixel through the inverse new projection and rotation, distorted and
  projected, accumulated along the row as OpenCV does, stored as float32.
- ``remap_linear``: OpenCV 5's bilinear remap of uint8 images: the four
  taps as float32 (0 outside the image), two fused multiply-add lerps
  along x and one along y at the map's fractional parts, rounded half to
  even. (OpenCV 4 rounds each map coordinate to 1/32 pixel and uses
  15-bit integer weights instead; with OpenCV 5.0, which the JAX package
  runs in the parity tests, that differs on ~60% of the pixels of a noise
  image, by up to 6 gray levels.)
"""

from __future__ import annotations

import numpy as np

_UNDISTORT_ITERS = 5


def rodrigues(v) -> np.ndarray:
    """A rotation vector (3,) or a rotation matrix (3,3) -> the other, as
    ``cv2.Rodrigues`` computes it."""
    v = np.asarray(v, np.float64)
    if v.shape == (3, 3):
        U, _, Vt = np.linalg.svd(v)
        R = U @ Vt
        r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        s = np.sqrt((r @ r) * 0.25)
        c = min(max((R[0, 0] + R[1, 1] + R[2, 2] - 1.0) * 0.5, -1.0), 1.0)
        theta = np.arccos(c)
        if s < 1e-5:
            if c > 0:
                return np.zeros(3)
            t = (np.diag(R) + 1.0) * 0.5
            r = np.sqrt(np.maximum(t, 0.0))
            if R[0, 1] < 0:
                r[1] = -r[1]
            if R[0, 2] < 0:
                r[2] = -r[2]
            if abs(r[0]) < abs(r[1]) and abs(r[0]) < abs(r[2]) and (
                    (R[1, 2] > 0) != (r[1] * r[2] > 0)):
                r[2] = -r[2]
            return r * (theta / np.sqrt(r @ r))
        return r * (theta / (2.0 * s))
    theta = np.sqrt(v @ v)
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = np.cos(theta), np.sin(theta)
    r = v / theta
    rx = np.array([[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]],
                   [-r[1], r[0], 0.0]])
    return c * np.eye(3) + (1.0 - c) * np.outer(r, r) + s * rx


def _dist(D) -> np.ndarray:
    """OpenCV's distortion vector k1 k2 p1 p2 k3 (missing terms 0)."""
    d = np.zeros(5)
    if D is not None:
        D = np.asarray(D, np.float64).reshape(-1)
        d[:len(D)] = D[:5]
    return d


def undistort_points(pts, K, D) -> np.ndarray:
    """``cv2.undistortPoints(pts, K, D)`` on (N,2) float32 pixels: the
    normalized undistorted coordinates, float32."""
    k1, k2, p1, p2, k3 = _dist(D)
    pts = np.asarray(pts, np.float32).astype(np.float64)
    x = (pts[:, 0] - K[0, 2]) * (1.0 / K[0, 0])
    y = (pts[:, 1] - K[1, 2]) * (1.0 / K[1, 1])
    x0, y0 = x.copy(), y.copy()
    for _ in range(_UNDISTORT_ITERS):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        bad = icdist < 0
        x = np.where(bad, x, (x0 - dx) * icdist)
        y = np.where(bad, y, (y0 - dy) * icdist)
    return np.stack([x, y], -1).astype(np.float32)


def stereo_rectify(K1, D1, K2, D2, size, R, T):
    """``cv2.stereoRectify(K1, D1, K2, D2, size, R, T,
    flags=CALIB_ZERO_DISPARITY, alpha=-1, newImageSize=size)``.

    R, T: camera 2 <- camera 1 (X2 = R X1 + T). size: (width, height).
    Returns (R1, R2, P1, P2): the rectifying rotations (3,3) and the new
    projections (3,4), float64."""
    K1, K2 = np.asarray(K1, np.float64), np.asarray(K2, np.float64)
    T = np.asarray(T, np.float64).reshape(3)
    r_r = rodrigues(rodrigues(R) * -0.5)
    t = r_r @ T
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    c, nt = t[idx], np.sqrt(t @ t)
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0
    ww = np.cross(t, uu)
    nw = np.sqrt(ww @ ww)
    if nw > 0.0:
        ww = ww * (np.arccos(abs(c) / nt) / nw)
    wR = rodrigues(ww)
    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t = R2 @ T

    nx, ny = int(size[0]), int(size[1])
    fc = (K1[idx ^ 1, idx ^ 1] + K2[idx ^ 1, idx ^ 1]) * 0.5
    corners = np.array([[0, 0], [nx - 1, 0], [0, ny - 1], [nx - 1, ny - 1]],
                       np.float32)
    cc = []
    for K, D, Rk in ((K1, D1, R1), (K2, D2, R2)):
        xy = undistort_points(corners, K, D).astype(np.float64)
        X = np.concatenate([xy, np.ones((4, 1))], 1) @ Rk.T
        proj = (fc * X[:, :2] / X[:, 2:]).astype(np.float32)
        avg = proj.astype(np.float64).mean(0)
        cc.append(np.array([(nx - 1) / 2.0 - avg[0], (ny - 1) / 2.0 - avg[1]]))
    cc = [(cc[0] + cc[1]) * 0.5] * 2
    P1 = np.zeros((3, 4))
    P2 = np.zeros((3, 4))
    for P, cck in ((P1, cc[0]), (P2, cc[1])):
        P[0, 0] = P[1, 1] = fc
        P[0, 2] = nx * cck[0] / nx
        P[1, 2] = ny * cck[1] / ny
        P[2, 2] = 1.0
    P2[idx, 3] = t[idx] * fc
    return R1, R2, P1, P2


def init_undistort_rectify_map(K, D, R, P, size):
    """``cv2.initUndistortRectifyMap(K, D, R, P, size, CV_32FC1)``: the
    (height, width) float32 maps of source x and y."""
    K = np.asarray(K, np.float64)
    k1, k2, p1, p2, k3 = _dist(D)
    width, height = int(size[0]), int(size[1])
    ir = np.linalg.inv(np.asarray(P, np.float64)[:3, :3]
                       @ np.asarray(R, np.float64)).reshape(-1)
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    i = np.arange(height, dtype=np.float64)[:, None]

    def along_row(start, step):
        # OpenCV adds the step pixel by pixel along the row
        acc = np.empty((height, width))
        acc[:, 0] = start[:, 0]
        acc[:, 1:] = step
        return np.add.accumulate(acc, axis=1)

    _x = along_row(i * ir[1] + ir[2], ir[0])
    _y = along_row(i * ir[4] + ir[5], ir[3])
    _w = along_row(i * ir[7] + ir[8], ir[6])
    w = 1.0 / _w
    x, y = _x * w, _y * w
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2.0 * x * y
    kr = 1.0 + ((k3 * r2 + k2) * r2 + k1) * r2
    xd = x * kr + p1 * _2xy + p2 * (r2 + 2.0 * x2)
    yd = y * kr + p1 * (r2 + 2.0 * y2) + p2 * _2xy
    return ((fx * xd + u0).astype(np.float32),
            (fy * yd + v0).astype(np.float32))


def _fma32(a, b, c):
    """float32 a * b + c as one fused multiply-add: the product is exact
    in float64, and the sum's rounding to float64 then float32 is a single
    rounding but where the float64 sum lands on a float32 tie."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def remap_linear(img, map_x, map_y) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR)`` of a (H,W) uint8
    image with (h,w) float32 maps, border constant 0, as OpenCV 5 computes
    it: float32 lerps by fused multiply-add, rounded half to even."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"remap_linear takes a (H,W) uint8 image, got "
                         f"{img.dtype} {img.shape}")
    H, W = img.shape
    mx = np.asarray(map_x, np.float32)
    my = np.asarray(map_y, np.float32)
    fx, fy = np.floor(mx), np.floor(my)
    a, b = mx - fx, my - fy
    x0 = np.clip(fx, -2, W + 1).astype(np.int64)
    y0 = np.clip(fy, -2, H + 1).astype(np.int64)
    src = img.astype(np.float32)

    def tap(y, x):
        inside = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        return np.where(inside, src[np.clip(y, 0, H - 1), np.clip(x, 0, W - 1)],
                        np.float32(0))

    p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
    p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = _fma32(a, p01 - p00, p00)
    bottom = _fma32(a, p11 - p10, p10)
    out = _fma32(b, bottom - top, top)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)

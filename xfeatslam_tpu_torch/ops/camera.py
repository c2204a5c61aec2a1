"""Camera models on tensors: pinhole with OpenCV radial-tangential
distortion, and the Kannala-Brandt fisheye (KB8).

Counterpart of ``xfeatslam_tpu/ops/camera.py``. The intrinsics are Python
floats, so no device scalar is read back or copied in. All functions
broadcast over leading batch dimensions; points ``Xc`` are in the camera
frame, pixels ``uv`` are (u, v). ``stereo_triangulate_matches`` is the
batched two-camera triangulation of a stereo (fisheye) rig.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_EPS = 1e-9


class Pinhole(NamedTuple):
    """Pinhole intrinsics + radial-tangential distortion (the YAML order
    fx fy cx cy [k1 k2 p1 p2 [k3]])."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0

    @staticmethod
    def from_list(vals):
        vals = [float(v) for v in vals] + [0.0] * (9 - len(vals))
        return Pinhole(*vals[:9])

    def params_list(self):
        return [float(p) for p in self]

    @property
    def K(self):
        """The 3x3 intrinsic matrix, float32 on the CPU."""
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32)


class KannalaBrandt8(NamedTuple):
    """KB8 fisheye: the theta-polynomial model (the YAML order fx fy cx cy
    k1 k2 k3 k4, here k0..k3)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k0: float
    k1: float
    k2: float
    k3: float

    @staticmethod
    def from_list(vals):
        return KannalaBrandt8(*[float(v) for v in vals])

    def params_list(self):
        return [float(p) for p in self]

    @property
    def K(self):
        """The 3x3 intrinsic matrix, float32 on the CPU."""
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32)


def _inv(z):
    return 1.0 / torch.where(z.abs() < _EPS, _EPS, z)


def pinhole_project(cam: Pinhole, Xc):
    """Camera-frame points (...,3) -> pixels (...,2). No distortion."""
    inv_z = _inv(Xc[..., 2])
    return torch.stack([cam.fx * Xc[..., 0] * inv_z + cam.cx,
                        cam.fy * Xc[..., 1] * inv_z + cam.cy], -1)


def pinhole_unproject(cam: Pinhole, uv):
    """Pixels (...,2) -> unit-plane bearing (...,3) with z=1."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x, y, torch.ones_like(x)], -1)


def pinhole_project_jac(cam: Pinhole, Xc):
    """d(uv)/d(Xc): (...,2,3) (Pinhole::projectJac)."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    inv_z = _inv(z)
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(x)
    row0 = torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], -1)
    row1 = torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], -1)
    return torch.stack([row0, row1], -2)


def distort_normalized(cam: Pinhole, xy):
    """Apply radial-tangential distortion to normalized coords (...,2)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xy_prod = 2.0 * x * y
    xd = x * radial + cam.p1 * xy_prod + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p2 * xy_prod + cam.p1 * (r2 + 2.0 * y * y)
    return torch.stack([xd, yd], -1)


def undistort_points(cam: Pinhole, uv, iters: int = 8):
    """Undistort pixel keypoints (...,2) by fixed-point iteration from the
    distorted normalized coordinates (the cv::undistortPoints scheme, 8
    iterations). Valid for pixels inside the sensor."""
    x0 = (uv[..., 0] - cam.cx) / cam.fx
    y0 = (uv[..., 1] - cam.cy) / cam.fy
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        xy_prod = 2.0 * x * y
        dx = cam.p1 * xy_prod + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p2 * xy_prod + cam.p1 * (r2 + 2.0 * y * y)
        inv_r = _inv(radial)
        x, y = (x0 - dx) * inv_r, (y0 - dy) * inv_r
    return torch.stack([cam.fx * x + cam.cx, cam.fy * y + cam.cy], -1)


def kb8_project(cam: KannalaBrandt8, Xc):
    """The theta-polynomial projection, camera points (...,3) -> pixels
    (...,2)."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    r = torch.sqrt(x * x + y * y + _EPS * _EPS)
    theta = torch.atan2(r, z)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (cam.k0 + t2 * (cam.k1 + t2 * (
        cam.k2 + t2 * cam.k3))))
    scale = torch.where(r < 1e-6, torch.ones_like(r), theta_d / r)
    return torch.stack([cam.fx * scale * x + cam.cx,
                        cam.fy * scale * y + cam.cy], -1)


def kb8_unproject(cam: KannalaBrandt8, uv, iters: int = 10):
    """Pixels (...,2) -> bearing (...,3) with z=1, by ``iters`` Newton
    steps on the theta polynomial."""
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    theta_d = torch.sqrt(mx * mx + my * my + _EPS * _EPS).clamp(
        -math.pi / 2.0, math.pi / 2.0)
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        t4, t6, t8 = t2 * t2, t2 * t2 * t2, t2 * t2 * t2 * t2
        k0t, k1t, k2t, k3t = cam.k0 * t2, cam.k1 * t4, cam.k2 * t6, cam.k3 * t8
        f = theta * (1.0 + k0t + k1t + k2t + k3t) - theta_d
        fp = 1.0 + 3.0 * k0t + 5.0 * k1t + 7.0 * k2t + 9.0 * k3t
        theta = theta - f / torch.where(fp.abs() < _EPS, _EPS, fp)
    scale = torch.where(theta_d.abs() < 1e-8, torch.ones_like(theta),
                        torch.tan(theta) / theta_d)
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], -1)


def kb8_project_jac(cam: KannalaBrandt8, Xc):
    """Analytic d(uv)/d(Xc): (...,2,3)."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(r2 + _EPS * _EPS)
    R2 = r2 + z * z
    theta = torch.atan2(r, z)
    t2 = theta * theta
    t4, t6, t8 = t2 * t2, t2 * t2 * t2, t2 * t2 * t2 * t2
    f = theta * (1.0 + cam.k0 * t2 + cam.k1 * t4 + cam.k2 * t6 + cam.k3 * t8)
    fd = (1.0 + 3.0 * cam.k0 * t2 + 5.0 * cam.k1 * t4 + 7.0 * cam.k2 * t6
          + 9.0 * cam.k3 * t8)
    inv_r = 1.0 / r
    dtheta_dx = x * z / (R2 * r)
    dtheta_dy = y * z / (R2 * r)
    dtheta_dz = -r / R2
    # d(f/r)/d* = (fd * dtheta * r - f * dr) / r^2
    g = f * inv_r
    dg_dx = (fd * dtheta_dx - g * (x * inv_r)) * inv_r
    dg_dy = (fd * dtheta_dy - g * (y * inv_r)) * inv_r
    dg_dz = fd * dtheta_dz * inv_r
    row0 = torch.stack([cam.fx * (g + x * dg_dx), cam.fx * x * dg_dy,
                        cam.fx * x * dg_dz], -1)
    row1 = torch.stack([cam.fy * y * dg_dx, cam.fy * (g + y * dg_dy),
                        cam.fy * y * dg_dz], -1)
    return torch.stack([row0, row1], -2)


def stereo_triangulate_matches(cam1, cam2, uv1, uv2, R12, t12,
                               sigma2_1=1.0, sigma2_2=1.0,
                               min_parallax_cos: float = 0.9998):
    """Batched two-camera triangulation (KannalaBrandt8::TriangulateMatches)
    of N matched keypoint pairs of a stereo rig with extrinsic T12 (camera
    1 <- camera 2), pinhole or fisheye: unproject both rays, gate by
    parallax, triangulate by a 4x4 DLT on normalized coordinates in the
    camera-1 frame (``torch.linalg.svd``), then gate by chirality and the
    chi2 reprojection error in both views. The 3x3 products are elementwise
    (no TF32).

    Returns (X (N,3) points in the camera-1 frame, depth (N,) z in camera
    1, ok (N,) bool)."""
    from .lie import mat_vec

    r1 = unproject(cam1, uv1)
    r2 = unproject(cam2, uv2)
    r21 = mat_vec(R12, r2)
    cosp = (r1 * r21).sum(-1) / (torch.linalg.vector_norm(r1, dim=-1)
                                 * torch.linalg.vector_norm(r21, dim=-1)
                                 + _EPS)
    ok = cosp <= min_parallax_cos

    # P1 = [I|0], P2 = [R21|-R21 t12]
    R21 = R12.T
    t2 = -mat_vec(R21, t12)
    P1 = torch.cat([torch.eye(3, dtype=R12.dtype, device=R12.device),
                    torch.zeros((3, 1), dtype=R12.dtype, device=R12.device)],
                   1)
    P2 = torch.cat([R21, t2[:, None]], 1)
    x1, y1 = r1[..., 0:1], r1[..., 1:2]
    x2, y2 = r2[..., 0:1], r2[..., 1:2]
    rows = torch.stack([x1 * P1[2] - P1[0], y1 * P1[2] - P1[1],
                        x2 * P2[2] - P2[0], y2 * P2[2] - P2[1]], -2)
    _u, _s, vh = torch.linalg.svd(rows)
    Xh = vh[..., -1, :]
    w = Xh[..., 3:]
    X = Xh[..., :3] / torch.where(w.abs() < _EPS, _EPS, w)

    z1 = X[..., 2]
    X2 = mat_vec(R21, X) + t2
    ok = ok & (z1 > 0) & (X2[..., 2] > 0)
    e1 = project(cam1, X) - uv1
    e2 = project(cam2, X2) - uv2
    ok = ok & ((e1 * e1).sum(-1) <= 5.991 * sigma2_1)
    ok = ok & ((e2 * e2).sum(-1) <= 5.991 * sigma2_2)
    return X, z1, ok


def project(cam, Xc):
    if isinstance(cam, Pinhole):
        return pinhole_project(cam, Xc)
    _require_model(cam)
    return kb8_project(cam, Xc)


def unproject(cam, uv):
    if isinstance(cam, Pinhole):
        return pinhole_unproject(cam, uv)
    _require_model(cam)
    return kb8_unproject(cam, uv)


def project_jac(cam, Xc):
    if isinstance(cam, Pinhole):
        return pinhole_project_jac(cam, Xc)
    _require_model(cam)
    return kb8_project_jac(cam, Xc)


def _require_model(cam):
    if not isinstance(cam, KannalaBrandt8):
        raise TypeError(f"a camera of this package is needed (Pinhole or "
                        f"KannalaBrandt8), got {type(cam).__module__}."
                        f"{type(cam).__name__}")

"""Pinhole camera model with OpenCV radial-tangential distortion, on tensors.

Counterpart of the Pinhole part of ``xfeatslam_tpu/ops/camera.py``
(KannalaBrandt8 comes with the stereo and fisheye slice). The intrinsics
are Python floats, so no device scalar is read back or copied in. All
functions broadcast over leading batch dimensions; points ``Xc`` are in
the camera frame, pixels ``uv`` are (u, v).
"""

from __future__ import annotations

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


def project(cam, Xc):
    _require_pinhole(cam)
    return pinhole_project(cam, Xc)


def unproject(cam, uv):
    _require_pinhole(cam)
    return pinhole_unproject(cam, uv)


def project_jac(cam, Xc):
    _require_pinhole(cam)
    return pinhole_project_jac(cam, Xc)


def _require_pinhole(cam):
    if not isinstance(cam, Pinhole):
        raise TypeError(f"only Pinhole cameras are ported, got "
                        f"{type(cam).__name__}")

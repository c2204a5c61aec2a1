"""Synthetic RGB-D sequences: a ray-cast textured room corner with
ground-truth poses, for tests and on-card drives.

The port's own copy of ``_texture``, ``RoomScene``, ``orbit_trajectory``
and ``make_sequence`` from ``xfeatslam_tpu/utils/synthetic.py`` (numpy
only): the same seed renders the same images and depths bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


def _texture(rng, n=512, octaves=5, n_speckles=1500):
    """Procedural texture: multi-octave value noise + sharp speckle dots.

    The speckles give well-localized contrast corners (detection on smooth
    noise alone jitters by several px — maxima are too broad)."""
    tex = np.zeros((n, n), np.float32)
    amp = 1.0
    for o in range(octaves):
        k = 4 * (2 ** o)
        coarse = rng.standard_normal((k, k)).astype(np.float32)
        # bilinear upsample to n x n
        xi = np.linspace(0, k - 1, n)
        x0 = np.floor(xi).astype(int)
        x1 = np.minimum(x0 + 1, k - 1)
        wx = (xi - x0).astype(np.float32)
        rows = coarse[:, x0] * (1 - wx) + coarse[:, x1] * wx
        up = rows[x0, :] * (1 - wx[:, None]) + rows[x1, :] * wx[:, None]
        tex += amp * up
        amp *= 0.55
    tex -= tex.min()
    tex /= tex.max() + 1e-9
    # sharp but DIVERSE speckles: random size, intensity, and shape so ORB
    # descriptors can discriminate them (identical dots alias: coherent
    # wrong-match subsets form secondary pose-cost minima)
    ys = rng.integers(4, n - 6, n_speckles)
    xs = rng.integers(4, n - 6, n_speckles)
    for y, x in zip(ys, xs):
        sy = int(rng.integers(1, 5))
        sx = int(rng.integers(1, 5))
        amp = rng.uniform(0.35, 0.95) * rng.choice([-1.0, 1.0])
        patch = tex[y : y + sy, x : x + sx]
        jitter = rng.uniform(0.7, 1.0, patch.shape).astype(np.float32)
        tex[y : y + sy, x : x + sx] = np.clip(patch + amp * jitter, 0, 1)
    return tex


@dataclass
class RoomScene:
    """Three orthogonal textured planes forming a room corner:
      back wall  z = z_wall
      floor      y = y_floor
      side wall  x = x_wall
    Cameras look roughly +z toward the corner."""

    # TUM-fr1-like proximity (0.8-3m): close scenes give strong depth
    # observability (bf/z^2); far walls leave camera-z weakly constrained
    z_wall: float = 3.0
    y_floor: float = 1.1
    x_wall: float = 2.0
    tex_scale: float = 0.7  # texture periods per meter
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.tex = [_texture(rng) for _ in range(3)]
        # close textured boxes: without near structure the view degenerates
        # to a fronto-parallel far wall and depth becomes unobservable
        self.boxes = []
        for i in range(6):
            cx = rng.uniform(-1.2, 1.2)
            cy = rng.uniform(0.6, 1.0)
            cz = rng.uniform(1.2, 2.4)
            s = rng.uniform(0.15, 0.35)
            lo = np.array([cx - s, cy - s, cz - s], np.float32)
            hi = np.array([cx + s, cy + s, cz + s], np.float32)
            self.boxes.append((lo, hi, _texture(rng, n=128, octaves=4,
                                                 n_speckles=400)))

    def render(self, K: np.ndarray, R_cw: np.ndarray, t_cw: np.ndarray,
               hw: Tuple[int, int], rays_c: np.ndarray = None):
        """Render grayscale + depth for camera pose Tcw=(R_cw,t_cw).

        rays_c: optional (H,W,3) per-pixel camera rays (z=1 normalized) for
        non-pinhole models (fisheye); default = pinhole rays from K.
        Returns (gray uint8 (H,W), depth float32 (H,W) z-depth, >0 valid).
        """
        H, W = hw
        if rays_c is None:
            fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
            u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                               np.arange(H, dtype=np.float32))
            rays_c = np.stack([(u - cx) / fx, (v - cy) / fy,
                               np.ones_like(u)], -1)
        R_wc = R_cw.T
        C = -R_wc @ t_cw  # camera center in world
        rays_w = rays_c @ R_wc.T  # (H,W,3)

        INF = np.float32(1e9)
        best_depth = np.full((H, W), INF, np.float32)
        gray = np.zeros((H, W), np.float32)

        planes = [
            (2, self.z_wall, (0, 1)),   # z = z_wall, texture uv from (x,y)
            (1, self.y_floor, (0, 2)),  # y = y_floor, uv from (x,z)
            (0, self.x_wall, (1, 2)),   # x = x_wall, uv from (y,z)
        ]
        for tex, (axis, level, uvdims) in zip(self.tex, planes):
            d = rays_w[..., axis]
            lam = np.where(np.abs(d) > 1e-6, (level - C[axis]) / d, -1.0)
            # rays_c has z = 1, so the ray parameter lam is the camera depth
            hit = (lam > 0.05) & (lam < best_depth)
            p = C[None, None, :] + lam[..., None] * rays_w
            uu = p[..., uvdims[0]] * self.tex_scale
            vv = p[..., uvdims[1]] * self.tex_scale
            n = tex.shape[0]
            ui = np.mod(uu * n * 0.12, n - 1)
            vi = np.mod(vv * n * 0.12, n - 1)
            u0, v0 = ui.astype(int), vi.astype(int)
            wu, wv = ui - u0, vi - v0
            val = (
                tex[v0, u0] * (1 - wu) * (1 - wv)
                + tex[v0, np.minimum(u0 + 1, n - 1)] * wu * (1 - wv)
                + tex[np.minimum(v0 + 1, n - 1), u0] * (1 - wu) * wv
                + tex[np.minimum(v0 + 1, n - 1), np.minimum(u0 + 1, n - 1)] * wu * wv
            )
            gray = np.where(hit, val, gray)
            best_depth = np.where(hit, lam, best_depth)

        # boxes (slab-method ray intersection, nearest-surface wins)
        for (lo, hi, tex) in self.boxes:
            d = rays_w
            safe_d = np.where(np.abs(d) < 1e-9, 1e-9, d)
            t1 = (lo[None, None, :] - C[None, None, :]) / safe_d
            t2 = (hi[None, None, :] - C[None, None, :]) / safe_d
            tmin = np.minimum(t1, t2)
            tmax = np.maximum(t1, t2)
            tnear = tmin.max(-1)
            tfar = tmax.min(-1)
            hit = (tnear < tfar) & (tnear > 0.05) & (tnear < best_depth)
            face_axis = tmin.argmax(-1)  # axis of the entry face
            p = C[None, None, :] + tnear[..., None] * d
            # texture uv from the two non-face axes
            n = tex.shape[0]
            uu = np.take_along_axis(p, ((face_axis + 1) % 3)[..., None], -1)[..., 0]
            vv = np.take_along_axis(p, ((face_axis + 2) % 3)[..., None], -1)[..., 0]
            ui = np.mod(np.abs(uu) * n * 0.8, n - 1)
            vi = np.mod(np.abs(vv) * n * 0.8, n - 1)
            u0, v0 = ui.astype(int), vi.astype(int)
            wu, wv = ui - u0, vi - v0
            val = (
                tex[v0, u0] * (1 - wu) * (1 - wv)
                + tex[v0, np.minimum(u0 + 1, n - 1)] * wu * (1 - wv)
                + tex[np.minimum(v0 + 1, n - 1), u0] * (1 - wu) * wv
                + tex[np.minimum(v0 + 1, n - 1), np.minimum(u0 + 1, n - 1)] * wu * wv
            )
            gray = np.where(hit, val, gray)
            best_depth = np.where(hit, tnear, best_depth)

        depth = np.where(best_depth < INF, best_depth, 0.0).astype(np.float32)
        img = (np.clip(gray, 0, 1) * 235 + 10).astype(np.uint8)
        return img, depth


def orbit_trajectory(n_frames: int, radius: float = 0.15,
                     forward_per_frame: float = 0.005, yaw_amp: float = 0.12,
                     period: int = 120):
    """Smooth exploratory trajectory with CONSTANT per-frame motion (speed
    does not depend on sequence length): slight orbit + forward drift,
    looking +z. Returns list of (R_cw, t_cw) world->camera poses."""
    poses = []
    for i in range(n_frames):
        ang = 2 * np.pi * i / period
        # camera center in world
        C = np.array(
            [radius * np.sin(ang), 0.25 * radius * np.sin(2 * ang),
             forward_per_frame * i], np.float32
        )
        yaw = yaw_amp * np.sin(ang)
        pitch = 0.05 * np.sin(2 * ang)
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        R_wc = np.array(
            [[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32
        ) @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
        R_cw = R_wc.T
        t_cw = -R_cw @ C
        poses.append((R_cw.astype(np.float32), t_cw.astype(np.float32)))
    return poses


def make_sequence(n_frames: int = 60, hw=(480, 640), K=None, seed: int = 0,
                  fps: float = 30.0, period: int = 120,
                  forward_per_frame: float = 0.005):
    """Full synthetic RGB-D sequence.

    ``period`` frames complete one orbit revolution: a sequence longer than
    one period revisits its starting viewpoints. Keep
    ``forward_per_frame * period`` small for a revisit that overlaps.

    Returns dict with images (list of uint8 (H,W)), depths (float32 meters),
    timestamps, gt poses (R_cw,t_cw), K.
    """
    if K is None:
        K = np.array(
            [[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]], np.float32
        )
    scene = RoomScene(seed=seed)
    poses = orbit_trajectory(n_frames, period=period,
                             forward_per_frame=forward_per_frame)
    images, depths = [], []
    for (R, t) in poses:
        img, dep = scene.render(K, R, t, hw)
        images.append(img)
        depths.append(dep)
    ts = [i / fps for i in range(n_frames)]
    return {
        "images": images,
        "depths": depths,
        "timestamps": ts,
        "poses": poses,
        "K": K,
    }

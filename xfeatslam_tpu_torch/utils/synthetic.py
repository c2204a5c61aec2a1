"""Synthetic RGB-D sequences: a ray-cast textured room corner with
ground-truth poses, for tests and on-card drives.

The port's own copy of ``_texture``, ``RoomScene``, ``orbit_trajectory``,
``make_sequence``, the visual-inertial ``make_vi_sequence`` and
``make_imu_trajectory`` from ``xfeatslam_tpu/utils/synthetic.py`` (numpy
only): the same seed renders the same images and depths and draws the same
IMU noise, bit for bit.
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


def make_vi_sequence(n_frames: int = 50, fps: float = 10.0,
                     imu_rate: float = 200.0, hw=(480, 640), K=None,
                     seed: int = 0, g_dir=None, bg=None, ba=None,
                     noise_gyro: float = 0.0, noise_acc: float = 0.0,
                     T_bc: np.ndarray = None, render_depth: bool = True):
    """Rendered visual-inertial sequence: the RoomScene viewed along a
    smooth, analytically-differentiable body trajectory with consistent IMU.

    World gravity is 9.81 * g_dir (default tilted, NOT -z, so gravity
    alignment is non-trivial). Gyro is exact by construction (rotation is
    integrated from the analytic angular velocity at the IMU rate);
    accelerometer comes from the analytic second derivative:
    a_body = R_wb^T (p_ddot - g) + ba + noise.

    Returns dict: images, depths, timestamps, poses (R_cw,t_cw GT),
    imu (list per frame: samples strictly after the previous frame up to and
    including this frame, as (acc, gyro, t) tuples), p_wb/R_wb/v_w GT body
    states at frame times, g_w, K.
    """
    if K is None:
        K = np.array(
            [[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]], np.float32
        )
    if T_bc is None:
        T_bc = np.eye(4, dtype=np.float32)
    R_bc = T_bc[:3, :3].astype(np.float64)
    t_bc = T_bc[:3, 3].astype(np.float64)
    rng = np.random.default_rng(seed)
    if g_dir is None:
        g_dir = np.array([0.15, -0.1, -0.98])
    g_dir = np.asarray(g_dir, np.float64)
    g_dir /= np.linalg.norm(g_dir)
    g_w = 9.81 * g_dir
    bg = np.zeros(3) if bg is None else np.asarray(bg, np.float64)
    ba = np.zeros(3) if ba is None else np.asarray(ba, np.float64)

    # small-amplitude wander in front of the room corner, looking +z.
    # Frequencies are chosen for ~1.3 m/s^2 peak acceleration: monocular
    # scale is observable only through acceleration excitation (the scale
    # column of the init problem is ~|p_ddot| against the 9.81 gravity
    # column). At ~0.5 m/s^2 the scale/acc-bias trade-off is nearly flat —
    # a free-bias solve absorbs ~10% scale error into ~0.1 m/s^2 of bias —
    # so amplitudes stay small (view keeps the room) while frequencies push
    # |p_ddot| up without raising the peak velocity (a = v*w).
    AX, AY, AZ = 0.11, 0.08, 0.05
    WX, WY, WZ = 3.2, 2.7, 2.2

    def pos(t):
        return np.array([AX * np.sin(WX * t),
                         AY * np.cos(WY * t) - AY,
                         AZ * np.sin(WZ * t) + 0.02 * t])

    def vel(t):
        return np.array([AX * WX * np.cos(WX * t),
                         -AY * WY * np.sin(WY * t),
                         AZ * WZ * np.cos(WZ * t) + 0.02])

    def accel(t):
        return np.array([-AX * WX * WX * np.sin(WX * t),
                         -AY * WY * WY * np.cos(WY * t),
                         -AZ * WZ * WZ * np.sin(WZ * t)])

    def omega(t):  # body angular velocity, keeps the view near +z
        return np.array([0.09 * np.sin(1.2 * t),
                         0.11 * np.cos(1.5 * t),
                         0.07 * np.sin(0.8 * t)])

    def so3_exp(phi):
        th = np.linalg.norm(phi)
        Kx = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]],
                       [-phi[1], phi[0], 0]])
        if th < 1e-12:
            return np.eye(3) + Kx
        return (np.eye(3) + np.sin(th) / th * Kx
                + (1 - np.cos(th)) / (th * th) * (Kx @ Kx))

    dt = 1.0 / imu_rate
    frame_dt = 1.0 / fps
    steps_per_frame = int(round(frame_dt / dt))
    n_steps = steps_per_frame * (n_frames - 1)
    # integrate body rotation at the IMU rate
    R = np.eye(3)
    Rs = [R.copy()]
    for i in range(n_steps):
        R = R @ so3_exp(omega(i * dt) * dt)
        Rs.append(R.copy())
    Rs = np.stack(Rs)

    scene = RoomScene(seed=seed)
    images, depths, poses, imu_lists = [], [], [], []
    R_wb_gt, p_wb_gt, v_w_gt, ts = [], [], [], []
    for k in range(n_frames):
        t_k = k * frame_dt
        i_k = k * steps_per_frame
        R_wb = Rs[i_k]
        p_wb = pos(t_k)
        # camera pose from the body state
        R_wc = R_wb @ R_bc
        C = p_wb + R_wb @ t_bc
        R_cw = R_wc.T.astype(np.float32)
        t_cw = (-R_wc.T @ C).astype(np.float32)
        img, dep = scene.render(K, R_cw, t_cw, hw)
        images.append(img)
        depths.append(dep if render_depth else None)
        poses.append((R_cw, t_cw))
        R_wb_gt.append(R_wb.astype(np.float32))
        p_wb_gt.append(p_wb.astype(np.float32))
        v_w_gt.append(vel(t_k).astype(np.float32))
        ts.append(t_k)
        # IMU samples in (t_{k-1}, t_k]
        samples = []
        if k > 0:
            for i in range(i_k - steps_per_frame, i_k):
                t_i = i * dt
                a_b = (Rs[i].T @ (accel(t_i) - g_w) + ba
                       + noise_acc * rng.standard_normal(3))
                w_b = omega(t_i) + bg + noise_gyro * rng.standard_normal(3)
                samples.append((a_b.astype(np.float32),
                                w_b.astype(np.float32),
                                float(t_i + dt)))
        imu_lists.append(samples)
    return dict(
        images=images, depths=depths, timestamps=ts, poses=poses,
        imu=imu_lists, R_wb=np.stack(R_wb_gt), p_wb=np.stack(p_wb_gt),
        v_w=np.stack(v_w_gt), g_w=g_w.astype(np.float32),
        bg=bg.astype(np.float32), ba=ba.astype(np.float32), K=K,
    )


def make_imu_trajectory(n_kf: int = 16, kf_dt: float = 0.25,
                        imu_rate: float = 200.0, seed: int = 0,
                        g_dir=None, bg=None, ba=None,
                        noise_gyro: float = 0.0, noise_acc: float = 0.0):
    """Synthetic smooth body trajectory + consistent IMU measurements.

    The world frame's gravity is g = 9.81 * g_dir (default a tilted
    direction, NOT -z, so gravity-direction estimation is non-trivial).
    Angular velocity is defined analytically and the rotation is integrated
    at the IMU rate, so gyro measurements are exact by construction;
    accelerometer measurements come from the analytic second derivative of
    the position spline: a_body = R_wb^T (p_ddot - g).

    Returns dict:
      t_kf (K,), R_wb (K,3,3), p_wb (K,3), v_w (K,3),
      imu: list of K-1 dicts {acc (N,3), gyro (N,3), dts (N,)} per segment
      g_w (3,), bg, ba (injected biases, added to the measurements)
    """
    rng = np.random.default_rng(seed)
    if g_dir is None:
        g_dir = np.array([0.15, -0.1, -0.98])
    g_dir = np.asarray(g_dir, np.float64)
    g_dir /= np.linalg.norm(g_dir)
    g_w = 9.81 * g_dir
    bg = np.zeros(3) if bg is None else np.asarray(bg, np.float64)
    ba = np.zeros(3) if ba is None else np.asarray(ba, np.float64)

    def pos(t):
        return np.array([0.8 * np.sin(0.9 * t),
                         0.5 * np.cos(0.7 * t),
                         0.3 * np.sin(0.5 * t) + 0.1 * t])

    def vel(t):
        return np.array([0.8 * 0.9 * np.cos(0.9 * t),
                         -0.5 * 0.7 * np.sin(0.7 * t),
                         0.3 * 0.5 * np.cos(0.5 * t) + 0.1])

    def accel(t):
        return np.array([-0.8 * 0.81 * np.sin(0.9 * t),
                         -0.5 * 0.49 * np.cos(0.7 * t),
                         -0.3 * 0.25 * np.sin(0.5 * t)])

    def omega(t):  # body angular velocity (rad/s), analytic
        return np.array([0.3 * np.sin(0.6 * t),
                         0.25 * np.cos(0.8 * t),
                         0.4 * np.sin(0.4 * t)])

    def so3_exp(phi):
        th = np.linalg.norm(phi)
        K = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]],
                      [-phi[1], phi[0], 0]])
        if th < 1e-12:
            return np.eye(3) + K
        return (np.eye(3) + np.sin(th) / th * K
                + (1 - np.cos(th)) / (th * th) * (K @ K))

    dt = 1.0 / imu_rate
    total = (n_kf - 1) * kf_dt
    n_steps = int(round(total / dt))
    R = np.eye(3)
    Rs = [R.copy()]
    ts = [0.0]
    for i in range(n_steps):
        t = i * dt
        R = R @ so3_exp(omega(t) * dt)
        Rs.append(R.copy())
        ts.append((i + 1) * dt)
    Rs = np.stack(Rs)
    ts = np.asarray(ts)

    steps_per_seg = int(round(kf_dt / dt))
    kf_idx = np.arange(n_kf) * steps_per_seg
    t_kf = ts[kf_idx]
    R_wb = Rs[kf_idx].astype(np.float32)
    p_wb = np.stack([pos(t) for t in t_kf]).astype(np.float32)
    v_w = np.stack([vel(t) for t in t_kf]).astype(np.float32)

    segments = []
    for k in range(n_kf - 1):
        i0, i1 = kf_idx[k], kf_idx[k + 1]
        accs, gyrs, dtss = [], [], []
        for i in range(i0, i1):
            t = ts[i]
            a_w = accel(t) - g_w
            a_b = Rs[i].T @ a_w + ba + noise_acc * rng.standard_normal(3)
            w_b = omega(t) + bg + noise_gyro * rng.standard_normal(3)
            accs.append(a_b)
            gyrs.append(w_b)
            dtss.append(dt)
        segments.append(dict(
            acc=np.asarray(accs, np.float32),
            gyro=np.asarray(gyrs, np.float32),
            dts=np.asarray(dtss, np.float32),
        ))
    return dict(t_kf=t_kf, R_wb=R_wb, p_wb=p_wb, v_w=v_w, imu=segments,
                g_w=g_w.astype(np.float32), bg=bg.astype(np.float32),
                ba=ba.astype(np.float32))


def make_loop_map(rng, n_kf=14, n_pts=400, drift_per_kf=0.012,
                  revisit_tail=2, period=None, drift_xi=None,
                  desc_dim=64, bf=0.0,
                  px_noise: float = 0.0, desc_noise: float = 0.0):
    """A drifted loop-closure map (no detector in the loop), the port's copy
    of ``xfeatslam_tpu.utils.synthetic.make_loop_map``: the camera walks a
    circle of ``period`` keyframes and returns; odometry drift accumulates;
    the last ``revisit_tail`` keyframes re-observe the first keyframes'
    regions through fresh duplicate landmarks (the drifted revisit loop
    closing exists for). The loop-closure workload of BASELINE config 5.

    ``bf=0`` leaves every observation monocular; ``bf>0`` fills stereo
    disparities ``ur = u - bf/z`` and per-slot depths from the true
    geometry (the RGB-D case, closed with ``fix_scale=True``).

    Returns (SlamMap, gt_poses, drifted_poses) with TUM1 intrinsics
    (fx 517.3, fy 516.5, cx 318.6, cy 255.3)."""
    import torch

    from ..ops import lie
    from ..slam.map import KeyFrame, SlamMap

    period = period or n_kf
    ang_pts = rng.uniform(0, 2 * np.pi, n_pts)
    r_pts = rng.uniform(2.0, 3.5, n_pts)
    X_gt = np.stack([
        r_pts * np.sin(ang_pts), rng.uniform(-1.0, 1.0, n_pts),
        r_pts * np.cos(ang_pts)
    ], -1).astype(np.float32)
    desc = rng.standard_normal((n_pts, desc_dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)

    gt = []
    for i in range(n_kf):
        ang = 2 * np.pi * i / period
        cy, sy = np.cos(ang), np.sin(ang)
        R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        C = 0.5 * np.array([np.sin(ang), 0.0, np.cos(ang) - 1.0], np.float32)
        R_cw = R_wc.T
        t_cw = -R_cw @ C
        gt.append((R_cw, t_cw))

    est = [gt[0]]
    if drift_xi is None:
        drift_xi = np.array([1.0, 0.3, -0.5, 0.15, 0.4, -0.2], np.float32)
    for i in range(1, n_kf):
        xi = drift_per_kf * np.asarray(drift_xi, np.float32)
        dR, dt = (x.numpy() for x in lie.se3_exp(torch.from_numpy(
            np.asarray(xi * i / n_kf, np.float32))))
        R_d = dR @ gt[i][0]
        t_d = dR @ gt[i][1] + dt * i
        est.append((R_d.astype(np.float32), t_d.astype(np.float32)))

    m = SlamMap(desc_dim=desc_dim)
    K_slots = 300
    mp_of_point = {}
    for i, (R, t) in enumerate(est):
        Xc_gt = X_gt @ gt[i][0].T + gt[i][1]
        z = Xc_gt[:, 2]
        u = 517.3 * Xc_gt[:, 0] / np.maximum(z, 1e-6) + 318.6
        v = 516.5 * Xc_gt[:, 1] / np.maximum(z, 1e-6) + 255.3
        if px_noise > 0:
            # measurement noise on the detections; everything downstream
            # (kpts, ur, the back-projected landmark) stays consistent
            u = u + rng.normal(0, px_noise, u.shape)
            v = v + rng.normal(0, px_noise, v.shape)
        vis = (z > 0.5) & (u >= 10) & (u < 630) & (v >= 10) & (v < 470)
        sel = np.nonzero(vis)[0][:K_slots]
        kpts = np.zeros((K_slots, 2), np.float32)
        dsc = np.zeros((K_slots, desc_dim), np.float32)
        valid = np.zeros(K_slots, bool)
        kpts[: len(sel)] = np.stack([u[sel], v[sel]], -1)
        dsc[: len(sel)] = desc[sel]
        if desc_noise > 0:
            # per-observation descriptor noise: two views of one point no
            # longer carry identical vectors
            dsc[: len(sel)] += desc_noise * rng.standard_normal(
                (len(sel), desc_dim)).astype(np.float32)
            dsc[: len(sel)] /= np.linalg.norm(dsc[: len(sel)], axis=-1,
                                              keepdims=True)
        valid[: len(sel)] = True
        ur_arr = np.full(K_slots, -1.0, np.float32)
        depth_arr = np.zeros(K_slots, np.float32)
        if bf > 0:
            z_sel = Xc_gt[sel, 2]
            ur_arr[: len(sel)] = u[sel] - bf / z_sel
            depth_arr[: len(sel)] = z_sel
        kf = KeyFrame(
            kid=i, frame_id=i, timestamp=float(i),
            kpts_un=kpts, desc=dsc, valid=valid,
            ur=ur_arr,
            depth=depth_arr,
            R=R.copy(), t=t.copy(),
        )
        m.keyframes[i] = kf
        m.covis.setdefault(i, {})
        if m.kf_origin is None:
            m.kf_origin = i
        revisit = i >= n_kf - revisit_tail
        for slot, p in enumerate(sel):
            p = int(p)
            ray = np.array([(kpts[slot, 0] - 318.6) / 517.3,
                            (kpts[slot, 1] - 255.3) / 516.5, 1.0],
                           np.float32)
            z_gt = float(Xc_gt[p, 2])
            Xw = (R.T @ (ray * z_gt - t)).astype(np.float32)
            if revisit:
                mp = m.create_point(Xw, dsc[slot], i)
            elif p not in mp_of_point:
                mp = m.create_point(Xw, dsc[slot], i)
                mp_of_point[p] = mp
            else:
                mp = mp_of_point[p]
            m.add_observation(mp, i, slot, update_links=False)
        m.update_connections(i)
        kf.parent = i - 1 if i > 0 else -1
        if i > 0:
            m.keyframes[i - 1].children.add(i)
    return m, gt, est

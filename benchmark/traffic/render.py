"""The benchmark's traffic: a pool of frames of one rendered sequence.

A plain-torch copy of the port's ``utils/synthetic.RoomScene`` (three
textured planes of a room corner and six textured boxes, ray-cast), so that
the frames are rendered on the card in a few large calls during set-up. The
textures are drawn with numpy from the seed exactly as the original draws
them, so the same seed and pose give the same image (to a gray level at the
rare pixel where float32 rounds another way).

The trajectory is closed: the camera orbits ``revolutions`` times over the
pool while it drifts forward and back and its heading precesses once, so
the pool's last frame leads into its first and no two revolutions repeat.
The seed draws the scene, the orbit's phase and its radius; every seed gives
the same sizes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# RoomScene's geometry (utils/synthetic.py): walls at z, floor at y, side
# wall at x, texture periods per metre
Z_WALL, Y_FLOOR, X_WALL, TEX_SCALE = 3.0, 1.1, 2.0, 0.7


def texture(rng, n=512, octaves=5, n_speckles=1500):
    """Multi-octave value noise with sharp speckles, (n, n) float32: a copy
    of ``utils/synthetic._texture``, draw for draw."""
    tex = np.zeros((n, n), np.float32)
    amp = 1.0
    for o in range(octaves):
        k = 4 * (2 ** o)
        coarse = rng.standard_normal((k, k)).astype(np.float32)
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
    ys = rng.integers(4, n - 6, n_speckles)
    xs = rng.integers(4, n - 6, n_speckles)
    for y, x in zip(ys, xs):
        sy = int(rng.integers(1, 5))
        sx = int(rng.integers(1, 5))
        amp = rng.uniform(0.35, 0.95) * rng.choice([-1.0, 1.0])
        patch = tex[y:y + sy, x:x + sx]
        jitter = rng.uniform(0.7, 1.0, patch.shape).astype(np.float32)
        tex[y:y + sy, x:x + sx] = np.clip(patch + amp * jitter, 0, 1)
    return tex


class Scene:
    """The room of ``RoomScene(seed=seed)`` with its textures on ``device``."""

    def __init__(self, seed: int, device):
        rng = np.random.default_rng(seed)
        self.device = device
        self.tex = [torch.from_numpy(texture(rng)).to(device)
                    for _ in range(3)]
        self.boxes = []
        for _ in range(6):
            cx = rng.uniform(-1.2, 1.2)
            cy = rng.uniform(0.6, 1.0)
            cz = rng.uniform(1.2, 2.4)
            s = rng.uniform(0.15, 0.35)
            lo = np.array([cx - s, cy - s, cz - s], np.float32)
            hi = np.array([cx + s, cy + s, cz + s], np.float32)
            tex = texture(rng, n=128, octaves=4, n_speckles=400)
            self.boxes.append((torch.from_numpy(lo).to(device),
                               torch.from_numpy(hi).to(device),
                               torch.from_numpy(tex).to(device)))

    def render(self, K, R_cw, t_cw, hw):
        """Gray uint8 (F, H, W) of F poses: R_cw (F, 3, 3), t_cw (F, 3)
        float32 tensors on the scene's device; K a 3x3 numpy array."""
        H, W = hw
        dev = self.device
        fx, fy, cx, cy = (float(np.float32(v)) for v in
                          (K[0, 0], K[1, 1], K[0, 2], K[1, 2]))
        v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                              torch.arange(W, dtype=torch.float32, device=dev),
                              indexing="ij")
        rays_c = torch.stack([(u - cx) / fx, (v - cy) / fy,
                              torch.ones_like(u)], -1)
        R_wc = R_cw.transpose(1, 2)
        C = -(R_wc @ t_cw[..., None])[..., 0]  # (F, 3)
        rays_w = torch.einsum("hwk,fjk->fhwj", rays_c, R_wc)
        C4 = C[:, None, None, :]
        F_ = R_cw.shape[0]
        best = torch.full((F_, H, W), 1e9, dtype=torch.float32, device=dev)
        gray = torch.zeros((F_, H, W), dtype=torch.float32, device=dev)
        planes = [(2, Z_WALL, (0, 1)), (1, Y_FLOOR, (0, 2)),
                  (0, X_WALL, (1, 2))]
        for tex, (axis, level, (ua, va)) in zip(self.tex, planes):
            d = rays_w[..., axis]
            lam = torch.where(d.abs() > 1e-6,
                              (level - C4[..., axis]) / d,
                              torch.full_like(d, -1.0))
            hit = (lam > 0.05) & (lam < best)
            p = C4 + lam[..., None] * rays_w
            n = tex.shape[0]
            ui = torch.remainder(p[..., ua] * TEX_SCALE * n * 0.12, n - 1)
            vi = torch.remainder(p[..., va] * TEX_SCALE * n * 0.12, n - 1)
            val = _bilinear(tex, ui, vi)
            gray = torch.where(hit, val, gray)
            best = torch.where(hit, lam, best)
        for lo, hi, tex in self.boxes:
            safe = torch.where(rays_w.abs() < 1e-9,
                               torch.full_like(rays_w, 1e-9), rays_w)
            t1 = (lo - C4) / safe
            t2 = (hi - C4) / safe
            tmin = torch.minimum(t1, t2)
            tmax = torch.maximum(t1, t2)
            tnear, face = tmin.max(-1)
            tfar = tmax.min(-1).values
            hit = (tnear < tfar) & (tnear > 0.05) & (tnear < best)
            p = C4 + tnear[..., None] * rays_w
            n = tex.shape[0]
            uu = torch.gather(p, -1, ((face + 1) % 3)[..., None])[..., 0]
            vv = torch.gather(p, -1, ((face + 2) % 3)[..., None])[..., 0]
            ui = torch.remainder(uu.abs() * n * 0.8, n - 1)
            vi = torch.remainder(vv.abs() * n * 0.8, n - 1)
            val = _bilinear(tex, ui, vi)
            gray = torch.where(hit, val, gray)
            best = torch.where(hit, tnear, best)
        return (gray.clamp(0, 1) * 235 + 10).to(torch.uint8)


def _bilinear(tex, ui, vi):
    """``tex`` sampled at (ui, vi) as RoomScene.render does: truncated
    corner, the next texel clamped to the last one."""
    n = tex.shape[0]
    u0, v0 = ui.long(), vi.long()
    wu, wv = ui - u0, vi - v0
    u1 = (u0 + 1).clamp(max=n - 1)
    v1 = (v0 + 1).clamp(max=n - 1)
    flat = tex.reshape(-1)

    def at(v, u):
        return flat[v * n + u]

    return (at(v0, u0) * (1 - wu) * (1 - wv) + at(v0, u1) * wu * (1 - wv)
            + at(v1, u0) * (1 - wu) * wv + at(v1, u1) * wu * wv)


def orbit_poses(n_frames: int, revolutions: int, radius: float,
                phase: float, forward: float, yaw_amp: float,
                pitch_amp: float):
    """World-to-camera poses (R_cw (n, 3, 3), t_cw (n, 3)) as float32 numpy,
    built as ``utils/synthetic.orbit_trajectory`` builds each pose, on a
    path that closes after ``n_frames``: ``revolutions`` turns of the
    orbit, a forward drift out and back, and one turn of the heading's
    precession."""
    R_all, t_all = [], []
    for i in range(n_frames):
        slow = 2 * np.pi * i / n_frames
        ang = 2 * np.pi * revolutions * i / n_frames + phase
        C = np.array([radius * np.sin(ang),
                      0.25 * radius * np.sin(2 * ang),
                      0.5 * forward * (1.0 - np.cos(slow))], np.float32)
        yaw = yaw_amp * np.sin(ang) + 0.5 * yaw_amp * np.sin(slow)
        pitch = pitch_amp * np.sin(2 * ang)
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32) \
            @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
        R_cw = R_wc.T
        R_all.append(R_cw.astype(np.float32))
        t_all.append((-R_cw @ C).astype(np.float32))
    return np.stack(R_all), np.stack(t_all)


def intrinsics(cfg) -> np.ndarray:
    """The 3x3 camera matrix of a configuration's ``camera``."""
    c = cfg["camera"]
    return np.array([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]], [0, 0, 1]],
                    np.float32)


def trajectory(traffic, n_frames: int, seed: int):
    """The pool's poses for ``seed``: the traffic's orbit with the phase and
    the radius drawn from the seed."""
    tr = traffic["trajectory"]
    rng = np.random.default_rng([seed, 1])
    revolutions = max(1, round(n_frames / tr["frames_per_revolution"]))
    return orbit_poses(n_frames, revolutions,
                       radius=float(rng.uniform(*tr["radius_m"])),
                       phase=float(rng.uniform(0.0, 2 * math.pi)),
                       forward=tr["forward_m"], yaw_amp=tr["yaw_rad"],
                       pitch_amp=tr["pitch_rad"])


def render_pool(cfg, traffic, seed: int, device, chunk: int = 16):
    """The pool of ``traffic["pool_batches"] * traffic["batch"]`` frames of
    the configuration's size and camera as uint8 (N, H, W, 1), rendered on
    ``device`` ``chunk`` frames at a time and returned on the host (pinned
    when ``device`` is a card)."""
    H, W = cfg["frame"]["height"], cfg["frame"]["width"]
    n = traffic["pool_batches"] * traffic["batch"]
    K = intrinsics(cfg)
    scene = Scene(seed, device)
    R, t = trajectory(traffic, n, seed)
    R = torch.from_numpy(R).to(device)
    t = torch.from_numpy(t).to(device)
    pinned = torch.device(device).type == "cuda"
    pool = torch.empty((n, H, W, 1), dtype=torch.uint8, pin_memory=pinned)
    for s in range(0, n, chunk):
        img = scene.render(K, R[s:s + chunk], t[s:s + chunk], (H, W))
        pool[s:s + chunk, ..., 0].copy_(img)
    return pool

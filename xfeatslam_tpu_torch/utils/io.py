"""Dataset readers, trajectory writing and reading, and the ATE metric.

Counterpart of ``xfeatslam_tpu/utils/io.py``: the TUM RGB-D sequence
(association file, or rgb.txt and depth.txt matched by time), the KITTI,
EuRoC and TUM-VI monocular layouts, the TUM, EuRoC and KITTI trajectory
savers (the roles of ORB-SLAM3's System::SaveTrajectoryTUM / EuRoC /
KITTI), the TUM reader and the absolute trajectory error. Images are read
by ``utils/png`` (numpy and ``zlib``), not ``cv2``.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from . import png


@dataclass
class RgbdSequence:
    root: str
    timestamps: List[float]
    rgb_paths: List[str]
    depth_paths: List[str]

    def __len__(self):
        return len(self.timestamps)

    def read(self, i):
        """Returns (gray uint8 (H,W), the depth image as stored (uint16
        (H,W), in units of 1/DepthMapFactor m), t), as ``cv2.imread`` with
        IMREAD_GRAYSCALE and IMREAD_UNCHANGED give them."""
        return (png.read_gray(self.rgb_paths[i]),
                png.read(self.depth_paths[i]), self.timestamps[i])


def _list_file(path: str):
    """(first field, second field) of each line that is not a comment."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(line.split())
    return out


def load_tum_association(root: str, assoc_file: str) -> RgbdSequence:
    """Association file lines: ``t_rgb rgb/... t_depth depth/...`` (the
    format rgbd_tum.cc's LoadImages reads)."""
    rows = _list_file(assoc_file)
    return RgbdSequence(root, [float(r[0]) for r in rows],
                        [os.path.join(root, r[1]) for r in rows],
                        [os.path.join(root, r[3]) for r in rows])


def associate_tum(root: str, max_dt: float = 0.02) -> RgbdSequence:
    """Associate rgb.txt and depth.txt by nearest timestamp (the policy of
    the TUM benchmark's association script): each rgb frame takes the
    nearest depth frame within ``max_dt`` that no earlier frame took."""
    rgb = [(float(r[0]), r[1]) for r in _list_file(
        os.path.join(root, "rgb.txt"))]
    depth = [(float(r[0]), r[1]) for r in _list_file(
        os.path.join(root, "depth.txt"))]
    d_ts = np.array([t for t, _ in depth])
    ts, rgbs, depths = [], [], []
    used = set()
    for t, p in rgb:
        j = int(np.argmin(np.abs(d_ts - t)))
        if abs(d_ts[j] - t) < max_dt and j not in used:
            used.add(j)
            ts.append(t)
            rgbs.append(os.path.join(root, p))
            depths.append(os.path.join(root, depth[j][1]))
    return RgbdSequence(root, ts, rgbs, depths)


def load_tum_mono(root: str):
    """A TUM sequence's rgb.txt: (timestamps, image paths), as
    mono_tum.cc's LoadImages reads it."""
    rows = _list_file(os.path.join(root, "rgb.txt"))
    return ([float(r[0]) for r in rows],
            [os.path.join(root, r[1]) for r in rows])


def load_kitti_mono(root: str):
    """KITTI odometry grayscale sequence dir: image_0/*.png + times.txt
    (mono_kitti.cc's LoadImages)."""
    with open(os.path.join(root, "times.txt")) as f:
        ts = [float(x) for x in f.read().split()]
    paths = sorted(glob.glob(os.path.join(root, "image_0", "*.png")))
    return ts[: len(paths)], paths


def load_euroc_mono(root: str, timestamp_file: Optional[str] = None):
    """EuRoC mav0/cam0/data + timestamp list (mono_euroc.cc's
    LoadImages); without a list, every image of the data directory."""
    data_dir = os.path.join(root, "mav0", "cam0", "data")
    if timestamp_file:
        with open(timestamp_file) as f:
            stamps = [line.strip() for line in f
                      if line.strip() and not line.startswith("#")]
    else:
        stamps = sorted(os.path.splitext(p)[0] for p in os.listdir(data_dir))
    ts = [float(s) / 1e9 for s in stamps]
    paths = [os.path.join(data_dir, s + ".png") for s in stamps]
    return ts, paths


def load_tum_vi_mono(root: str, timestamp_file: Optional[str] = None):
    """TUM-VI mav0/cam0/data layout (mono_tum_vi.cc's LoadImages)."""
    return load_euroc_mono(root, timestamp_file)


def rotation_to_quat_xyzw(R: np.ndarray) -> np.ndarray:
    """3x3 -> (qx,qy,qz,qw), TUM order."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qw = (R[2, 1] - R[1, 2]) / s
        qx = 0.25 * s
        qy = (R[0, 1] + R[1, 0]) / s
        qz = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qw = (R[0, 2] - R[2, 0]) / s
        qx = (R[0, 1] + R[1, 0]) / s
        qy = 0.25 * s
        qz = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qw = (R[1, 0] - R[0, 1]) / s
        qx = (R[0, 2] + R[2, 0]) / s
        qy = (R[1, 2] + R[2, 1]) / s
        qz = 0.25 * s
    return np.array([qx, qy, qz, qw])


def save_trajectory_tum(path: str, timestamps, poses_cw):
    """poses_cw: list of (R,t) world->camera; writes camera-to-world TUM
    lines ``t tx ty tz qx qy qz qw``."""
    with open(path, "w") as f:
        for t, (R, tr) in zip(timestamps, poses_cw):
            Rwc = np.asarray(R).T
            twc = -Rwc @ np.asarray(tr)
            q = rotation_to_quat_xyzw(Rwc)
            f.write(
                f"{t:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def save_trajectory_euroc(path: str, timestamps, poses_cw):
    """EuRoC format: ``t_ns, tx, ty, tz, qw, qx, qy, qz`` comma-separated."""
    with open(path, "w") as f:
        for t, (R, tr) in zip(timestamps, poses_cw):
            Rwc = np.asarray(R).T
            twc = -Rwc @ np.asarray(tr)
            q = rotation_to_quat_xyzw(Rwc)
            f.write(
                f"{int(t * 1e9)},{twc[0]:.7f},{twc[1]:.7f},{twc[2]:.7f},"
                f"{q[3]:.7f},{q[0]:.7f},{q[1]:.7f},{q[2]:.7f}\n"
            )


def save_trajectory_kitti(path: str, poses_cw):
    """KITTI format: 12 numbers per line, row-major [R_wc | t_wc]."""
    with open(path, "w") as f:
        for (R, tr) in poses_cw:
            Rwc = np.asarray(R).T
            twc = -Rwc @ np.asarray(tr)
            row = np.concatenate([Rwc, twc[:, None]], axis=1).reshape(-1)
            f.write(" ".join(f"{v:.6e}" for v in row) + "\n")


def load_trajectory_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (timestamps (N,), poses (N,7) [tx ty tz qx qy qz qw])."""
    ts, rows = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            ts.append(v[0])
            rows.append(v[1:8])
    return np.array(ts), np.array(rows)


def ate_rmse(gt_t: np.ndarray, gt_xyz: np.ndarray, est_t: np.ndarray,
             est_xyz: np.ndarray, max_dt: float = 0.02,
             align: bool = True, scale: bool = False) -> float:
    """Absolute trajectory error RMSE after timestamp association and
    (optionally) rigid alignment (Horn), the standard TUM evaluation;
    ``scale`` aligns by a similarity (Umeyama) instead, for monocular
    trajectories, whose scale is arbitrary."""
    pairs = []
    for i, t in enumerate(est_t):
        j = int(np.argmin(np.abs(gt_t - t)))
        if abs(gt_t[j] - t) < max_dt:
            pairs.append((j, i))
    if len(pairs) < 3:
        return float("nan")
    g = np.stack([gt_xyz[j] for j, _ in pairs])
    e = np.stack([est_xyz[i] for _, i in pairs])
    if align:
        mu_g, mu_e = g.mean(0), e.mean(0)
        gc, ec = g - mu_g, e - mu_e
        U, _, Vt = np.linalg.svd(ec.T @ gc)
        S = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            S[2, 2] = -1
        R = (U @ S @ Vt).T
        # the scale that best maps the rotated estimate onto the truth
        c = (np.sum(gc * (R @ ec.T).T) / max(np.sum(ec * ec), 1e-300)
             if scale else 1.0)
        e = c * (R @ ec.T).T + mu_g
        g = gc + mu_g
    return float(np.sqrt(np.mean(np.sum((g - e) ** 2, axis=1))))

"""Trajectory writing and reading, and the ATE metric.

The numpy part of ``xfeatslam_tpu/utils/io.py``: the TUM, EuRoC and KITTI
trajectory savers (the roles of ORB-SLAM3's System::SaveTrajectoryTUM /
EuRoC / KITTI), the TUM reader and the absolute trajectory error. The TUM
sequence readers need ``cv2``, which the port does not use; they wait for
a reader without it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
             align: bool = True) -> float:
    """Absolute trajectory error RMSE after timestamp association and
    (optionally) rigid alignment (Horn), the standard TUM evaluation."""
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
        e = (R @ ec.T).T + mu_g
        g = gc + mu_g
    return float(np.sqrt(np.mean(np.sum((g - e) ** 2, axis=1))))

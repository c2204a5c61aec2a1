"""Keypoint repeatability and localization on rendered scenes, with the
port's extractor.

Twin of ``tools/eval_repeatability.py``: render view pairs with known pose
and depth, extract keypoints in both with ``XFeatExtractor`` (on the GPU
its ``detect_candidates`` and ``keypoint_desc`` kernels; ``--device cpu``
runs their plain versions), project view A's keypoints into view B through
the depth map and report

  * repeatability@r: the fraction of A's covisible keypoints with a B
    detection within r px, r in {1, 2, 3};
  * loc-err: the mean distance to the nearest B detection over matches
    within 3 px.

    python -m xfeatslam_tpu_torch.tools.eval_repeatability [--weights W.npz]
"""

from __future__ import annotations

import argparse

import numpy as np


def eval_pairs(extractor, pairs, max_r=3.0):
    """pairs: list of (img_a, depth_a, img_b, (R_ab, t_ab), K), R_ab, t_ab
    camera-B <- camera-A. Returns the aggregated metrics."""
    rep = {1.0: [], 2.0: [], 3.0: []}
    loc = []
    for img_a, depth_a, img_b, (R_ab, t_ab), K in pairs:
        out = extractor(np.stack([img_a, img_b])[..., None])
        kps, valid = out["kpts"], out["valid"]
        ka, kb = kps[0][valid[0]], kps[1][valid[1]]
        if len(ka) == 0 or len(kb) == 0:
            continue
        # A's keypoints into B through the rendered depth
        ui, vi = ka[:, 0].astype(int), ka[:, 1].astype(int)
        H, W = depth_a.shape
        ui = np.clip(ui, 0, W - 1)
        vi = np.clip(vi, 0, H - 1)
        z = depth_a[vi, ui]
        ok = z > 0
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        Xa = np.stack([(ka[:, 0] - cx) / fx * z, (ka[:, 1] - cy) / fy * z,
                       z], -1)
        Xb = Xa @ R_ab.T + t_ab
        ok &= Xb[:, 2] > 0.05
        zb = np.maximum(Xb[:, 2], 1e-6)
        ub = fx * Xb[:, 0] / zb + cx
        vb = fy * Xb[:, 1] / zb + cy
        ok &= (ub >= 8) & (ub < W - 8) & (vb >= 8) & (vb < H - 8)
        proj = np.stack([ub, vb], -1)[ok]
        if len(proj) == 0:
            continue
        d = np.linalg.norm(proj[:, None, :] - kb[None, :, :], axis=-1).min(-1)
        for r in rep:
            rep[r].append(float((d <= r).mean()))
        loc.append(float(d[d <= max_r].mean()) if (d <= max_r).any()
                   else max_r)
    return {f"rep@{r:g}px": float(np.mean(v)) for r, v in rep.items()} | {
        "loc_err_px": float(np.mean(loc))
    }


def make_eval_pairs(n_pairs=8, hw=(240, 320), seed=7):
    """Rendered view pairs of the room scene: an orbit step plus a random
    rotation of view B."""
    from ..utils import synthetic

    K = np.array([[260.0, 0, hw[1] / 2], [0, 260.0, hw[0] / 2], [0, 0, 1]],
                 np.float32)
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n_pairs):
        scene = synthetic.RoomScene(seed=500 + i)
        poses = synthetic.orbit_trajectory(2, radius=0.25,
                                           forward_per_frame=0.03)
        (Ra, ta), (Rb, tb) = poses
        # an extra random rotation of view B (not just the orbit step)
        w = rng.normal(0, 0.02, 3)
        th = np.linalg.norm(w)
        Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                       [-w[1], w[0], 0]])
        dR = (np.eye(3) + np.sinc(th / np.pi) * Kx
              + 0.5 * np.sinc(th / (2 * np.pi)) ** 2 * (Kx @ Kx))
        Rb = (dR @ Rb).astype(np.float32)
        img_a, depth_a = scene.render(K, Ra, ta, hw)
        img_b, _ = scene.render(K, Rb, tb, hw)
        R_ab = Rb @ Ra.T
        t_ab = tb - R_ab @ ta
        pairs.append((img_a, depth_a, img_b,
                      (R_ab.astype(np.float32), t_ab.astype(np.float32)), K))
    return pairs


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m xfeatslam_tpu_torch.tools.eval_repeatability",
        description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default=None)
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--nfeatures", type=int, default=600)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from . import float32_math
    from ..models.extractor import XFeatExtractor

    float32_math()
    ext = XFeatExtractor(weights_path=args.weights,
                         nfeatures=args.nfeatures, device=args.device)
    metrics = eval_pairs(ext, make_eval_pairs(args.pairs))
    for k, v in metrics.items():
        print(f"{k}: {v:.4f}")


if __name__ == "__main__":
    main()

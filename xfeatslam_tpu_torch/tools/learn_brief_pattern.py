"""Learn a decorrelated BRIEF sampling pattern over rendered patches, with
the port's ORB.

Twin of ``tools/learn_brief_pattern.py``: the ORB paper's greedy selection
of point-pair tests (balanced, decorrelated), ordered by each test's flip
rate across rendered view pairs with known geometry, over oriented patches
sampled as the port's ``models/orb.describe`` samples its tests (the
rotated position, nearest pixel of ``blur7``'s image). It writes
``xfeatslam_tpu_torch/models/brief_pattern.npy``, which the port's ORB
loads when present, or ``--out``; then it prints the Hamming statistics of
true and wrong correspondences under the pattern the port loads.

    python -m xfeatslam_tpu_torch.tools.learn_brief_pattern [--images 24]
    python -m xfeatslam_tpu_torch.tools.learn_brief_pattern --eval-only
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# where models/orb.py looks for a learned pattern
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "models", "brief_pattern.npy")


def _brief_grid():
    """Integer grid inside the BRIEF sampling disc (radius 13, step 1)."""
    ys, xs = np.mgrid[-13:14, -13:14]
    keep = xs * xs + ys * ys <= 13 * 13
    return np.stack([xs[keep], ys[keep]], -1).astype(np.int8)  # (G,2)


def _extract_patches(img0, xx, yy, ang, grid, device="cpu"):
    """Canonical oriented patches at (xx, yy) with IC angles ``ang``,
    sampled as ``models/orb.describe`` samples its tests: the test position
    rotated by the angle, the nearest pixel of the 7x7-blurred image.
    Returns (n, G) float32."""
    import torch

    from ..models import orb

    h, w = img0.shape
    blurred = orb.blur7(torch.from_numpy(
        np.asarray(img0, np.float32)).to(device)).cpu().numpy()
    gx = grid[:, 0].astype(np.float32)
    gy = grid[:, 1].astype(np.float32)
    ca, sa = np.cos(ang)[:, None], np.sin(ang)[:, None]
    rx = ca * gx[None, :] - sa * gy[None, :]
    ry = sa * gx[None, :] + ca * gy[None, :]
    gxi = np.clip(xx[:, None] + np.round(rx).astype(int), 0, w - 1)
    gyi = np.clip(yy[:, None] + np.round(ry).astype(int), 0, h - 1)
    return blurred[gyi, gxi].astype(np.float32)


def collect_patch_pairs(n_scenes=12, hw=(480, 640), per_image=400, seed=3,
                        device=None):
    """Render view pairs with known geometry, detect FAST keypoints in view
    A, project them into view B through the rendered depth, and extract
    the oriented patch at both views (each with its own IC angle).
    Returns (PA, PB (N,G) float32, grid (G,2) int8)."""
    import torch

    from .. import resolve_device
    from ..models import orb
    from ..utils import synthetic

    dev = resolve_device(device)
    grid = _brief_grid()
    K = np.array([[520.0, 0, hw[1] / 2], [0, 520.0, hw[0] / 2], [0, 0, 1]],
                 np.float32)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    pa_all, pb_all = [], []
    rng = np.random.default_rng(seed)
    for i in range(n_scenes):
        scene = synthetic.RoomScene(seed=700 + i)
        (Ra, ta), (Rb, tb) = synthetic.orbit_trajectory(
            2, radius=0.28, forward_per_frame=0.015 + 0.01 * (i % 3))
        w_r = rng.normal(0, 0.03, 3)  # an extra rotation, roll too, of B
        th = np.linalg.norm(w_r)
        Kx = np.array([[0, -w_r[2], w_r[1]], [w_r[2], 0, -w_r[0]],
                       [-w_r[1], w_r[0], 0]])
        dR = (np.eye(3) + np.sinc(th / np.pi) * Kx
              + 0.5 * np.sinc(th / (2 * np.pi)) ** 2 * (Kx @ Kx))
        Rb = (dR @ Rb).astype(np.float32)
        img_a, dep_a = scene.render(K, Ra, ta, hw)
        img_b, dep_b = scene.render(K, Rb, tb, hw)
        a0 = img_a.astype(np.float32)
        b0 = img_b.astype(np.float32)
        a_t = torch.from_numpy(a0).to(dev)
        score_t = orb.fast_score_map(a_t, 20.0)
        score = score_t.cpu().numpy()
        mask = orb.nms3_mask(score_t).cpu().numpy()
        margin = 21  # 13 * sqrt(2) + rounding
        mask[:margin] = mask[-margin:] = False
        mask[:, :margin] = mask[:, -margin:] = False
        yy, xx = np.nonzero(mask)
        if len(yy) == 0:
            continue
        order = np.argsort(-score[yy, xx])[:per_image]
        yy, xx = yy[order], xx[order]
        # into B through the rendered depth
        z = dep_a[yy, xx]
        R_ab = Rb @ Ra.T
        t_ab = tb - R_ab @ ta
        Xa = np.stack([(xx - cx) / fx * z, (yy - cy) / fy * z, z], -1)
        Xb = Xa @ R_ab.T + t_ab
        zb = np.maximum(Xb[:, 2], 1e-6)
        ub = fx * Xb[:, 0] / zb + cx
        vb = fy * Xb[:, 1] / zb + cy
        ok = (z > 0) & (Xb[:, 2] > 0.05)
        ok &= (ub >= margin) & (ub < hw[1] - margin)
        ok &= (vb >= margin) & (vb < hw[0] - margin)
        # occlusion check against B's depth
        ubi = np.clip(ub, 0, hw[1] - 1).astype(int)
        vbi = np.clip(vb, 0, hw[0] - 1).astype(int)
        ok &= np.abs(dep_b[vbi, ubi] - Xb[:, 2]) < 0.05 * np.maximum(
            Xb[:, 2], 1.0)
        yy, xx = yy[ok], xx[ok]
        ubi, vbi = ubi[ok], vbi[ok]
        if len(yy) == 0:
            continue
        # each view's IC angles from its own moment maps
        m10a, m01a = (m.cpu().numpy() for m in orb.orientation_maps(a_t))
        m10b, m01b = (m.cpu().numpy() for m in orb.orientation_maps(
            torch.from_numpy(b0).to(dev)))
        ang_a = np.arctan2(m01a[yy, xx], m10a[yy, xx])
        ang_b = np.arctan2(m01b[vbi, ubi], m10b[vbi, ubi])
        pa_all.append(_extract_patches(a0, xx, yy, ang_a, grid, dev))
        pb_all.append(_extract_patches(b0, ubi, vbi, ang_b, grid, dev))
    PA = np.concatenate(pa_all, 0)
    PB = np.concatenate(pb_all, 0)
    print(f"patch pairs: {PA.shape[0]} x {PA.shape[1]} grid points",
          flush=True)
    return PA, PB, grid


def greedy_decorrelate(PA, PB, grid, n_bits=256, n_cand=60000, seed=5,
                       thr_schedule=(0.2, 0.25, 0.3, 0.35, 0.4, 0.5, 0.65)):
    """Greedy test selection: the ORB paper's balance and decorrelation,
    with candidates ordered by their cross-view flip rate (the fraction of
    corresponded patch pairs whose test bit differs between the views), the
    balance term as tie-breaker; a test is kept when its |correlation| with
    every kept test stays under the threshold, the threshold raised step
    by step until ``n_bits`` tests are kept. Returns (n_bits, 4) int8
    (x1, y1, x2, y2)."""
    N, G = PA.shape
    rng = np.random.default_rng(seed)
    ii, jj = np.triu_indices(G, k=1)
    if len(ii) > n_cand:
        sel = rng.choice(len(ii), n_cand, replace=False)
        ii, jj = ii[sel], jj[sel]
    bits = (PA[:, ii] < PA[:, jj]).astype(np.uint8)  # (N, C)
    bits_b = (PB[:, ii] < PB[:, jj]).astype(np.uint8)
    means = bits.mean(0)
    flip = (bits != bits_b).mean(0)
    del bits_b
    # drop hopelessly unbalanced tests outright
    ok = np.abs(means - 0.5) < 0.35
    bits, means, flip, ii, jj = (bits[:, ok], means[ok], flip[ok],
                                 ii[ok], jj[ok])
    # stability first, balance as a weak tie-breaker
    order = np.argsort(flip + 0.1 * np.abs(means - 0.5))
    bits, means, flip, ii, jj = (bits[:, order], means[order], flip[order],
                                 ii[order], jj[order])
    C = bits.shape[1]
    print(f"candidates: {C} (balanced band), flip rate "
          f"q10={np.quantile(flip, 0.1):.3f} med={np.median(flip):.3f}",
          flush=True)

    # centered unit columns on demand (||b - m||^2 = N m (1 - m))
    norms = np.sqrt(N * means * (1.0 - means)) + 1e-9

    def unit_col(c):
        return (bits[:, c].astype(np.float32) - means[c]) / norms[c]

    chosen = [0]
    S = unit_col(0)[:, None]  # (N, n_sel)
    for thr in thr_schedule:
        taken = set(chosen)
        for c in range(1, C):
            if len(chosen) >= n_bits:
                break
            if c in taken:
                continue
            v = unit_col(c)
            if np.abs(v @ S).max() < thr:
                chosen.append(c)
                taken.add(c)
                S = np.concatenate([S, v[:, None]], 1)
        print(f"thr {thr}: {len(chosen)} tests", flush=True)
        if len(chosen) >= n_bits:
            break
    if len(chosen) < n_bits:
        raise RuntimeError(f"only {len(chosen)} decorrelated tests")
    sel = np.asarray(chosen[:n_bits])
    pat = np.concatenate([grid[ii[sel]], grid[jj[sel]]], -1).astype(np.int8)
    corr = np.abs(np.triu((S[:, :n_bits].T @ S[:, :n_bits]), k=1))
    print(f"selected {n_bits}: mean|corr|={corr[corr > 0].mean():.3f} "
          f"max|corr|={corr.max():.3f} "
          f"mean-balance={np.abs(means[sel] - 0.5).mean():.3f} "
          f"mean-flip={flip[sel].mean():.3f} "
          f"(expected true-match hamming ~{flip[sel].sum():.0f})", flush=True)
    return pat


def evaluate_pattern(tag, n_pairs=6, device=None):
    """Hamming statistics of true and wrong correspondences on held-out
    rendered view pairs (depth-projected ground truth), under the pattern
    the port's ORB loaded when it was imported."""
    from ..models.orb import ORBExtractor
    from .eval_repeatability import make_eval_pairs

    ext = ORBExtractor(nfeatures=600, device=device)
    pairs = make_eval_pairs(n_pairs, hw=(480, 640), seed=31)
    true_d, wrong_d = [], []
    for img_a, depth_a, img_b, (R_ab, t_ab), Kc in pairs:
        oa = ext(img_a)
        ob = ext(img_b)
        ka, da, va = oa["kpts"][0], oa["desc"][0], oa["valid"][0]
        kb, db, vb = ob["kpts"][0], ob["desc"][0], ob["valid"][0]
        ka, da = ka[va], da[va]
        kb, db = kb[vb], db[vb]
        ui = np.clip(ka[:, 0].astype(int), 0, depth_a.shape[1] - 1)
        vi = np.clip(ka[:, 1].astype(int), 0, depth_a.shape[0] - 1)
        z = depth_a[vi, ui]
        ok = z > 0
        fx, fy, cx, cy = Kc[0, 0], Kc[1, 1], Kc[0, 2], Kc[1, 2]
        Xa = np.stack([(ka[:, 0] - cx) / fx * z, (ka[:, 1] - cy) / fy * z,
                       z], -1)
        Xb = Xa @ R_ab.T + t_ab
        ok &= Xb[:, 2] > 0.05
        zb = np.maximum(Xb[:, 2], 1e-6)
        proj = np.stack([fx * Xb[:, 0] / zb + cx, fy * Xb[:, 1] / zb + cy],
                        -1)
        d2 = np.linalg.norm(proj[:, None] - kb[None], axis=-1)
        near = d2.argmin(1)
        is_true = ok & (d2[np.arange(len(ka)), near] < 2.0)
        ham = (da != db[near]).sum(-1)
        true_d.append(ham[is_true])
        rng = np.random.default_rng(0)
        wrong = rng.integers(0, len(kb), len(ka))
        wrong = np.where(wrong == near, (wrong + 1) % len(kb), wrong)
        wrong_d.append((da != db[wrong]).sum(-1))
    t = np.concatenate(true_d).astype(np.float32)
    w = np.concatenate(wrong_d).astype(np.float32)
    print(f"[{tag}] true: n={len(t)} median={np.median(t):.0f} "
          f"P(<=50)={np.mean(t <= 50):.3f} P(<=100)={np.mean(t <= 100):.3f}")
    print(f"[{tag}] wrong: median={np.median(w):.0f} "
          f"P(<=50)={np.mean(w <= 50):.4f} P(<=100)={np.mean(w <= 100):.4f}",
          flush=True)
    return t, w


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m xfeatslam_tpu_torch.tools.learn_brief_pattern",
        description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=24)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from . import float32_math

    float32_math()
    if not args.eval_only:
        PA, PB, grid = collect_patch_pairs(n_scenes=args.images // 2,
                                           device=args.device)
        pat = greedy_decorrelate(PA, PB, grid)
        np.save(args.out, pat)
        print(f"saved {args.out}", flush=True)
    evaluate_pattern("current-pattern", device=args.device)


if __name__ == "__main__":
    main()

"""Multi-view geometry: triangulation and fundamental matrices.

Counterpart of ``xfeatslam_tpu/ops/geometry.py`` (the roles of ORB-SLAM3's
GeometricTools::ComputeF12 and Triangulate), and of its batched
triangulation search for local mapping. All functions broadcast over
leading dimensions. The 3x3 and 4x4 products are ``lie.mat_mul`` /
``lie.mat_vec`` (broadcast multiply-and-sum), never ``@``, so TF32 cannot
reach them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import matching as m
from .lie import mat_mul, mat_vec, so3_hat


def _tr(x):
    return x.transpose(-1, -2)


def triangulate_dlt(uv1, uv2, P1, P2):
    """Linear (DLT) triangulation of matched points.

    Args:
      uv1, uv2: (...,2) observations in image 1 / 2 (pixels for P = K[R|t]).
      P1, P2: (...,3,4) projection matrices.
    Returns X (...,3): the smallest eigenvector of A^T A (row-normalized
    A), sharpened by two inverse-iteration steps, dehomogenized."""
    rows = [
        uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = torch.stack(rows, -2)  # (...,4,4)
    # row-normalize for float32 conditioning (pixel-scale rows)
    A = A / (torch.linalg.vector_norm(A, dim=-1, keepdim=True) + 1e-12)
    AtA = mat_mul(_tr(A), A)
    w, v = torch.linalg.eigh(AtA)
    Xh = v[..., :, 0]
    lam = w[..., 0]
    eye = torch.eye(4, dtype=A.dtype, device=A.device)
    M = AtA - (lam[..., None, None] - 1e-6) * eye
    for _ in range(2):
        Xh = torch.linalg.solve_ex(M, Xh[..., :, None])[0][..., 0]
        Xh = Xh / (torch.linalg.vector_norm(Xh, dim=-1, keepdim=True) + 1e-12)
    w_last = Xh[..., 3]
    safe = torch.where(w_last.abs() < 1e-12, 1e-12, w_last)
    return Xh[..., :3] / safe[..., None]


def projection_matrix(K, R, t):
    """K (...,3,3), R (...,3,3), t (...,3) -> P = K [R|t] (...,3,4)."""
    return mat_mul(K, torch.cat([R, t[..., :, None]], -1))


def fundamental_from_poses(K1, R1w, t1w, K2, R2w, t2w):
    """F12 such that x1^T F12 x2 = 0 for corresponding pixels
    (GeometricTools::ComputeF12)."""
    R12 = mat_mul(R1w, _tr(R2w))
    t12 = t1w - mat_vec(R12, t2w)
    K1_inv_T = _tr(torch.linalg.inv_ex(K1)[0])
    K2_inv = torch.linalg.inv_ex(K2)[0]
    return mat_mul(mat_mul(mat_mul(K1_inv_T, so3_hat(t12)), R12), K2_inv)


def epipolar_dist_sq(uv1, uv2, F12):
    """Squared distance of x2 to the epipolar line F12^T x1 (pixels), as
    Pinhole::epipolarConstrain checks it."""
    x1 = torch.cat([uv1, torch.ones_like(uv1[..., :1])], -1)
    x2 = torch.cat([uv2, torch.ones_like(uv2[..., :1])], -1)
    line = (F12 * x1[..., :, None]).sum(-2)  # F^T x1: a line in image 2
    num = (line * x2).sum(-1)
    den = line[..., 0] ** 2 + line[..., 1] ** 2
    return num * num / torch.where(den < 1e-12, 1e-12, den)


def parallax_cos(X, c1, c2):
    """Cosine of the parallax angle at X between camera centres c1, c2."""
    d1 = X - c1
    d2 = X - c2
    n1 = torch.linalg.vector_norm(d1, dim=-1)
    n2 = torch.linalg.vector_norm(d2, dim=-1)
    return (d1 * d2).sum(-1) / torch.where(n1 * n2 < 1e-12, 1e-12, n1 * n2)


def triangulation_search_batched(
        K, R1, t1, uv1, desc1, free1, depth1,
        R2s, t2s, uv2s, desc2s, free2s, depth2s, nb_valid,
        fx, fy, cx, cy, bf, max_dist, ratio: float = 0.8,
        binary: bool = False):
    """Epipolar-gated matching, DLT triangulation, the RGB-D depth fallback
    and the acceptance gates of a new keyframe against a stack of
    covisible neighbours (LocalMapping::CreateNewMapPoints with
    ORBmatcher::SearchForTriangulation).

    Args:
      K, R1, t1, uv1 (N1,2), desc1, free1, depth1: the new keyframe.
      R2s..depth2s: (Nn, ...) stacked neighbour keyframes (padded).
      nb_valid: (Nn,) bool, False rows are padding.
      fx, fy, cx, cy, bf, max_dist: numbers.
    Returns per neighbour idx (Nn,N1) matched slot in the neighbour or -1,
    ok (Nn,N1) acceptance mask, X (Nn,N1,3) world points."""
    C1 = -mat_vec(_tr(R1), t1)
    P1 = projection_matrix(K, R1, t1)
    ray1 = torch.stack([(uv1[:, 0] - cx) / fx, (uv1[:, 1] - cy) / fy,
                        torch.ones_like(uv1[:, 0])], -1)
    # bf / fx / 2 in float32, as the JAX graph computes it
    half = float(np.float32(np.float32(bf) / np.float32(fx)) / np.float32(2))

    def depth_cos(d):
        # the parallax a depth measurement would give; 2 where no depth
        return torch.where(d > 0, torch.cos(
            2.0 * torch.atan2(torch.full_like(d, half), d.clamp(min=1e-3))),
            2.0)

    def one(R2, t2, uv2, desc2, free2, depth2, nv):
        F12 = fundamental_from_poses(K, R1, t1, K, R2, t2)
        epi_d2 = epipolar_dist_sq(uv1[:, None, :], uv2[None, :, :], F12)
        pair_ok = epi_d2 < 3.84  # chi2(1) at 95%
        res = m.match_general(desc1, free1, desc2, free2 & nv,
                              max_dist=max_dist, ratio=ratio,
                              pair_mask=pair_ok, binary=binary)
        idx = res.idx.long().clamp(min=0)
        uv2m = uv2[idx]
        P2 = projection_matrix(K, R2, t2)
        X = triangulate_dlt(uv1, uv2m, P1, P2)
        C2 = -mat_vec(_tr(R2), t2)
        cosp = parallax_cos(X, C1, C2)
        # RGB-D rule (LocalMapping.cc): triangulate only when the ray
        # parallax beats what a depth measurement would give; otherwise
        # unproject from depth, or skip at near-zero parallax
        d1 = depth1
        d2 = depth2[idx]
        cs1, cs2 = depth_cos(d1), depth_cos(d2)
        good_tri = (cosp > 0) & (cosp < 0.9998) & (cosp < torch.minimum(cs1,
                                                                         cs2))
        # row vector times R: R^T (ray d - t)
        Xd1 = mat_vec(_tr(R1), ray1 * d1[:, None] - t1)
        ray2 = torch.stack([(uv2m[:, 0] - cx) / fx, (uv2m[:, 1] - cy) / fy,
                            torch.ones_like(uv2m[:, 0])], -1)
        Xd2 = mat_vec(_tr(R2), ray2 * d2[:, None] - t2)
        use_d1 = ~good_tri & (d1 > 0) & (cs1 <= cs2)
        use_d2 = ~good_tri & ~use_d1 & (d2 > 0)
        X = torch.where(use_d1[:, None], Xd1,
                        torch.where(use_d2[:, None], Xd2, X))
        Xc1 = mat_vec(R1, X) + t1
        Xc2 = mat_vec(R2, X) + t2
        ok = res.mask & (Xc1[:, 2] > 0.05) & (Xc2[:, 2] > 0.05)
        ok = ok & (good_tri | use_d1 | use_d2)
        for Xc, uv in ((Xc1, uv1), (Xc2, uv2m)):
            z = Xc[:, 2].clamp(min=1e-6)
            u = fx * Xc[:, 0] / z + cx
            v = fy * Xc[:, 1] / z + cy
            err2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
            ok = ok & (err2 < 5.991)
        return res.idx, ok & nv, X

    outs = [one(*args) for args in zip(R2s, t2s, uv2s, desc2s, free2s,
                                       depth2s, nb_valid)]
    return tuple(torch.stack(f) for f in zip(*outs))

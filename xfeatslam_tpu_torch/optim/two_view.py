"""Two-view reconstruction: the batched H/F RANSAC monocular initializer.

Counterpart of ``xfeatslam_tpu/optim/two_view.py`` (the role of ORB-SLAM3's
TwoViewReconstruction): 200 minimal sets give 200 homographies (4-point
DLT) and 200 fundamentals (8-point), all scored at once; the best of each
is refit on its inliers by a weighted DLT and rescored; H wins when
SH / (SH + SF) > 0.5; the 8 Faugeras motions of H or the 4 of E = K^T F K
are triangulated together and the one with the most points passing
chirality, parallax and reprojection wins if it is clearly ahead.

The (200, 8) minimal-set indices are an input: the JAX package draws them
with ``jax.random.categorical``, which torch cannot reproduce, so callers
draw them with ``draw_minimal_sets`` (``torch.multinomial`` with
replacement, weights ``valid + 1e-6``), and the parity tests feed JAX's
draws. The batched SVDs are ``torch.linalg.svd``; the small products are
broadcast multiply-and-sum (``lie.mat_mul`` / ``mat_vec``), never ``@``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import geometry
from ..ops.lie import mat_mul, mat_vec

SIGMA = 1.0
CHI2_H = 5.991
CHI2_F = 3.841
N_ITERS = 200


class TwoViewResult(NamedTuple):
    success: torch.Tensor  # () bool
    R: torch.Tensor  # (3,3) cam1 -> cam2
    t: torch.Tensor  # (3,) unit norm
    points: torch.Tensor  # (N,3) triangulated in the cam1 frame
    good: torch.Tensor  # (N,) bool triangulated inlier
    used_h: torch.Tensor  # () bool, which model won


def _tr(x):
    return x.transpose(-1, -2)


def _det3(M):
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def _mat3(rows, like):
    """A (3,3) tensor of scalars (numbers or 0-dim tensors)."""
    return torch.stack([torch.stack([torch.as_tensor(v, dtype=like.dtype,
                                                     device=like.device)
                                     for v in r]) for r in rows])


def _normalize_points(x, valid):
    """Hartley normalization (TwoViewReconstruction::Normalize)."""
    w = valid.to(x.dtype)
    n = w.sum().clamp(min=1.0)
    mean = (x * w[:, None]).sum(0) / n
    d = (x - mean).abs() * w[:, None]
    md = (d.sum(0) / n).clamp(min=1e-6)
    s = 1.0 / md
    xn = (x - mean) * s
    T = _mat3([[s[0], 0.0, -mean[0] * s[0]], [0.0, s[1], -mean[1] * s[1]],
               [0.0, 0.0, 1.0]], x)
    return xn, T


def _h_rows(p1, p2):
    """The two DLT rows of each correspondence, (..., n, 9) each."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    return r1, r2


def _f_rows(p1, p2):
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        o], -1)


def _null_vector(A):
    """The right singular vector of the smallest singular value, (...,9)
    -> reshaped (...,3,3)."""
    full = A.shape[-2] < A.shape[-1]
    vt = torch.linalg.svd(A, full_matrices=full)[2]
    return vt[..., -1, :].reshape(A.shape[:-2] + (3, 3))


def _rank2(F):
    u, s, vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], -1)
    return mat_mul(u, s[..., :, None] * vt)


def _dlt_h(p1, p2):
    """4-point homography DLT. p1, p2: (B,4,2) -> (B,3,3)."""
    r1, r2 = _h_rows(p1, p2)
    return _null_vector(torch.cat([r1, r2], -2))


def _eight_point_f(p1, p2):
    """8-point fundamental. p1, p2: (B,8,2) -> (B,3,3), rank 2."""
    return _rank2(_null_vector(_f_rows(p1, p2)))


def _homogeneous(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], -1)


def _score_h(H, p1, p2, valid):
    """Symmetric transfer error score (CheckHomography). H: (B,3,3)."""
    x1, x2 = _homogeneous(p1), _homogeneous(p2)
    Hx1 = mat_vec(H[:, None], x1[None])  # (B,N,3)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    Hinv = torch.linalg.inv_ex(H + 1e-12 * eye)[0]
    Hx2 = mat_vec(Hinv[:, None], x2[None])

    def err(Hx, p):
        z = Hx[..., 2:]
        z = torch.where(z.abs() < 1e-9, 1e-9, z)
        return ((Hx[..., :2] / z - p) ** 2).sum(-1) / SIGMA ** 2

    e12, e21 = err(Hx1, p2), err(Hx2, p1)
    in12 = (e12 < CHI2_H) & valid
    in21 = (e21 < CHI2_H) & valid
    score = (torch.where(in12, CHI2_H - e12, 0.0)
             + torch.where(in21, CHI2_H - e21, 0.0))
    return score.sum(-1), in12 & in21


def _score_f(F, p1, p2, valid):
    """Epipolar distance score (CheckFundamental). F: (B,3,3)."""
    x1, x2 = _homogeneous(p1), _homogeneous(p2)
    l2 = mat_vec(F[:, None], x1[None])  # lines in image 2
    l1 = mat_vec(_tr(F)[:, None], x2[None])  # lines in image 1
    d2 = ((x2[None] * l2).sum(-1) ** 2
          / (l2[..., 0] ** 2 + l2[..., 1] ** 2).clamp(min=1e-12)
          / SIGMA ** 2)
    d1 = ((x1[None] * l1).sum(-1) ** 2
          / (l1[..., 0] ** 2 + l1[..., 1] ** 2).clamp(min=1e-12)
          / SIGMA ** 2)
    in2 = (d2 < CHI2_F) & valid
    in1 = (d1 < CHI2_F) & valid
    # the reference scores F with thScore = 5.991 too (CheckFundamental)
    score = (torch.where(in2, CHI2_H - d2, 0.0)
             + torch.where(in1, CHI2_H - d1, 0.0))
    return score.sum(-1), in1 & in2


def _check_rt(R, t, p1n, p2n, inlier):
    """Triangulate with each (R|t) (R (B,3,3), t (B,3)) and count the
    points passing chirality, parallax and reprojection (CheckRT), in
    normalized camera coordinates. Returns (count (B,), X (B,N,3),
    good (B,N))."""
    B = R.shape[0]
    eye34 = torch.cat([torch.eye(3, dtype=R.dtype, device=R.device),
                       torch.zeros((3, 1), dtype=R.dtype, device=R.device)],
                      -1)
    P1 = eye34.expand(B, 3, 4)
    P2 = torch.cat([R, t[..., None]], -1)
    X = geometry.triangulate_dlt(p1n[None], p2n[None], P1[:, None],
                                 P2[:, None])  # (B,N,3)
    z1 = X[..., 2]
    Xc2 = mat_vec(R[:, None], X) + t[:, None]
    z2 = Xc2[..., 2]
    C2 = -mat_vec(_tr(R), t)
    cosp = geometry.parallax_cos(X, torch.zeros_like(C2)[:, None],
                                 C2[:, None])
    ok = (z1 > 0) & (z2 > 0) & (cosp < 0.99998) & inlier
    # reprojection in normalized coordinates (~4 sigma / f)
    e1 = ((X[..., :2] / z1[..., None].clamp(min=1e-9) - p1n) ** 2).sum(-1)
    e2 = ((Xc2[..., :2] / z2[..., None].clamp(min=1e-9) - p2n) ** 2).sum(-1)
    thr = (4.0 / 500.0) ** 2
    ok = ok & (e1 < thr) & (e2 < thr)
    return ok.sum(-1), X, ok


def _motions_from_f(F, K):
    """E = K^T F K -> 4 motion hypotheses (DecomposeE)."""
    E = mat_mul(mat_mul(_tr(K), F), K)
    u, _, vt = torch.linalg.svd(E)
    W = _mat3([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], F)
    R1 = mat_mul(mat_mul(u, W), vt)
    R2 = mat_mul(mat_mul(u, _tr(W)), vt)
    R1 = R1 * torch.sign(_det3(R1))
    R2 = R2 * torch.sign(_det3(R2))
    t = u[:, 2]
    t = t / torch.linalg.vector_norm(t).clamp(min=1e-9)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _motions_from_h(H, K):
    """The 8 Faugeras motion hypotheses of a homography (ReconstructH), by
    the SVD of Hn = K^-1 H K."""
    Kinv = torch.linalg.inv_ex(K)[0]
    A = mat_mul(mat_mul(Kinv, H), K)
    u, s, vt = torch.linalg.svd(A)
    d1, d2, d3 = s[0], s[1], s[2]
    s_det = _det3(u) * _det3(vt)
    eps = 1e-9
    den = (d1 * d1 - d3 * d3).clamp(min=eps)
    aux1 = torch.sqrt(((d1 * d1 - d2 * d2) / den).clamp(min=0.0))
    aux3 = torch.sqrt(((d2 * d2 - d3 * d3) / den).clamp(min=0.0))
    x1s = (aux1, aux1, -aux1, -aux1)
    x3s = (aux3, -aux3, aux3, -aux3)
    root = torch.sqrt(((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)).clamp(
        min=0.0))
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)
    Rs, ts = [], []

    def add(Rp, tp):
        Rs.append(s_det * mat_mul(mat_mul(u, Rp), vt))
        t = mat_vec(u, tp)
        ts.append(t / torch.linalg.vector_norm(t).clamp(min=eps))

    # d' = d2
    sin_t = root / ((d1 + d3) * d2).clamp(min=eps)
    cos_t = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2).clamp(min=eps)
    for i in range(4):
        st = sin_t * torch.sign(x1s[i] * x3s[i] + eps)
        add(_mat3([[cos_t, zero, -st], [zero, one, zero], [st, zero, cos_t]],
                  H), (d1 - d3) * torch.stack([x1s[i], zero, -x3s[i]]))
    # d' = -d2
    sin_p = root / ((d1 - d3) * d2).clamp(min=eps)
    cos_p = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2).clamp(min=eps)
    for i in range(4):
        sp = sin_p * torch.sign(x1s[i] * x3s[i] + eps)
        add(_mat3([[cos_p, zero, sp], [zero, -one, zero], [sp, zero, -cos_p]],
                  H), (d1 + d3) * torch.stack([x1s[i], zero, x3s[i]]))
    return torch.stack(Rs), torch.stack(ts)


def draw_minimal_sets(valid, generator: Optional[torch.Generator] = None):
    """(N_ITERS, 8) correspondence indices drawn with replacement, each with
    weight ``valid + 1e-6`` (invalid draws are tolerated: every model is
    scored against the valid mask)."""
    w = valid.to(torch.float32) + 1e-6
    return torch.multinomial(w, N_ITERS * 8, replacement=True,
                             generator=generator).reshape(N_ITERS, 8)


@torch.no_grad()
def reconstruct_two_views(uv1, uv2, valid, K, idx=None,
                          generator: Optional[torch.Generator] = None
                          ) -> TwoViewResult:
    """The monocular initializer on matched keypoints.

    Args:
      uv1, uv2: (N,2) matched undistorted pixels (frame 1 -> frame 2).
      valid: (N,) bool.
      K: (3,3) intrinsics.
      idx: (N_ITERS, 8) minimal sets; drawn from ``generator`` if absent.
    Returns a TwoViewResult (X2 = R X1 + t). Success follows
    ReconstructF/H: more than 50 good points, the second-best hypothesis
    below 0.75 of the best, and the best above 0.75 of the inliers."""
    if idx is None:
        idx = draw_minimal_sets(valid, generator).to(uv1.device)
    idx = idx.long()
    p1n_h, T1 = _normalize_points(uv1, valid)
    p2n_h, T2 = _normalize_points(uv2, valid)
    s1, s2 = p1n_h[idx], p2n_h[idx]  # (ITERS,8,2)

    H_n = _dlt_h(s1[:, :4], s2[:, :4])
    F_n = _eight_point_f(s1, s2)
    # denormalize: H = T2^-1 Hn T1, F = T2^T Fn T1
    T2inv = torch.linalg.inv_ex(T2)[0]
    H_all = mat_mul(mat_mul(T2inv, H_n), T1)
    F_all = mat_mul(mat_mul(_tr(T2), F_n), T1)

    sh, in_h = _score_h(H_all, uv1, uv2, valid)
    sf, in_f = _score_f(F_all, uv1, uv2, valid)
    bh, bf = torch.argmax(sh), torch.argmax(sf)
    SH, SF = sh[bh], sf[bf]

    # refit each winner on all its inliers (weighted DLT rows): a minimal
    # set's model carries ~1 degree of pose noise that the refit removes
    w_f = in_f[bf].to(uv1.dtype)[:, None]
    F_best = mat_mul(mat_mul(_tr(T2), _rank2(_null_vector(
        _f_rows(p1n_h, p2n_h) * w_f))), T1)
    w_h = in_h[bh].to(uv1.dtype)[:, None]
    r1, r2 = _h_rows(p1n_h, p2n_h)
    H_best = mat_mul(mat_mul(T2inv, _null_vector(
        torch.cat([r1 * w_h, r2 * w_h], 0))), T1)
    # rescore after the refit (the inlier sets may grow)
    inliers_h = _score_h(H_best[None], uv1, uv2, valid)[1][0]
    inliers_f = _score_f(F_best[None], uv1, uv2, valid)[1][0]

    use_h = SH / (SH + SF).clamp(min=1e-9) > 0.5

    # normalized camera coordinates for the triangulation
    Kinv = torch.linalg.inv_ex(K)[0]
    p1n = mat_vec(Kinv, _homogeneous(uv1))[..., :2]
    p2n = mat_vec(Kinv, _homogeneous(uv2))[..., :2]

    Rs_f, ts_f = _motions_from_f(F_best, K)
    Rs_h, ts_h = _motions_from_h(H_best, K)
    Rs = torch.cat([Rs_h, Rs_f])  # (12,3,3): 8 H + 4 F
    ts = torch.cat([ts_h, ts_f])
    hyp_valid = torch.cat([use_h.expand(8), (~use_h).expand(4)])
    inlier_mask = torch.where(use_h, inliers_h, inliers_f)

    counts, Xs, goods = _check_rt(Rs, ts, p1n, p2n, inlier_mask)
    counts = torch.where(hyp_valid, counts, -1)
    best = torch.argmax(counts)
    n_best = counts[best]
    n_total = inlier_mask.sum().clamp(min=1)
    # the second best must be clearly worse (ReconstructF)
    second = torch.sort(counts).values[-2]
    success = ((n_best > 50) & (second < 0.75 * n_best)
               & (n_best > 0.75 * n_total))
    return TwoViewResult(success=success, R=Rs[best], t=ts[best],
                         points=Xs[best], good=goods[best], used_h=use_h)

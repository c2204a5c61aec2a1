"""Sim3 estimation: batched Horn alignment inside RANSAC, and a robust Sim3
refinement for loop verification.

Counterpart of ``xfeatslam_tpu/optim/sim3.py`` (the roles of ORB-SLAM3's
Sim3Solver, RANSAC Horn on matched map-point pairs, and
Optimizer::OptimizeSim3, paired forward and inverse reprojection edges).
Every RANSAC hypothesis is solved and scored in one batched pass; the
refinement is a small LM on the 7-dof tangent with forward-mode Jacobians
(``torch.func.jacfwd``, the JAX package's ``jax.jacfwd``).

The minimal sets of the RANSAC are an input (``idx``): the JAX package
draws them from a JAX PRNG key, which torch cannot reproduce, so parity
tests feed its draws. Without ``idx`` they are drawn with
``torch.multinomial`` (with replacement, weights ``valid + 1e-6``, as the
JAX draw's categorical logits) from ``generator``. The small products are
broadcast multiply-and-sum, never ``@``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import lie
from ..ops.camera import Pinhole
from ..ops.lie import mat_mul, mat_vec

CHI2 = 9.210  # 2-dof 99%, the reference's Sim3 inlier check


class Sim3Result(NamedTuple):
    success: torch.Tensor
    s: torch.Tensor
    R: torch.Tensor  # (3,3): maps frame-2 coords into frame-1 coords
    t: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor


def _cross_cov(Y1, Y2):
    """sum_m Y1[m,i] Y2[m,j] over the point axis: (...,M,3) -> (...,3,3)."""
    return (Y1[..., :, :, None] * Y2[..., :, None, :]).sum(-3)


def _rotation_of(C):
    """The rotation of Horn's method from the cross-covariance C (...,3,3):
    U diag(1, 1, sign det(U V^T)) V^T."""
    u, _, vt = torch.linalg.svd(C)
    det = torch.linalg.det(mat_mul(u, vt))
    D = torch.ones(u.shape[:-1], dtype=u.dtype, device=u.device)
    D = torch.cat([D[..., :-1], torch.sign(det)[..., None]], -1)
    return mat_mul(u, D[..., :, None] * vt)


def horn_sim3(X1, X2, fix_scale: bool = False):
    """Closed-form Sim3 (s, R, t) with X1 ~ s R X2 + t.

    X1, X2: (...,M,3) matched point sets (M >= 3). Horn's method by the SVD
    of the cross-covariance (the quaternion method of
    Sim3Solver::ComputeSim3 gives the same rotation)."""
    mu1 = X1.mean(-2, keepdim=True)
    mu2 = X2.mean(-2, keepdim=True)
    Y1 = X1 - mu1
    Y2 = X2 - mu2
    R = _rotation_of(_cross_cov(Y1, Y2))
    if fix_scale:
        s = torch.ones(X1.shape[:-2], dtype=X1.dtype, device=X1.device)
    else:
        # s = sum(Y1 . R Y2) / sum(|Y2|^2)
        RY2 = mat_vec(R[..., None, :, :], Y2)
        num = (Y1 * RY2).sum((-2, -1))
        den = (Y2 * Y2).sum((-2, -1)).clamp(min=1e-12)
        s = num / den
    t = mu1[..., 0, :] - s[..., None] * mat_vec(R, mu2[..., 0, :])
    return s, R, t


def _project(cam: Pinhole, Xc):
    z = torch.where(Xc[..., 2].abs() < 1e-6, 1e-6, Xc[..., 2])
    return torch.stack([cam.fx * Xc[..., 0] / z + cam.cx,
                        cam.fy * Xc[..., 1] / z + cam.cy], -1), Xc[..., 2]


def draw_minimal_sets(valid, iters: int, generator=None):
    """(iters, 3) pair indices drawn with replacement, each with weight
    ``valid + 1e-6``."""
    w = valid.to(torch.float32) + 1e-6
    return torch.multinomial(w, iters * 3, replacement=True,
                             generator=generator).reshape(iters, 3)


@torch.no_grad()
def sim3_ransac(Xc1, Xc2, uv1, uv2, valid, cam: Pinhole,
                idx: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                iters: int = 128, min_inliers: int = 15,
                fix_scale: bool = False) -> Sim3Result:
    """RANSAC Horn Sim3 between matched map points seen by two keyframes.

    Args:
      Xc1, Xc2: (N,3) matched points in the camera frames of KF1 / KF2.
      uv1, uv2: (N,2) their observed pixels in KF1 / KF2, for the dual
        reprojection check.
      valid: (N,) bool.
      idx: (iters,3) minimal sets, drawn from ``generator`` when absent.
    Returns the Sim3 S12 with Xc1 ~ s R Xc2 + t, refit on the inliers of
    the hypothesis with the most (the first on a tie)."""
    if idx is None:
        idx = draw_minimal_sets(valid, iters, generator)
    idx = idx.long()
    s_all, R_all, t_all = horn_sim3(Xc1[idx], Xc2[idx], fix_scale=fix_scale)

    # dual reprojection scoring
    X2in1 = (s_all[:, None, None] * mat_vec(R_all[:, None], Xc2[None])
             + t_all[:, None, :])
    uv1_pred, z1 = _project(cam, X2in1)
    s_inv = 1.0 / s_all.clamp(min=1e-9)
    Rt = R_all.transpose(-1, -2)
    X1in2 = s_inv[:, None, None] * mat_vec(Rt[:, None],
                                           Xc1[None] - t_all[:, None, :])
    uv2_pred, z2 = _project(cam, X1in2)
    e1 = ((uv1_pred - uv1[None]) ** 2).sum(-1)
    e2 = ((uv2_pred - uv2[None]) ** 2).sum(-1)
    inl = (e1 < CHI2) & (e2 < CHI2) & (z1 > 0) & (z2 > 0) & valid[None]
    counts = inl.sum(-1)
    best = torch.argmax(counts)
    n = counts[best]
    # refit on the inliers of the best hypothesis (Horn with weights)
    m = inl[best].to(Xc1.dtype)
    nw = m.sum().clamp(min=3.0)
    mu1 = (Xc1 * m[:, None]).sum(0) / nw
    mu2 = (Xc2 * m[:, None]).sum(0) / nw
    Y1 = (Xc1 - mu1) * m[:, None]
    Y2 = (Xc2 - mu2) * m[:, None]
    R = _rotation_of(_cross_cov(Y1, Y2))
    if fix_scale:
        s = torch.ones((), dtype=Xc1.dtype, device=Xc1.device)
    else:
        num = (Y1 * mat_vec(R, Y2)).sum()
        den = (Y2 * Y2).sum().clamp(min=1e-12)
        s = num / den
    t = mu1 - s * mat_vec(R, mu2)
    return Sim3Result(n >= min_inliers, s, R, t, inl[best], n)


def _sim3_reproj_residuals(s, R, t, Xc1, Xc2, uv1, uv2, cam: Pinhole):
    X2in1 = s * mat_vec(R, Xc2) + t
    uv1_pred, _ = _project(cam, X2in1)
    X1in2 = (1.0 / s) * mat_vec(R.transpose(-1, -2), Xc1 - t)
    uv2_pred, _ = _project(cam, X1in2)
    return uv1 - uv1_pred, uv2 - uv2_pred


@torch.no_grad()
def optimize_sim3(s0, R0, t0, Xc1, Xc2, uv1, uv2, valid, cam: Pinhole,
                  iters: int = 20, fix_scale: bool = False):
    """Robust LM refinement of a Sim3 (the OptimizeSim3 role: paired forward
    and inverse reprojection edges under Huber). Jacobians by forward-mode
    differentiation on the 7-dof tangent [rho, phi, sigma]; ``fix_scale``
    freezes sigma (the reference's _fix_scale for RGB-D and stereo).
    Returns (s, R, t, inliers (N,) bool, their count)."""
    dtype, dev = Xc1.dtype, Xc1.device
    delta2 = CHI2
    dof_mask = torch.ones(7, dtype=dtype, device=dev)
    if fix_scale:
        dof_mask[6] = 0.0
    w_valid = valid.to(dtype)

    def residual_all(xi):
        ds, dR, dt = lie.sim3_exp(xi)
        s = s0 * ds
        R = mat_mul(dR, R0)
        t = ds * mat_vec(dR, t0) + dt
        return _sim3_reproj_residuals(s, R, t, Xc1, Xc2, uv1, uv2, cam)

    def flat_residual(xi):
        e1, e2 = residual_all(xi)
        return torch.cat([e1.reshape(-1), e2.reshape(-1)])

    def cost_at(xi):
        e1, e2 = residual_all(xi)
        c = (e1 * e1).sum(-1) + (e2 * e2).sum(-1)
        rho = torch.where(c <= delta2, c,
                          2.0 * torch.sqrt(delta2 * c.clamp(min=0.0)) - delta2)
        return (rho * w_valid).sum()

    eye7 = torch.eye(7, dtype=dtype, device=dev)
    xi = torch.zeros(7, dtype=dtype, device=dev)
    lam = torch.full((), 1e-3, dtype=dtype, device=dev)
    for _ in range(iters):
        e1, e2 = residual_all(xi)
        c = (e1 * e1).sum(-1) + (e2 * e2).sum(-1)
        w = torch.where(c <= delta2, 1.0,
                        torch.sqrt(delta2 / c.clamp(min=1e-12))) * w_valid
        # the tangent as a batch of one: on 0-dim tensors torch's forward
        # mode promotes some tangents to float64
        J = torch.func.jacfwd(lambda d: flat_residual(xi + d))(
            torch.zeros((1, 7), dtype=dtype, device=dev)).reshape(-1, 7)
        J = J * dof_mask[None, :]  # frozen dofs contribute nothing
        e = torch.cat([e1.reshape(-1), e2.reshape(-1)])
        w2 = w.repeat_interleave(2)
        wr = torch.cat([w2, w2])
        Jw = J * wr[:, None]
        H = (Jw[:, :, None] * J[:, None, :]).sum(0)
        b = -(Jw * e[:, None]).sum(0)
        Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye7
        sc = torch.rsqrt(torch.diagonal(Hd) + 1e-12)
        dx = torch.linalg.solve_ex(Hd * sc[:, None] * sc[None, :],
                                   b * sc)[0] * sc
        dx = dx * dof_mask
        c0 = cost_at(xi)
        c1 = cost_at(xi + dx)
        ok = (c1 < c0) & torch.isfinite(dx).all()
        xi = torch.where(ok, xi + dx, xi)
        lam = torch.where(ok, lam * 0.5, lam * 4.0)
    ds, dR, dt = lie.sim3_exp(xi)
    s = s0 * ds
    R = mat_mul(dR, R0)
    t = ds * mat_vec(dR, t0) + dt
    e1, e2 = _sim3_reproj_residuals(s, R, t, Xc1, Xc2, uv1, uv2, cam)
    c = (e1 * e1).sum(-1) + (e2 * e2).sum(-1)
    inl = (c <= delta2) & valid
    return s, R, t, inl, inl.sum()

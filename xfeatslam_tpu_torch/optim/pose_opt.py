"""Pose-only optimization: robust Levenberg-Marquardt on SE3.

Counterpart of ``xfeatslam_tpu/optim/pose_opt.py`` (the reference's
Optimizer::PoseOptimization): one SE3 pose, unary mono (u,v) and stereo
(u,v,uR) reprojection edges, Huber kernels at chi2 5.991 / 7.815, 4 rounds
of 10 LM iterations with chi2 inlier reclassification between rounds, and
a second, graduated schedule; the candidate with the lower final robust
cost wins. Updates are left-multiplicative: T <- exp([rho,phi]) * T.

Everything stays on the device: accept/reject and the final pick are
``torch.where`` selections, the 6x6 solve is ``torch.linalg.solve_ex``
(no error check, hence no host sync), and the iteration counts are Python
constants. The 3x3 and 6x6 products are broadcast multiply-and-sum, so
TF32 never reaches them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import lie
from ..ops.camera import Pinhole, pinhole_project, pinhole_project_jac

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseOptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor      # (N,) bool, edge classified inlier at the end
    num_inliers: torch.Tensor  # () int32
    chi2: torch.Tensor         # (N,) final per-edge chi2


def _errors(R, t, Xw, obs_uv, obs_ur, cam: Pinhole, bf):
    """Batched mono+stereo residuals e (N,3) = [obs_uv - uv, obs_ur - uR],
    with the virtual right u, uR = u - bf/z; also the camera-frame points
    and 1/z."""
    Xc = lie.se3_apply(R, t, Xw)
    uv = pinhole_project(cam, Xc)
    z = Xc[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-6, 1e-6, z)
    e_ur = obs_ur - (uv[..., 0] - bf * inv_z)
    return torch.cat([obs_uv - uv, e_ur[..., None]], -1), Xc, inv_z


def _residuals(R, t, Xw, obs_uv, obs_ur, cam: Pinhole, bf):
    """Residuals e (N,3) and Jacobians J (N,3,6) with respect to
    [rho, phi]; the third row belongs to stereo edges only (the caller's
    weighting zeroes it for mono edges)."""
    e, Xc, inv_z = _errors(R, t, Xw, obs_uv, obs_ur, cam, bf)
    Jproj = pinhole_project_jac(cam, Xc)  # (N,2,3)
    zero = torch.zeros_like(inv_z)
    # d uR/dXc = du/dXc + [0, 0, bf/z^2]
    dur = Jproj[:, 0, :] + torch.stack([zero, zero, bf * inv_z * inv_z], -1)
    Jc = torch.cat([Jproj, dur[:, None, :]], 1)  # (N,3,3)
    # dXc/d[rho,phi] = [I | -hat(Xc)]
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(
        Xc.shape[:-1] + (3, 3))
    dXc = torch.cat([eye, -lie.so3_hat(Xc)], -1)  # (N,3,6)
    return e, -lie.mat_mul(Jc, dXc)


def _edge_chi2(e, inv_sigma2, is_stereo):
    """Per-edge chi2 = e^T Omega e, the third row dropped for mono edges."""
    e2 = e * e
    mono = e2[..., 0] + e2[..., 1]
    return torch.where(is_stereo, mono + e2[..., 2], mono) * inv_sigma2


def pose_optimization(R0, t0, Xw, obs_uv, obs_ur, inv_sigma2, is_stereo,
                      valid, cam: Pinhole, bf: float = 0.0, rounds: int = 4,
                      iters: int = 10) -> PoseOptResult:
    """Run the 4x10 robust LM schedule of the reference, and a graduated
    one beside it.

    Args:
      R0, t0: initial camera pose Tcw (world -> camera).
      Xw: (N,3) map-point world positions (padded).
      obs_uv: (N,2) undistorted keypoint observations.
      obs_ur: (N,) right-u for stereo/RGB-D edges (ignored for mono).
      inv_sigma2: (N,) information weights.
      is_stereo, valid: (N,) bool.
      bf: stereo baseline times fx, a number.
    """
    delta_base = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    ones = torch.ones_like(inv_sigma2)
    row_mask3 = torch.stack([ones, ones, is_stereo.to(inv_sigma2.dtype)], -1)

    def chi2_at(R, t):
        e, _, _ = _errors(R, t, Xw, obs_uv, obs_ur, cam, bf)
        return _edge_chi2(e, inv_sigma2, is_stereo)

    def robust_cost(chi2, use_huber: bool, dscale: float):
        if not use_huber:
            return chi2
        delta2 = delta_base * dscale
        return torch.where(chi2 <= delta2, chi2,
                           2.0 * torch.sqrt(delta2 * chi2.clamp(min=0.0))
                           - delta2)

    def total_cost(R, t, active, use_huber: bool, dscale: float = 1.0):
        cost = robust_cost(chi2_at(R, t), use_huber, dscale)
        return torch.where(active, cost, 0.0).sum()

    def normal_equations(R, t, active, use_huber: bool, dscale: float):
        e, J = _residuals(R, t, Xw, obs_uv, obs_ur, cam, bf)
        chi2 = _edge_chi2(e, inv_sigma2, is_stereo)
        w = inv_sigma2 * active
        if use_huber:
            delta2 = delta_base * dscale
            w = w * torch.where(chi2 <= delta2, 1.0,
                                torch.sqrt(delta2 / chi2.clamp(min=1e-12)))
        Jw = J * (w[:, None] * row_mask3)[..., None]  # (N,3,6)
        H = (Jw[..., :, None] * J[..., None, :]).sum((0, 1))
        b = -(Jw * e[..., None]).sum((0, 1))  # solve H dx = -J^T W e
        return H, b

    eye6 = torch.eye(6, dtype=Xw.dtype, device=Xw.device)

    def lm_round(R, t, active, use_huber: bool, dscale: float):
        lam = torch.full((), 1e-3, dtype=Xw.dtype, device=Xw.device)
        # the cost of the current pose: recomputed at the top of every
        # iteration in the JAX version, it equals the carried value (the
        # accepted cost1 or the unchanged cost0), so it is carried here
        cost0 = total_cost(R, t, active, use_huber, dscale)
        for _ in range(iters):
            H, b = normal_equations(R, t, active, use_huber, dscale)
            # Marquardt scaling lam*diag(H), then Jacobi preconditioning:
            # the raw system mixes px^2/rad^2 and px^2/m^2 scales
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-6 * eye6
            s = torch.rsqrt(torch.diagonal(Hd) + 1e-12)
            Hs = Hd * s[:, None] * s[None, :]
            dx = torch.linalg.solve_ex(Hs, b * s)[0] * s
            dR, dt = lie.se3_exp(dx)
            Rn, tn = lie.se3_compose(dR, dt, R, t)
            cost1 = total_cost(Rn, tn, active, use_huber, dscale)
            accept = (cost1 < cost0) & torch.isfinite(dx).all()
            R = torch.where(accept, Rn, R)
            t = torch.where(accept, tn, t)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
            cost0 = torch.where(accept, cost1, cost0)
        return R, t

    def schedule(dscales, huber_flags):
        R, t = R0, t0
        active = valid
        for rnd in range(rounds):
            R, t = lm_round(R, t, active, huber_flags[rnd], dscales[rnd])
            active = valid & (chi2_at(R, t)
                              <= delta_base * dscales[min(rnd + 1, rounds - 1)])
        return R, t

    # candidate A: the reference's schedule (Huber for 2 rounds, then plain)
    Ra, ta = schedule((1.0,) * rounds, (True, True) + (False,) * (rounds - 2))
    # candidate B: graduated non-convexity, progressively tightening Huber
    # widths from the same prediction; it escapes secondary minima a few cm
    # from the truth, which have the higher final robust cost
    gnc = ((25.0, 9.0, 3.0) + (1.0,) * max(rounds - 3, 0))[:rounds]
    Rb, tb = schedule(gnc, (True,) * rounds)

    cost_a = total_cost(Ra, ta, valid, True)
    cost_b = total_cost(Rb, tb, valid, True)
    pick_b = (cost_b < cost_a) & torch.isfinite(tb).all()
    R = torch.where(pick_b, Rb, Ra)
    t = torch.where(pick_b, tb, ta)

    chi2 = chi2_at(R, t)
    active = valid & (chi2 <= delta_base)
    return PoseOptResult(R, t, active, active.sum(dtype=torch.int32), chi2)

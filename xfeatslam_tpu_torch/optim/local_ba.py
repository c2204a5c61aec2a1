"""Bundle adjustment: robust Levenberg-Marquardt over cameras and points.

Counterpart of ``xfeatslam_tpu/optim/local_ba.py`` (the role of g2o in
ORB-SLAM3's Optimizer::LocalBundleAdjustment): covisible keyframes and
their map points with fixed boundary keyframes, Huber kernels, the
two-stage schedule (5 iterations, prune chi2 outliers, 10 iterations).

Matrix-free: the damped normal equations (H + lam D) dx = -g are solved by
block-Jacobi preconditioned conjugate gradients, with H-vector products as
per-observation products and scatter-adds (``index_add``). Every shape is
static (padded and masked). The two ``fori_loop``s of the JAX version
become Python loops that never read a device value on the host: accept or
reject, the damping and the CG step sizes are ``torch.where`` selections
and 0-dim tensors. The small products are broadcast multiply-and-sum
(``lie.mat_mul`` / ``mat_vec``), never ``@``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops import lie
from ..ops.camera import Pinhole, pinhole_project_jac
from ..ops.lie import mat_mul, mat_vec

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class BAProblem(NamedTuple):
    """Padded bundle-adjustment problem: C cameras, P points, O
    observations (all static)."""

    R: torch.Tensor  # (C,3,3) world->camera
    t: torch.Tensor  # (C,3)
    fixed: torch.Tensor  # (C,) bool, gauge/boundary cameras
    cam_valid: torch.Tensor  # (C,) bool, padding mask
    X: torch.Tensor  # (P,3)
    p_valid: torch.Tensor  # (P,) bool
    obs_cam: torch.Tensor  # (O,) int32
    obs_pt: torch.Tensor  # (O,) int32
    uv: torch.Tensor  # (O,2)
    ur: torch.Tensor  # (O,)
    stereo: torch.Tensor  # (O,) bool
    valid: torch.Tensor  # (O,) bool
    inv_sigma2: torch.Tensor  # (O,)


class BAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    inlier: torch.Tensor  # (O,) bool
    chi2: torch.Tensor  # (O,)


def _residuals(prob: BAProblem, R, t, X, cam: Pinhole, bf: float):
    """Per-observation residuals e (O,3) and Jacobians Jc (O,3,6),
    Jp (O,3,3)."""
    Rc = R[prob.obs_cam.long()]
    Xc = mat_vec(Rc, X[prob.obs_pt.long()]) + t[prob.obs_cam.long()]
    z = Xc[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-6, 1e-6, z)
    u = cam.fx * Xc[..., 0] * inv_z + cam.cx
    v = cam.fy * Xc[..., 1] * inv_z + cam.cy
    ur_pred = u - bf * inv_z
    e = torch.stack([prob.uv[..., 0] - u, prob.uv[..., 1] - v,
                     prob.ur - ur_pred], -1)
    Jproj = pinhole_project_jac(cam, Xc)  # (O,2,3)
    zero = torch.zeros_like(z)
    dur = Jproj[:, 0, :] + torch.stack([zero, zero, bf * inv_z * inv_z], -1)
    Jall = torch.cat([Jproj, dur[:, None, :]], 1)  # (O,3,3) d/dXc
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(
        Xc.shape[:-1] + (3, 3))
    dXc_dxi = torch.cat([eye, -lie.so3_hat(Xc)], -1)  # (O,3,6)
    return e, -mat_mul(Jall, dXc_dxi), -mat_mul(Jall, Rc)


def _chi2(e, inv_sigma2, stereo):
    e2 = e * e
    mono = (e2[..., 0] + e2[..., 1]) * inv_sigma2
    return torch.where(stereo, mono + e2[..., 2] * inv_sigma2, mono)


def _segment_sum(vals, seg, n: int):
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, seg, vals)


def _depth(prob: BAProblem, R, t, X):
    return (mat_vec(R[prob.obs_cam.long()], X[prob.obs_pt.long()])
            + t[prob.obs_cam.long()])[..., 2]


@torch.no_grad()
def bundle_adjust(prob: BAProblem, cam: Pinhole, bf: float = 0.0,
                  stage_iters: Tuple[int, int] = (5, 10), cg_iters: int = 40,
                  huber: bool = True) -> BAResult:
    """Run the two-stage robust LM schedule of LocalBundleAdjustment.

    Returns BAResult with the updated poses and points and the final
    observation inlier classification (chi2 <= 5.991 / 7.815 and positive
    depth, the reference's prune rule)."""
    C = prob.R.shape[0]
    P = prob.X.shape[0]
    obs_cam, obs_pt = prob.obs_cam.long(), prob.obs_pt.long()
    ones = torch.ones_like(prob.inv_sigma2)
    row3 = torch.stack([ones, ones, prob.stereo.to(ones.dtype)], -1)
    free_cam = (~prob.fixed) & prob.cam_valid
    free_c = free_cam[:, None].to(ones.dtype)
    valid_p = prob.p_valid[:, None].to(ones.dtype)
    delta2 = torch.where(prob.stereo, CHI2_STEREO, CHI2_MONO)

    def robust_w(chi2):
        if not huber:
            return ones
        return torch.where(chi2 <= delta2, 1.0,
                           torch.sqrt(delta2 / chi2.clamp(min=1e-12)))

    def robust_cost(chi2):
        if not huber:
            return chi2
        return torch.where(chi2 <= delta2, chi2,
                           2.0 * torch.sqrt(delta2 * chi2.clamp(min=0.0))
                           - delta2)

    def total_cost(R, t, X, active):
        e, _, _ = _residuals(prob, R, t, X, cam, bf)
        c = _chi2(e, prob.inv_sigma2, prob.stereo)
        return torch.where(active, robust_cost(c), 0.0).sum()

    def damp(Hb, dim, valid_mask, lam):
        diag = torch.diagonal(Hb, dim1=-2, dim2=-1)
        eye = torch.eye(dim, dtype=Hb.dtype, device=Hb.device)
        Hd = Hb + (lam * diag + 1e-6)[..., None] * eye
        return torch.where(valid_mask[:, None, None], Hd, eye)

    def lm_stage(R, t, X, active, n_iters):
        lam = torch.full((), 1e-4, dtype=ones.dtype, device=ones.device)
        # the cost of the current state: the JAX version recomputes it at
        # the top of every iteration; it equals the carried value (the
        # accepted cost1 or the unchanged cost0)
        cost0 = total_cost(R, t, X, active) if n_iters else None
        for _ in range(n_iters):
            e, Jc, Jp = _residuals(prob, R, t, X, cam, bf)
            chi2 = _chi2(e, prob.inv_sigma2, prob.stereo)
            w = robust_w(chi2) * prob.inv_sigma2 * active  # (O,)
            Wr = w[:, None] * row3  # (O,3) row weights
            JcW = Jc * Wr[..., None]
            JpW = Jp * Wr[..., None]
            g_c = _segment_sum((JcW * e[..., None]).sum(-2), obs_cam, C) * free_c
            g_p = _segment_sum((JpW * e[..., None]).sum(-2), obs_pt, P) * valid_p
            # block diagonals of H: damping and the preconditioner
            Hcc = _segment_sum(mat_mul(JcW.transpose(-1, -2), Jc), obs_cam, C)
            Hpp = _segment_sum(mat_mul(JpW.transpose(-1, -2), Jp), obs_pt, P)
            Mc_inv = torch.linalg.inv_ex(damp(Hcc, 6, free_cam, lam))[0]
            Mp_inv = torch.linalg.inv_ex(damp(Hpp, 3, prob.p_valid, lam))[0]
            dc = lam * torch.diagonal(Hcc, dim1=-2, dim2=-1) + 1e-6
            dp = lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-6

            def Hv(vc, vp):
                """(H + lam D) v, matrix-free over the observations."""
                rv = (mat_vec(Jc, vc[obs_cam] * free_c[obs_cam])
                      + mat_vec(Jp, vp[obs_pt] * valid_p[obs_pt])) * Wr
                hc = _segment_sum((Jc * rv[..., None]).sum(-2), obs_cam, C)
                hp = _segment_sum((Jp * rv[..., None]).sum(-2), obs_pt, P)
                return (hc + dc * vc) * free_c, (hp + dp * vp) * valid_p

            def precond(rc, rp):
                return mat_vec(Mc_inv, rc) * free_c, mat_vec(Mp_inv, rp) * valid_p

            # PCG on (H + lam D) dx = -g
            rc, rp = -g_c, -g_p
            zc, zp = precond(rc, rp)
            pc, pp = zc, zp
            rz = (rc * zc).sum() + (rp * zp).sum()
            xc = torch.zeros_like(rc)
            xp = torch.zeros_like(rp)
            for _ in range(cg_iters):
                Apc, App = Hv(pc, pp)
                pAp = (pc * Apc).sum() + (pp * App).sum()
                alpha = rz / torch.where(pAp.abs() < 1e-12, 1e-12, pAp)
                xc = xc + alpha * pc
                xp = xp + alpha * pp
                rc = rc - alpha * Apc
                rp = rp - alpha * App
                zc, zp = precond(rc, rp)
                rz_new = (rc * zc).sum() + (rp * zp).sum()
                beta = rz_new / torch.where(rz.abs() < 1e-12, 1e-12, rz)
                pc = zc + beta * pc
                pp = zp + beta * pp
                rz = rz_new

            # candidate update, left-multiplicative on the free cameras
            dR, dt = lie.se3_exp(xc)
            Rn = torch.where(free_cam[:, None, None], mat_mul(dR, R), R)
            tn = torch.where(free_cam[:, None], mat_vec(dR, t) + dt, t)
            Xn = torch.where(prob.p_valid[:, None], X + xp, X)
            cost1 = total_cost(Rn, tn, Xn, active)
            accept = ((cost1 < cost0) & torch.isfinite(xc).all()
                      & torch.isfinite(xp).all())
            R = torch.where(accept, Rn, R)
            t = torch.where(accept, tn, t)
            X = torch.where(accept, Xn, X)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
            cost0 = torch.where(accept, cost1, cost0)
        return R, t, X

    def classify(R, t, X):
        e, _, _ = _residuals(prob, R, t, X, cam, bf)
        chi2 = _chi2(e, prob.inv_sigma2, prob.stereo)
        return chi2, (chi2 <= delta2) & (_depth(prob, R, t, X) > 0)

    R, t, X = prob.R, prob.t, prob.X
    # stage 1: robust
    R, t, X = lm_stage(R, t, X, prob.valid, stage_iters[0])
    # prune outliers (chi2 or negative depth), then stage 2
    _, keep = classify(R, t, X)
    R, t, X = lm_stage(R, t, X, prob.valid & keep, stage_iters[1])
    chi2, keep = classify(R, t, X)
    return BAResult(R, t, X, prob.valid & keep, chi2)

"""Inertial optimizers: IMU initialization, visual-inertial pose tracking
and the state half of the local inertial BA.

Counterpart of ``xfeatslam_tpu/optim/inertial.py`` (the role of ORB-SLAM3's
InertialOptimization, PoseInertialOptimizationLastKeyFrame / LastFrame and
LocalInertialBA): every residual (whitened by the preintegration
covariance) is stacked into one dense LM over a flat parameter vector
(``_dense_lm``), with the JAX package's iteration counts and its
accept-or-reject rule as ``torch.where`` selections (no host read, so a
solve is captured as one CUDA graph: ``InertialGraph``).

The Jacobians are forward-mode derivatives of the residual functions, the
JAX package's ``jax.jacfwd``: one ``torch.func.jvp`` over a batch of the n
unit directions (a leading axis every residual function carries, not a
vmap: on 0-dim tensors torch's forward mode promotes some tangents to
float64). Linear algebra uses the ``_ex`` variants (``inv_ex``,
``cholesky_ex``, ``solve_ex``), which do not synchronize with the host, and
the small products are broadcast multiply-and-sum, never ``@``.

Frames: body states (R_wb, p_wb, v_w) live in the map's world frame; the
camera pose of a reprojection is T_cw = (T_wb T_bc)^-1, T_bc the
body<-camera extrinsic.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import lie
from ..ops.camera import Pinhole, pinhole_project
from ..ops.imu import Preintegrated, delta_with_bias, gravity_like
from ..ops.lie import mat_mul, mat_vec
from .track_step import CapturedCalls

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _mT(A):
    return A.transpose(-1, -2)


# --------------------------------------------------------------------------
# frame conversions
# --------------------------------------------------------------------------

def cam_to_body(R_cw, t_cw, R_bc, t_bc):
    """T_cw (world->camera) -> body state (R_wb, p_wb)."""
    R_wc = _mT(R_cw)
    C_w = -mat_vec(R_wc, t_cw)
    R_wb = mat_mul(R_wc, _mT(R_bc))
    p_wb = C_w - mat_vec(R_wb, t_bc)
    return R_wb, p_wb


def np_cam_to_body(R_cw, t_cw, R_bc, t_bc):
    """Host numpy mirror of cam_to_body (single poses)."""
    R_wc = R_cw.T
    C_w = -R_wc @ t_cw
    R_wb = R_wc @ R_bc.T
    p_wb = C_w - R_wb @ t_bc
    return R_wb.astype(np.float32), p_wb.astype(np.float32)


def np_body_to_cam(R_wb, p_wb, R_bc, t_bc):
    """Host numpy mirror of body_to_cam."""
    R_wc = R_wb @ R_bc
    C_w = p_wb + R_wb @ t_bc
    R_cw = R_wc.T
    t_cw = -R_cw @ C_w
    return R_cw.astype(np.float32), t_cw.astype(np.float32)


def body_to_cam(R_wb, p_wb, R_bc, t_bc):
    """Body state -> T_cw (world->camera) for reprojection."""
    R_wc = mat_mul(R_wb, R_bc)
    C_w = p_wb + mat_vec(R_wb, t_bc)
    R_cw = _mT(R_wc)
    return R_cw, -mat_vec(R_cw, C_w)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _whitener9(cov9):
    """L with L e whitening a 9-D residual (info = L^T L)."""
    info = torch.linalg.inv_ex(cov9 + 1e-12 * _eye(9, cov9))[0]
    info = 0.5 * (info + _mT(info))
    return torch.linalg.cholesky_ex(info)[0]


def _walk_whitener(walk_cov, eps: float = 1e-10):
    """The Cholesky factor of the bias-walk information."""
    info = torch.linalg.inv_ex(walk_cov + eps * _eye(6, walk_cov))[0]
    return torch.linalg.cholesky_ex(0.5 * (info + _mT(info)))[0]


def jacobian(fn, x):
    """fn (B,n) -> (B,m) at x (n,): returns (fn(x) (m,), J (m,n)), the
    forward-mode Jacobian over the n unit directions as one batch."""
    n = x.shape[-1]
    r, Jt = torch.func.jvp(fn, (x.expand(n, n).clone(),), (_eye(n, x),))
    return r[0], _mT(Jt)


def _gram(J):
    """J^T J by broadcast multiply-and-sum."""
    return (J[:, :, None] * J[:, None, :]).sum(0)


def _dense_lm(residual_fn, x0, iters: int = 15, trace=None):
    """Small dense LM: residual_fn (B,n) -> (B,m) stacked whitened
    residuals; ``iters`` iterations, each kept or rejected by its cost.
    ``trace``, a list, receives each iteration's (kept, cost before, cost
    of the step) as a tensor."""
    x = x0
    lam = torch.full((), 1e-3, dtype=x0.dtype, device=x0.device)
    eye = _eye(x0.shape[0], x0)
    for _ in range(iters):
        r, J = jacobian(residual_fn, x)
        H = _gram(J)
        g = (J * r[:, None]).sum(0)
        dH = torch.diagonal(H)
        Hd = H + lam * torch.diag(dH) + 1e-8 * eye
        s = torch.rsqrt(torch.diagonal(Hd) + 1e-12)
        sol = torch.linalg.solve_ex(Hd * s[:, None] * s[None, :],
                                    (g * s)[:, None])[0][:, 0]
        dx = -(sol * s)
        x_new = x + dx
        c0 = (r * r).sum()
        r1 = residual_fn(x_new[None])[0]
        c1 = (r1 * r1).sum()
        ok = (c1 < c0) & torch.isfinite(dx).all()
        if trace is not None:
            trace.append(torch.stack([ok.to(c0.dtype), c0, c1]))
        x = torch.where(ok, x_new, x)
        lam = torch.where(ok, lam * 0.5, lam * 5.0)
    return x


def _edge_residual9(Ri, pi, vi, Rj, pj, vj, t, g, dR_c, dV_c, dP_c, s=None):
    """[e_R, e_v, e_p] of inertial edges (any leading shape)."""
    RiT = _mT(Ri)
    e_R = lie.so3_log(mat_mul(_mT(dR_c), mat_mul(RiT, Rj)))
    e_v = mat_vec(RiT, vj - vi - g * t) - dV_c
    dp = pj - pi if s is None else s * (pj - pi)
    e_p = mat_vec(RiT, dp - vi * t - 0.5 * g * t * t) - dP_c
    return torch.cat([e_R, e_v, e_p], -1)


# --------------------------------------------------------------------------
# IMU initialization: scale / gravity / bias / velocities on fixed poses
# --------------------------------------------------------------------------

class InitResult(NamedTuple):
    scale: torch.Tensor  # ()
    R_wg: torch.Tensor  # (3,3) world<-gravity frame (g_world = R_wg e_g)
    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    vel: torch.Tensor  # (K,3) body velocities (metric)
    cost: torch.Tensor


@torch.no_grad()
def inertial_init(R_wb, p_wb, dts, dR, dV, dP, JRg, JVg, JVa, JPg, JPa,
                  cov9, e_valid, prior_g: float = 1e2, prior_a: float = 1e6,
                  fix_scale: bool = False) -> InitResult:
    """InertialOptimization: with the keyframe poses fixed (visual map,
    arbitrary scale and orientation), estimate the map scale, the gravity
    direction, one shared gyro / acc bias and the keyframes' velocities
    from the preintegrations between consecutive keyframes.

    R_wb, p_wb: (K,3,3), (K,3) body poses; dts / dR / ... / J*: (K-1, ...)
    preintegrations between keyframes k and k+1 at zero bias; cov9:
    (K-1,9,9); e_valid: (K-1,) mask; prior_g / prior_a: the bias priors;
    fix_scale: True for stereo / RGB-D inertial. The caller applies
    p_metric = s p_visual and rotates the world by R_wg^T."""
    K = R_wb.shape[0]
    E = K - 1
    Ls = _whitener9(cov9)
    w = e_valid.to(R_wb.dtype)
    g_nom = gravity_like(R_wb)
    sq_g, sq_a = math.sqrt(prior_g), math.sqrt(prior_a)

    def unpack(x):
        B = x.shape[0]
        bg = x[:, 3:6]
        ba = x[:, 6:9]
        vel = x[:, 9:].reshape(B, K, 3)
        # the gravity direction: nominal -z rotated by exp([dg, 0])
        R_wg = lie.so3_exp(torch.cat([x[:, 0:2], torch.zeros_like(x[:, :1])],
                                     -1))
        g = mat_vec(R_wg, g_nom)
        s = torch.ones_like(x[:, 2]) if fix_scale else torch.exp(x[:, 2])
        return s, g, bg, ba, vel, R_wg

    def residuals(x):
        s, g, bg, ba, vel, _ = unpack(x)
        bgE, baE = bg[:, None], ba[:, None]
        dR_c = mat_mul(dR, lie.so3_exp(mat_vec(JRg, bgE)))
        dV_c = dV + mat_vec(JVg, bgE) + mat_vec(JVa, baE)
        dP_c = dP + mat_vec(JPg, bgE) + mat_vec(JPa, baE)
        t = dts[:, None]
        e = _edge_residual9(R_wb[:E], p_wb[:E], vel[:, :E], R_wb[1:],
                            p_wb[1:], vel[:, 1:], t, g[:, None], dR_c, dV_c,
                            dP_c, s=s[:, None, None])
        r = (mat_vec(Ls, e) * w[:, None]).reshape(x.shape[0], E * 9)
        return torch.cat([r, sq_g * bg, sq_a * ba], -1)

    # coarse start: scale may be far from 1 (monocular maps are median-depth
    # normalized); grid-search log s with velocities from finite differences
    # of the scaled poses, and start LM from the best candidate
    dt_safe = torch.where(e_valid, dts, 1.0)

    def seeds(log_s):
        """(S,) log-scale candidates -> (S, 9+3K) start vectors."""
        log_s = torch.zeros_like(log_s) if fix_scale else log_s
        dv = ((p_wb[1:] - p_wb[:-1])[None] * torch.exp(log_s)[:, None, None]
              / dt_safe[None, :, None])
        dv = torch.where(e_valid[None, :, None], dv, 0.0)
        # v_k from the outgoing edge; the last state reuses the incoming one
        vel = torch.cat([dv, dv[:, -1:]], 1)
        x = torch.zeros((log_s.shape[0], 9 + 3 * K), dtype=R_wb.dtype,
                        device=R_wb.device)
        return torch.cat([x[:, :2], log_s[:, None], x[:, 3:9],
                          vel.reshape(log_s.shape[0], -1)], -1)

    if fix_scale:
        x0 = seeds(torch.zeros(1, dtype=R_wb.dtype, device=R_wb.device))[0]
    else:
        cands = seeds(torch.linspace(-2.5, 2.5, 21, dtype=R_wb.dtype,
                                     device=R_wb.device))
        r = residuals(cands)
        # index_select: a 0-dim index tensor would be read on the host
        x0 = torch.index_select(cands, 0,
                                torch.argmin((r * r).sum(-1)).reshape(1))[0]
    x = _dense_lm(residuals, x0, iters=60)
    s, _g, bg, ba, vel, R_wg = unpack(x[None])
    r = residuals(x[None])[0]
    return InitResult(s[0], R_wg[0], bg[0], ba[0], vel[0], (r * r).sum())


# --------------------------------------------------------------------------
# per-frame visual-inertial pose optimization
# --------------------------------------------------------------------------

class PoseInertialResult(NamedTuple):
    R_wb: torch.Tensor
    p_wb: torch.Tensor
    v_w: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    inliers: torch.Tensor  # (N,) visual edge classification
    num_inliers: torch.Tensor
    # (15,15) information (J^T J at the solution) of the estimated state:
    # the next frame's prior (for the LastFrame variant: the marginal of
    # the current state after eliminating the last frame)
    H: torch.Tensor


class _Visual:
    """The reprojection edges of one frame, shared by both pose LMs."""

    def __init__(self, Xw, obs_uv, obs_ur, inv_sigma2, is_stereo, valid,
                 cam: Pinhole, bf, R_bc, t_bc):
        self.Xw, self.obs_uv, self.obs_ur = Xw, obs_uv, obs_ur
        self.inv_sigma2, self.is_stereo, self.valid = (inv_sigma2, is_stereo,
                                                       valid)
        self.cam, self.bf, self.R_bc, self.t_bc = cam, float(bf), R_bc, t_bc
        self.thresh = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)

    def residuals(self, R, p):
        """e_uv (B,N,2), e_ur (B,N) at body states R (B,3,3), p (B,3)."""
        R_cw, t_cw = body_to_cam(R, p, self.R_bc, self.t_bc)
        Xc = mat_vec(R_cw[:, None], self.Xw) + t_cw[:, None]
        uv = pinhole_project(self.cam, Xc)
        z = Xc[..., 2]
        inv_z = 1.0 / torch.where(z.abs() < 1e-6, 1e-6, z)
        ur_pred = uv[..., 0] - self.bf * inv_z
        e_uv = self.obs_uv - uv
        e_ur = torch.where(self.is_stereo, self.obs_ur - ur_pred, 0.0)
        return e_uv, e_ur

    def chi2(self, e_uv, e_ur):
        return ((e_uv * e_uv).sum(-1) + e_ur * e_ur) * self.inv_sigma2

    def robust_w(self, chi2, active):
        w = torch.where(chi2 <= self.thresh, 1.0,
                        torch.sqrt(self.thresh / chi2.clamp(min=1e-12)))
        return w * active

    def whitened(self, R, p, w_cached):
        e_uv, e_ur = self.residuals(R, p)
        wv = torch.sqrt(w_cached * self.inv_sigma2)
        return torch.cat([e_uv * wv[..., None], (e_ur * wv)[..., None]],
                         -1).reshape(R.shape[0], -1)


def _pose_rounds(vis: _Visual, residual_fn, pose_of, n, rounds, iters,
                 like):
    """The robust rounds shared by both pose LMs: Huber weights from the
    current pose, a dense LM, chi2 reclassification."""
    x = torch.zeros(n, dtype=like.dtype, device=like.device)
    active = vis.valid.to(like.dtype)
    for _ in range(rounds):
        R, p = pose_of(x[None])
        w_huber = vis.robust_w(vis.chi2(*vis.residuals(R, p))[0], active)
        x = _dense_lm(lambda xx, w=w_huber: residual_fn(xx, w), x,
                      iters=iters)
        R, p = pose_of(x[None])
        chi2 = vis.chi2(*vis.residuals(R, p))[0]
        active = (vis.valid & (chi2 <= vis.thresh)).to(like.dtype)
    return x, active


@torch.no_grad()
def pose_inertial_optimization(
        R_j, p_j, v_j, bg_j, ba_j, R_i, p_i, v_i, pre: Preintegrated,
        Xw, obs_uv, obs_ur, inv_sigma2, is_stereo, valid,
        cam: Pinhole, bf, R_bc, t_bc, gravity=None,
        rounds: int = 3, iters: int = 8) -> PoseInertialResult:
    """PoseInertialOptimizationLastKeyFrame: the current frame's body pose,
    velocity and biases from its reprojection edges, the inertial edge to
    the fixed anchor state and the bias random walk; Huber on the visual
    edges, chi2 reclassification between rounds."""
    g = gravity_like(p_j) if gravity is None else gravity
    vis = _Visual(Xw, obs_uv, obs_ur, inv_sigma2, is_stereo, valid, cam, bf,
                  R_bc, t_bc)
    L9 = _whitener9(pre.cov[:9, :9])
    Lb = _walk_whitener(pre.cov[9:, 9:])

    def unpack(x):
        R = mat_mul(R_j, lie.so3_exp(x[:, 0:3]))
        return (R, p_j + x[:, 3:6], v_j + x[:, 6:9], bg_j + x[:, 9:12],
                ba_j + x[:, 12:15])

    def pose_of(x):
        R, p, *_ = unpack(x)
        return R, p

    def residual_fn(x, w_cached):
        R, p, v, bg, ba = unpack(x)
        r_vis = vis.whitened(R, p, w_cached)
        dRc, dVc, dPc = delta_with_bias(pre, bg, ba)
        e = _edge_residual9(R_i, p_i, v_i, R, p, v, pre.dt, g, dRc, dVc,
                            dPc)
        r_imu = mat_vec(L9, e)
        r_bias = mat_vec(Lb, torch.cat([bg - pre.bg, ba - pre.ba], -1))
        return torch.cat([r_vis, r_imu, r_bias], -1)

    x, active = _pose_rounds(vis, residual_fn, pose_of, 15, rounds, iters,
                             R_j)
    R, p, v, bg, ba = unpack(x[None])
    R = lie.project_rotation(R)
    chi2 = vis.chi2(*vis.residuals(R, p))[0]
    inl = valid & (chi2 <= vis.thresh)
    # the information of the solved state (recoverH)
    w_fin = vis.robust_w(chi2, active)
    _, J = jacobian(lambda xx: residual_fn(xx, w_fin), x)
    H = _gram(J)
    return PoseInertialResult(R[0], p[0], v[0], bg[0], ba[0], inl,
                              inl.to(torch.int32).sum(), 0.5 * (H + _mT(H)))


@torch.no_grad()
def pose_inertial_optimization_last_frame(
        R_j, p_j, v_j, bg_j, ba_j, R_i, p_i, v_i, bg_i, ba_i, prior_L,
        pre: Preintegrated, Xw, obs_uv, obs_ur, inv_sigma2, is_stereo, valid,
        cam: Pinhole, bf, R_bc, t_bc, gravity=None,
        rounds: int = 3, iters: int = 8) -> PoseInertialResult:
    """PoseInertialOptimizationLastFrame: between keyframes the per-frame
    solve chains posteriors. The last frame enters as a free 15-D state
    held by its marginalized prior (``prior_L`` (15,15), L delta whitens),
    the inertial and bias-walk edges couple it to the current frame, and it
    is Schur-eliminated afterwards to give the next prior."""
    g = gravity_like(p_j) if gravity is None else gravity
    vis = _Visual(Xw, obs_uv, obs_ur, inv_sigma2, is_stereo, valid, cam, bf,
                  R_bc, t_bc)
    L9 = _whitener9(pre.cov[:9, :9])
    Lb = _walk_whitener(pre.cov[9:, 9:])

    def unpack(x):
        xi, xj = x[:, :15], x[:, 15:]
        si = (mat_mul(R_i, lie.so3_exp(xi[:, 0:3])), p_i + xi[:, 3:6],
              v_i + xi[:, 6:9], bg_i + xi[:, 9:12], ba_i + xi[:, 12:15])
        sj = (mat_mul(R_j, lie.so3_exp(xj[:, 0:3])), p_j + xj[:, 3:6],
              v_j + xj[:, 6:9], bg_j + xj[:, 9:12], ba_j + xj[:, 12:15])
        return si, sj

    def pose_of(x):
        _si, (R, p, *_rest) = unpack(x)
        return R, p

    def residual_fn(x, w_cached):
        (Ri, pi, vi, bgi, bai), (Rj, pj, vj, bgj, baj) = unpack(x)
        r_vis = vis.whitened(Rj, pj, w_cached)
        # the inertial edge i -> j at i's bias
        dRc, dVc, dPc = delta_with_bias(pre, bgi, bai)
        e = _edge_residual9(Ri, pi, vi, Rj, pj, vj, pre.dt, g, dRc, dVc, dPc)
        r_imu = mat_vec(L9, e)
        r_bias = mat_vec(Lb, torch.cat([bgj - bgi, baj - bai], -1))
        # the prior on the last frame (its mean is the start, so delta = xi)
        r_prior = mat_vec(prior_L, x[:, :15])
        return torch.cat([r_vis, r_imu, r_bias, r_prior], -1)

    x, active = _pose_rounds(vis, residual_fn, pose_of, 30, rounds, iters,
                             R_j)
    _si, (Rj, pj, vj, bgj, baj) = unpack(x[None])
    Rj = lie.project_rotation(Rj)
    chi2 = vis.chi2(*vis.residuals(Rj, pj))[0]
    inl = valid & (chi2 <= vis.thresh)
    # marginalize the last frame: H_jj - H_ji H_ii^-1 H_ij
    w_fin = vis.robust_w(chi2, active)
    _, J = jacobian(lambda xx: residual_fn(xx, w_fin), x)
    H = _gram(J)
    H_ii = H[:15, :15] + 1e-6 * _eye(15, H)
    H_ij = H[:15, 15:]
    Hm = H[15:, 15:] - mat_mul(_mT(H_ij),
                               torch.linalg.solve_ex(H_ii, H_ij)[0])
    return PoseInertialResult(Rj[0], pj[0], vj[0], bgj[0], baj[0], inl,
                              inl.to(torch.int32).sum(),
                              0.5 * (Hm + _mT(Hm)))


# --------------------------------------------------------------------------
# local inertial BA, the state half: window states + inertial chain
# --------------------------------------------------------------------------

@torch.no_grad()
def local_inertial_ba_states(
        R_wb, p_wb, v_w, bg, ba, fixed,
        dts, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, cov9, walk_cov, e_valid,
        obs_cam, Xw, obs_uv, obs_ur, inv_sigma2, is_stereo, obs_valid,
        cam: Pinhole, bf, R_bc, t_bc, gravity=None, iters: int = 20):
    """The state half of LocalInertialBA: the window's body states (pose,
    velocity, biases: 15 per keyframe) from reprojection edges to fixed
    landmarks plus the inertial and bias-walk chain, in two robust rounds
    of ``iters // 2`` LM iterations. Returns (R, p, v, bg, ba)."""
    g = gravity_like(p_wb) if gravity is None else gravity
    K = R_wb.shape[0]
    E = K - 1
    Ls = _whitener9(cov9)
    Lb = _walk_whitener(walk_cov)
    we = e_valid.to(R_wb.dtype)[:, None]
    free = (~fixed).to(R_wb.dtype)[:, None]
    oc = obs_cam.long()
    vis = _Visual(Xw, obs_uv, obs_ur, inv_sigma2, is_stereo, obs_valid, cam,
                  bf, R_bc, t_bc)

    def unpack(x):
        d = x.reshape(x.shape[0], K, 15) * free
        return (mat_mul(R_wb, lie.so3_exp(d[..., 0:3])), p_wb + d[..., 3:6],
                v_w + d[..., 6:9], bg + d[..., 9:12], ba + d[..., 12:15])

    def obs_residuals(R, p):
        """Per observation: the states' cameras gathered to the rows."""
        R_cw, t_cw = body_to_cam(R, p, R_bc, t_bc)
        Xc = mat_vec(R_cw[:, oc], Xw) + t_cw[:, oc]
        uv = pinhole_project(cam, Xc)
        z = Xc[..., 2]
        inv_z = 1.0 / torch.where(z.abs() < 1e-6, 1e-6, z)
        e_uv = obs_uv - uv
        e_ur = torch.where(is_stereo, obs_ur - (uv[..., 0] - vis.bf * inv_z),
                           0.0)
        return e_uv, e_ur

    def residual_fn(x, w_huber):
        R, p, v, bgx, bax = unpack(x)
        e_uv, e_ur = obs_residuals(R, p)
        wv = torch.sqrt(w_huber * inv_sigma2)
        r_vis = torch.cat([e_uv * wv[..., None], (e_ur * wv)[..., None]],
                          -1).reshape(x.shape[0], -1)
        bgi, bai = bgx[:, :E], bax[:, :E]
        dR_c = mat_mul(dR, lie.so3_exp(mat_vec(JRg, bgi)))
        dV_c = dV + mat_vec(JVg, bgi) + mat_vec(JVa, bai)
        dP_c = dP + mat_vec(JPg, bgi) + mat_vec(JPa, bai)
        e = _edge_residual9(R[:, :E], p[:, :E], v[:, :E], R[:, 1:], p[:, 1:],
                            v[:, 1:], dts[:, None], g, dR_c, dV_c, dP_c)
        r_imu = mat_vec(Ls, e) * we
        r_b = mat_vec(Lb, torch.cat([bgx[:, 1:] - bgi, bax[:, 1:] - bai],
                                    -1)) * we
        r_chain = torch.cat([r_imu, r_b], -1).reshape(x.shape[0], -1)
        return torch.cat([r_vis, r_chain], -1)

    def vis_chi2(x):
        R, p, *_ = unpack(x[None])
        return vis.chi2(*obs_residuals(R, p))[0]

    x = torch.zeros(K * 15, dtype=R_wb.dtype, device=R_wb.device)
    active = obs_valid.to(R_wb.dtype)
    for _ in range(2):
        w_h = vis.robust_w(vis_chi2(x), active)
        x = _dense_lm(lambda xx, w=w_h: residual_fn(xx, w), x,
                      iters=iters // 2)
        active = (obs_valid & (vis_chi2(x) <= vis.thresh)).to(R_wb.dtype)
    R, p, v, bgx, bax = unpack(x[None])
    return lie.project_rotation(R[0]), p[0], v[0], bgx[0], bax[0]


# --------------------------------------------------------------------------
# CUDA graphs
# --------------------------------------------------------------------------

def pose_inertial_flat(*tensors, cam: Pinhole, bf: float):
    """``pose_inertial_optimization`` on one flat tuple of tensors: the 8
    states, the 12 fields of the preintegration, the 6 visual-edge tensors
    and R_bc, t_bc (the form an ``InertialGraph`` captures)."""
    return pose_inertial_optimization(
        *tensors[:8], Preintegrated(*tensors[8:20]), *tensors[20:26], cam,
        bf, *tensors[26:28])


def pose_inertial_last_frame_flat(*tensors, cam: Pinhole, bf: float):
    """``pose_inertial_optimization_last_frame`` on one flat tuple: the 11
    states and the prior, the 12 fields of the preintegration, the 6
    visual-edge tensors and R_bc, t_bc."""
    return pose_inertial_optimization_last_frame(
        *tensors[:11], Preintegrated(*tensors[11:23]), *tensors[23:29], cam,
        bf, *tensors[29:31])


class InertialGraph(CapturedCalls):
    """An inertial solver (this module's flat pose LMs and
    ``inertial_init``, ``imu.preintegrate``, ``viba.solve_flat``) captured
    as one CUDA graph per static signature and replayed
    (``track_step.CapturedCalls``). ``fn`` is called as
    ``fn(*tensors, **static)``; the key holds the tensors' shapes and dtypes
    and ``static``, which must hold every non-tensor argument (the camera as
    a tuple of floats is rebuilt into a Pinhole). Returns the graph's
    static outputs (read them with ``fetch`` first)."""

    def __init__(self, device, fn):
        super().__init__(device, fn.__name__)
        self.fn = fn

    def __call__(self, tensors, **static):
        key = tuple(sorted((k, tuple(float(c) for c in v)
                            if isinstance(v, Pinhole) else v)
                           for k, v in static.items()))

        def run(*inputs):
            return self.fn(*inputs, **static)

        return self.replay(key, tuple(tensors), run)

"""Joint visual-inertial local bundle adjustment (LocalInertialBA).

Counterpart of ``xfeatslam_tpu/optim/viba.py``: a temporal window of body
states (pose, velocity, gyro and acc bias: 15-D each) and the window's
landmarks, optimized jointly against the reprojection edges, the
preintegration chain and the bias random-walk edges, in the two-stage
robust LM schedule with a chi2 prune between the stages.

The solver is ``optim/local_ba.py``'s: matrix-free damped normal equations
by block-Jacobi PCG, the visual H-vector products as per-observation
products and segment sums (15-D body blocks, 3-D point blocks); the chain
enters through per-edge 15x30 Jacobians, forward-mode derivatives of the
whitened edge function (one ``torch.func.jvp`` over the edges times the 30
directions). The segment sums add in the JAX package's order on the CPU
(``index_add_``) and in the fixed order of a ``local_ba.SegmentPlan`` on the
card, so two solves give the same bits; with no host read a solve is
captured as one CUDA graph (``inertial.InertialGraph``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import lie
from ..ops.camera import Pinhole, pinhole_project_jac
from ..ops.imu import gravity_like
from ..ops.lie import mat_mul, mat_vec
from .local_ba import SegmentPlan, _segment_sums

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class VIBAProblem(NamedTuple):
    """Padded joint visual-inertial BA problem: K body states, P points, O
    visual observations, E = K-1 chain slots (edge e joins states e and
    e+1). On the card the solve needs ``plan`` (``local_ba.segment_plan``
    of the observations over the K states and P points)."""

    R_wb: torch.Tensor  # (K,3,3)
    p_wb: torch.Tensor  # (K,3)
    v_w: torch.Tensor  # (K,3)
    bg: torch.Tensor  # (K,3)
    ba: torch.Tensor  # (K,3)
    fixed: torch.Tensor  # (K,) bool: anchor / boundary observers
    state_valid: torch.Tensor  # (K,) bool: padding mask
    X: torch.Tensor  # (P,3)
    p_valid: torch.Tensor  # (P,)
    obs_cam: torch.Tensor  # (O,) int32 -> body state
    obs_pt: torch.Tensor  # (O,) int32
    uv: torch.Tensor  # (O,2)
    ur: torch.Tensor  # (O,)
    stereo: torch.Tensor  # (O,)
    valid: torch.Tensor  # (O,)
    inv_sigma2: torch.Tensor  # (O,)
    dts: torch.Tensor  # (E,)
    dR: torch.Tensor  # (E,3,3) deltas at the linearization bias
    dV: torch.Tensor  # (E,3)
    dP: torch.Tensor  # (E,3)
    JRg: torch.Tensor  # (E,3,3)
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    L9: torch.Tensor  # (E,9,9) whitener of the 9-D inertial residual
    Lb: torch.Tensor  # (E,6,6) whitener of the bias walk
    e_valid: torch.Tensor  # (E,)
    plan: Optional[SegmentPlan] = None


class VIBAResult(NamedTuple):
    R_wb: torch.Tensor
    p_wb: torch.Tensor
    v_w: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    X: torch.Tensor
    inlier: torch.Tensor  # (O,)
    chi2: torch.Tensor  # (O,)


def _mT(A):
    return A.transpose(-1, -2)


def _apply_delta(prob: VIBAProblem, d):
    """d: (...,K,15) [phi, dp, dv, dbg, dba] right-perturbation deltas."""
    R = mat_mul(prob.R_wb, lie.so3_exp(d[..., 0:3]))
    return (R, prob.p_wb + d[..., 3:6], prob.v_w + d[..., 6:9],
            prob.bg + d[..., 9:12], prob.ba + d[..., 12:15])


def _visual_residuals(prob: VIBAProblem, R, p, X, cam: Pinhole, bf: float,
                      R_bc, t_bc):
    """e (O,3), J_body (O,3,6) with respect to [phi, dp], J_pt (O,3,3)."""
    oc, op = prob.obs_cam.long(), prob.obs_pt.long()
    Rb = R[oc]  # (O,3,3) body rotations
    pb = p[oc]
    Xw = X[op]
    Xb = mat_vec(_mT(Rb), Xw - pb)  # R_wb^T (Xw - p)
    RbcT = _mT(R_bc)
    Xc = mat_vec(RbcT, Xb - t_bc)  # R_bc^T (Xb - t_bc)
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
    # dXc/dphi = R_bc^T hat(Xb); dXc/dp = -R_bc^T R_wb^T; dXc/dXw = -dXc/dp
    dXc_dphi = mat_mul(RbcT, lie.so3_hat(Xb))
    RcwT = mat_mul(RbcT, _mT(Rb))
    Jb = -(torch.cat([mat_mul(Jall, dXc_dphi), mat_mul(Jall, -RcwT)], -1))
    Jp = -mat_mul(Jall, RcwT)
    return e, Jb, Jp


def _chain_residual(prob: VIBAProblem, di, dj, gravity):
    """Whitened 15-D residuals (...,E,15) of the chain edges (9 inertial +
    6 bias walk) at the deltas di, dj (...,E,15) of each edge's two
    states. The builder folds the linearization bias into dR / dV / dP, so
    the biases here are deltas from it."""
    E = prob.dts.shape[0]
    Ri = mat_mul(prob.R_wb[:E], lie.so3_exp(di[..., 0:3]))
    pi = prob.p_wb[:E] + di[..., 3:6]
    vi = prob.v_w[:E] + di[..., 6:9]
    bgi = prob.bg[:E] + di[..., 9:12]
    bai = prob.ba[:E] + di[..., 12:15]
    Rj = mat_mul(prob.R_wb[1:], lie.so3_exp(dj[..., 0:3]))
    pj = prob.p_wb[1:] + dj[..., 3:6]
    vj = prob.v_w[1:] + dj[..., 6:9]
    bgj = prob.bg[1:] + dj[..., 9:12]
    baj = prob.ba[1:] + dj[..., 12:15]
    t = prob.dts[:, None]
    dR_c = mat_mul(prob.dR, lie.so3_exp(mat_vec(prob.JRg, bgi)))
    dV_c = prob.dV + mat_vec(prob.JVg, bgi) + mat_vec(prob.JVa, bai)
    dP_c = prob.dP + mat_vec(prob.JPg, bgi) + mat_vec(prob.JPa, bai)
    RiT = _mT(Ri)
    e_R = lie.so3_log(mat_mul(_mT(dR_c), mat_mul(RiT, Rj)))
    e_v = mat_vec(RiT, vj - vi - gravity * t) - dV_c
    e_p = mat_vec(RiT, pj - pi - vi * t - 0.5 * gravity * t * t) - dP_c
    r9 = mat_vec(prob.L9, torch.cat([e_R, e_v, e_p], -1))
    r6 = mat_vec(prob.Lb, torch.cat([bgj - bgi, baj - bai], -1))
    return torch.cat([r9, r6], -1) * prob.e_valid[:, None].to(r9.dtype)


def _rows(x, E: int):
    """(E,D) edge rows -> (K,D) at states 0..E-1 (``at[:E]``)."""
    return F.pad(x, (0,) * (2 * x.dim() - 2) + (0, 1))


def _rows_next(x, E: int):
    """(E,D) edge rows -> (K,D) at states 1..E (``at[1:E+1]``)."""
    return F.pad(x, (0,) * (2 * x.dim() - 2) + (1, 0))


@torch.no_grad()
def local_inertial_ba(prob: VIBAProblem, cam: Pinhole, R_bc, t_bc,
                      bf: float = 0.0, gravity=None,
                      stage_iters: Tuple[int, int] = (5, 10),
                      cg_iters: int = 40, trace=None) -> VIBAResult:
    """The two-stage robust LM of LocalInertialBA with the chi2 prune
    between the stages and a PCG inner solver. ``trace``, a list, receives
    each LM iteration's (kept, cost before, cost of the step) as a
    tensor."""
    g = gravity_like(prob.p_wb) if gravity is None else gravity
    # bf: a float, or a 0-d tensor when a captured graph takes it
    bf = bf if torch.is_tensor(bf) else float(bf)
    K = prob.R_wb.shape[0]
    P = prob.X.shape[0]
    E = K - 1
    dtype, dev = prob.R_wb.dtype, prob.R_wb.device
    if prob.plan is None and prob.R_wb.is_cuda:
        raise ValueError("local_inertial_ba on the card needs the problem's "
                         "SegmentPlan (local_ba.segment_plan)")
    oc, op = prob.obs_cam.long(), prob.obs_pt.long()

    def sums(vals_c, vals_p):
        return _segment_sums(vals_c, vals_p, prob.plan, oc, op, K, P)

    ones = torch.ones_like(prob.inv_sigma2)
    row3 = torch.stack([ones, ones, prob.stereo.to(dtype)], -1)
    free_s = (~prob.fixed) & prob.state_valid
    free_f = free_s[:, None].to(dtype)
    valid_p = prob.p_valid[:, None].to(dtype)
    thr = torch.where(prob.stereo, CHI2_STEREO, CHI2_MONO)
    z9 = torch.zeros((K, 9), dtype=dtype, device=dev)

    def vis_chi2(e):
        e2 = e * e
        mono = (e2[..., 0] + e2[..., 1]) * prob.inv_sigma2
        return torch.where(prob.stereo, mono + e2[..., 2] * prob.inv_sigma2,
                           mono)

    def robust_w(chi2):
        return torch.where(chi2 <= thr, 1.0,
                           torch.sqrt(thr / chi2.clamp(min=1e-12)))

    def chain_all(d):
        return _chain_residual(prob, d[:E], d[1:], g)

    def chain_jacs(d):
        """(E,15,30) d r_e / d [d_i; d_j] at the current deltas."""
        dd = torch.cat([d[:E], d[1:]], -1)
        eye = torch.eye(30, dtype=dtype, device=dev)
        _, Jt = torch.func.jvp(
            lambda x: _chain_residual(prob, x[..., :15], x[..., 15:], g),
            (dd[None].expand(30, E, 30).clone(),),
            (eye[:, None, :].expand(30, E, 30),))
        return Jt.permute(1, 2, 0)

    def total_cost(d, X, active, use_huber: bool):
        R, p, *_ = _apply_delta(prob, d)
        e, _, _ = _visual_residuals(prob, R, p, X, cam, bf, R_bc, t_bc)
        c = vis_chi2(e)
        if use_huber:
            c_used = torch.where(
                c <= thr, c, 2.0 * torch.sqrt(thr * c.clamp(min=0.0)) - thr)
        else:
            c_used = c
        vis = torch.where(active, c_used, 0.0).sum()
        rc = chain_all(d)
        return vis + (rc * rc).sum(), c

    def damp(Hb, dim, valid_mask, lam):
        diag = torch.diagonal(Hb, dim1=-2, dim2=-1)
        eye = torch.eye(dim, dtype=dtype, device=dev)
        Hd = Hb + (lam * diag + 1e-6)[..., None] * eye
        return torch.where(valid_mask[:, None, None], Hd, eye)

    def JtV(J, v):
        return (J * v[..., None]).sum(-2)

    def JtJ(J, W):
        return mat_mul(_mT(W), J)

    def lm_stage(d, X, active, n_iters):
        lam = torch.full((), 1e-4, dtype=dtype, device=dev)
        cost0 = total_cost(d, X, active, True)[0] if n_iters else None
        for _ in range(n_iters):
            R, p, *_ = _apply_delta(prob, d)
            e, Jb6, Jp = _visual_residuals(prob, R, p, X, cam, bf, R_bc,
                                           t_bc)
            w = robust_w(vis_chi2(e)) * prob.inv_sigma2 * active
            Wr = w[:, None] * row3
            JbW = Jb6 * Wr[..., None]  # (O,3,6)
            JpW = Jp * Wr[..., None]
            g_s6, g_p = sums(JtV(JbW, e), JtV(JpW, e))
            # the chain (whitened residual: J^T r, J^T J)
            rc = chain_all(d)
            Jc = chain_jacs(d)
            Ji, Jj = Jc[..., :15], Jc[..., 15:]
            g_s = (torch.cat([g_s6, z9], -1)
                   + (_rows(JtV(Ji, rc), E) + _rows_next(JtV(Jj, rc), E)))
            g_s = g_s * free_f
            g_p = g_p * valid_p

            # the block diagonals
            Hss6, Hpp = sums(JtJ(Jb6, JbW), JtJ(Jp, JpW))
            Hss = F.pad(Hss6, (0, 9, 0, 9))
            Hss = Hss + _rows(JtJ(Ji, Ji), E)
            Hss = Hss + _rows_next(JtJ(Jj, Jj), E)
            Ms_inv = torch.linalg.inv_ex(damp(Hss, 15, free_s, lam))[0]
            Mp_inv = torch.linalg.inv_ex(damp(Hpp, 3, prob.p_valid, lam))[0]
            ds = lam * torch.diagonal(Hss, dim1=-2, dim2=-1) + 1e-6
            dp_ = lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-6

            def Hv(vs, vp):
                vs_m = vs * free_f
                vp_m = vp * valid_p
                rv = (mat_vec(Jb6, vs_m[oc, :6]) + mat_vec(Jp, vp_m[op])) * Wr
                hs6, hp = sums(JtV(Jb6, rv), JtV(Jp, rv))
                hs = torch.cat([hs6, z9], -1)
                rce = mat_vec(Ji, vs_m[:E]) + mat_vec(Jj, vs_m[1:])
                hs = hs + _rows(JtV(Ji, rce), E)
                hs = hs + _rows_next(JtV(Jj, rce), E)
                hs = hs + ds * vs
                hp = hp + dp_ * vp
                return hs * free_f, hp * valid_p

            def precond(rs, rp):
                return mat_vec(Ms_inv, rs) * free_f, mat_vec(Mp_inv, rp) * valid_p

            rs, rp = -g_s, -g_p
            zs, zp = precond(rs, rp)
            ps, pp = zs, zp
            rz = (rs * zs).sum() + (rp * zp).sum()
            xs = torch.zeros_like(rs)
            xp = torch.zeros_like(rp)
            for _ in range(cg_iters):
                Aps, App = Hv(ps, pp)
                pAp = (ps * Aps).sum() + (pp * App).sum()
                alpha = rz / torch.where(pAp.abs() < 1e-12, 1e-12, pAp)
                xs = xs + alpha * ps
                xp = xp + alpha * pp
                rs = rs - alpha * Aps
                rp = rp - alpha * App
                zs, zp = precond(rs, rp)
                rz_new = (rs * zs).sum() + (rp * zp).sum()
                beta = rz_new / torch.where(rz.abs() < 1e-12, 1e-12, rz)
                ps = zs + beta * ps
                pp = zp + beta * pp
                rz = rz_new

            d_new = d + xs * free_f
            X_new = torch.where(prob.p_valid[:, None], X + xp, X)
            cost1 = total_cost(d_new, X_new, active, True)[0]
            ok = ((cost1 < cost0) & torch.isfinite(xs).all()
                  & torch.isfinite(xp).all())
            if trace is not None:
                trace.append(torch.stack([ok.to(dtype), cost0, cost1]))
            d = torch.where(ok, d_new, d)
            X = torch.where(ok, X_new, X)
            lam = torch.where(ok, lam * 0.5, lam * 4.0)
            cost0 = torch.where(ok, cost1, cost0)
        return d, X

    d = torch.zeros((K, 15), dtype=dtype, device=dev)
    X = prob.X
    active = prob.valid
    d, X = lm_stage(d, X, active, stage_iters[0])
    _, chi2 = total_cost(d, X, active, False)
    active = active & (chi2 <= thr)
    d, X = lm_stage(d, X, active, stage_iters[1])

    R, p, v, bg, ba = _apply_delta(prob, d)
    _, chi2 = total_cost(d, X, prob.valid, False)
    inlier = prob.valid & (chi2 <= thr)
    return VIBAResult(lie.project_rotation(R), p, v, bg, ba, X, inlier, chi2)


def problem_tensors(prob: VIBAProblem, R_bc, t_bc, gravity, bf) -> tuple:
    """A problem (with its plan) and the frame arguments (bf, a 0-d tensor,
    last) as one flat tuple of tensors: the inputs of a captured solve."""
    return tuple(prob[:-1]) + tuple(prob.plan) + (R_bc, t_bc, gravity, bf)


def solve_flat(*tensors, cam: Pinhole,
               stage_iters: Tuple[int, int] = (5, 10),
               cg_iters: int = 40, trace=None) -> VIBAResult:
    """``local_inertial_ba`` on ``problem_tensors``' tuple (the function an
    ``inertial.InertialGraph`` captures)."""
    n = len(VIBAProblem._fields) - 1
    prob = VIBAProblem(*tensors[:n], plan=SegmentPlan(*tensors[n:n + 3]))
    R_bc, t_bc, gravity, bf = tensors[n + 3:]
    return local_inertial_ba(prob, cam, R_bc, t_bc, bf, gravity,
                             stage_iters=stage_iters, cg_iters=cg_iters,
                             trace=trace)

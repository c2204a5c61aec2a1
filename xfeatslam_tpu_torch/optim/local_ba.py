"""Bundle adjustment: robust Levenberg-Marquardt over cameras and points.

Counterpart of ``xfeatslam_tpu/optim/local_ba.py`` (the role of g2o in
ORB-SLAM3's Optimizer::LocalBundleAdjustment): covisible keyframes and
their map points with fixed boundary keyframes, Huber kernels, the
two-stage schedule (5 iterations, prune chi2 outliers, 10 iterations).

Matrix-free: the damped normal equations (H + lam D) dx = -g are solved by
block-Jacobi preconditioned conjugate gradients, with H-vector products as
per-observation products and segment sums. Every shape is static (padded
and masked).

``bundle_adjust`` dispatches on the device, as ``pose_opt`` does: CUDA
tensors go to the hand-written kernels of ``csrc/local_ba.cu``
(``ops/cuda_kernels.local_ba``: one persistent launch per solve, summing
each camera's and each point's observations in the fixed order of a
``SegmentPlan``, built once per problem on the host), CPU tensors to
``bundle_adjust_plain``. That plain twin is the JAX code written out in
tensor ops: the two ``fori_loop``s become Python loops that never read a
device value on the host (accept or reject, the damping and the CG step
sizes are ``torch.where`` selections and 0-dim tensors), the small
products are broadcast multiply-and-sum (``lie.mat_mul`` / ``mat_vec``),
never ``@``. Its segment sums are ``index_add_`` on the CPU, in the JAX
package's order, and follow the plan on CUDA tensors (``_planned``), where
it runs only as the kernels' reference. Either way a solve gives the same
bits on every run and, with no host sync, is captured as one CUDA graph
(``LocalBAGraph``).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import cuda_kernels as ck
from ..ops import lie
from ..ops.camera import Pinhole, pinhole_project_jac
from ..ops.lie import mat_mul, mat_vec
from .track_step import CapturedCalls, fetch

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


# observation rows per chunk of a camera's segment sum (the BA kernels are
# built for it: kChunk in csrc/local_ba.cu)
SEGMENT_CHUNK = 128


class SegmentPlan(NamedTuple):
    """Where the valid observations of each camera and each point are, for
    sums in a fixed order. A camera's observations (stable-sorted by
    camera) are cut into chunks of ``SEGMENT_CHUNK`` rows; its sum is the
    sum of its chunks' sums. A point's observations (stable-sorted by
    point) fill one row of ``pt_rows``. Index O (the observation count)
    and NCH (the chunk count) stand for an empty entry."""

    cam_rows: torch.Tensor    # (NCH, SEGMENT_CHUNK) observation rows
    cam_chunks: torch.Tensor  # (C, ceil(O / SEGMENT_CHUNK)) chunk rows
    pt_rows: torch.Tensor     # (P, max(C, most observations of a point))


def segment_plan(obs_cam, obs_pt, valid, n_cams: int, n_pts: int,
                 device=None) -> SegmentPlan:
    """The ``SegmentPlan`` of a problem's observations (numpy arrays or
    tensors; tensors are read to the host). Padded observations (``valid``
    false) belong to no segment."""
    obs_cam, obs_pt, valid = (
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in (obs_cam, obs_pt, valid))
    obs_cam, obs_pt = obs_cam.astype(np.int64), obs_pt.astype(np.int64)
    O, L = len(obs_cam), SEGMENT_CHUNK
    rows = np.nonzero(valid)[0]
    n_wide = max(1, -(-O // L))
    n_chunks = n_wide + n_cams  # each camera adds at most one part chunk
    order = rows[np.argsort(obs_cam[rows], kind="stable")]
    counts = np.bincount(obs_cam[order], minlength=n_cams)
    cam_rows = np.full((n_chunks, L), O, np.int64)
    cam_chunks = np.full((n_cams, n_wide), n_chunks, np.int64)
    start = k = 0
    for c in range(n_cams):
        seg = order[start:start + counts[c]]
        start += counts[c]
        for j in range(0, len(seg), L):
            part = seg[j:j + L]
            cam_rows[k, :len(part)] = part
            cam_chunks[c, j // L] = k
            k += 1
    order = rows[np.argsort(obs_pt[rows], kind="stable")]
    pts = obs_pt[order]
    counts = np.bincount(pts, minlength=n_pts)
    width = max(n_cams, int(counts.max()) if len(counts) else 0)
    rank = np.arange(len(order)) - (np.cumsum(counts) - counts)[pts]
    pt_rows = np.full((n_pts, width), O, np.int64)
    pt_rows[pts, rank] = order
    return SegmentPlan(*(torch.from_numpy(a).to(device)
                         for a in (cam_rows, cam_chunks, pt_rows)))


class BAProblem(NamedTuple):
    """Padded bundle-adjustment problem: C cameras, P points, O
    observations (all static). On the card the solve needs ``plan``
    (``segment_plan`` of the observations, built on the host)."""

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
    plan: Optional[SegmentPlan] = None


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


def _planned(t) -> bool:
    """Whether the segment sums follow the plan (tensors on CUDA). On the
    CPU ``index_add_`` adds the rows one after another in observation
    order: deterministic there, and the order of the JAX package's
    ``segment_sum`` on the CPU."""
    return t.is_cuda


def _gather_sum(vals, rows):
    """Row ``i`` of the result sums ``vals[rows[i, 0]]``,
    ``vals[rows[i, 1]]``, ... in a fixed order; index ``len(vals)`` adds
    nothing."""
    pad = vals.new_zeros((1,) + vals.shape[1:])
    return torch.cat([vals, pad])[rows].sum(1)


def _segment_sums(vals_c, vals_p, plan: SegmentPlan, obs_cam, obs_pt,
                  n_cams: int, n_pts: int):
    """Per-camera sums of ``vals_c`` and per-point sums of ``vals_p``. On
    the card a camera sums each of its chunks, then its chunks' sums; a
    point sums its row of ``pt_rows``."""
    if _planned(vals_c):
        return (_gather_sum(_gather_sum(vals_c, plan.cam_rows),
                            plan.cam_chunks),
                _gather_sum(vals_p, plan.pt_rows))
    return (vals_c.new_zeros((n_cams,) + vals_c.shape[1:]).index_add_(
                0, obs_cam, vals_c),
            vals_p.new_zeros((n_pts,) + vals_p.shape[1:]).index_add_(
                0, obs_pt, vals_p))


def _depth(prob: BAProblem, R, t, X):
    return (mat_vec(R[prob.obs_cam.long()], X[prob.obs_pt.long()])
            + t[prob.obs_cam.long()])[..., 2]


@torch.no_grad()
def bundle_adjust(prob: BAProblem, cam: Pinhole, bf: float = 0.0,
                  stage_iters: Tuple[int, int] = (5, 10), cg_iters: int = 40,
                  huber: bool = True) -> BAResult:
    """Run the two-stage robust LM schedule of LocalBundleAdjustment: the
    kernels of ``csrc/local_ba.cu`` on CUDA tensors (``prob.plan``
    required), ``bundle_adjust_plain`` on CPU tensors.

    Returns BAResult with the updated poses and points and the final
    observation inlier classification (chi2 <= 5.991 / 7.815 and positive
    depth, the reference's prune rule)."""
    return BAResult(*ck.local_ba(prob, cam, bf, stage_iters, cg_iters,
                                 huber))


@torch.no_grad()
def bundle_adjust_plain(prob: BAProblem, cam: Pinhole, bf: float = 0.0,
                        stage_iters: Tuple[int, int] = (5, 10),
                        cg_iters: int = 40, huber: bool = True) -> BAResult:
    """``bundle_adjust`` in tensor ops: the kernels' plain twin
    (``ops/cuda_kernels.local_ba_plain``), and the solve on the CPU."""
    n_cams, n_pts = prob.R.shape[0], prob.X.shape[0]
    plan = prob.plan
    if plan is None and _planned(prob.R):
        raise ValueError("bundle_adjust on the card needs the problem's "
                         "SegmentPlan (segment_plan)")
    obs_cam, obs_pt = prob.obs_cam.long(), prob.obs_pt.long()

    def sums(vals_c, vals_p):
        return _segment_sums(vals_c, vals_p, plan, obs_cam, obs_pt, n_cams,
                             n_pts)

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
            g_c, g_p = sums((JcW * e[..., None]).sum(-2),
                            (JpW * e[..., None]).sum(-2))
            g_c, g_p = g_c * free_c, g_p * valid_p
            # block diagonals of H: damping and the preconditioner
            Hcc, Hpp = sums(mat_mul(JcW.transpose(-1, -2), Jc),
                            mat_mul(JpW.transpose(-1, -2), Jp))
            Mc_inv = torch.linalg.inv_ex(damp(Hcc, 6, free_cam, lam))[0]
            Mp_inv = torch.linalg.inv_ex(damp(Hpp, 3, prob.p_valid, lam))[0]
            dc = lam * torch.diagonal(Hcc, dim1=-2, dim2=-1) + 1e-6
            dp = lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-6

            def Hv(vc, vp):
                """(H + lam D) v, matrix-free over the observations."""
                rv = (mat_vec(Jc, vc[obs_cam] * free_c[obs_cam])
                      + mat_vec(Jp, vp[obs_pt] * valid_p[obs_pt])) * Wr
                hc, hp = sums((Jc * rv[..., None]).sum(-2),
                              (Jp * rv[..., None]).sum(-2))
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


def _problem_tensors(prob: BAProblem) -> tuple:
    return tuple(prob[:-1]) + tuple(prob.plan)


def _problem_of(tensors) -> BAProblem:
    n = len(BAProblem._fields) - 1
    return BAProblem(*tensors[:n], plan=SegmentPlan(*tensors[n:]))


class LocalBAGraph(CapturedCalls):
    """``bundle_adjust`` captured and replayed (``track_step.CapturedCalls``):
    the counterpart of the JAX package's one jitted solve.

    A solve is one cooperative launch
    (``cuda_kernels.local_ba_launches``); the graph saves the host its
    wrapper's checks and allocations. The graph's key holds, besides
    each tensor's shape and dtype (the plan's too, which is an input, so
    one graph serves every problem of a bucket), the camera, bf,
    ``stage_iters``, ``cg_iters`` and ``huber``. The segment sums add in a
    fixed order, so a replay gives the eager solve's bits. Returns the
    graph's static ``BAResult``."""

    def __init__(self, device):
        super().__init__(device, "bundle_adjust")

    def __call__(self, prob: BAProblem, cam: Pinhole, bf: float = 0.0,
                 stage_iters: Tuple[int, int] = (5, 10), cg_iters: int = 40,
                 huber: bool = True) -> BAResult:
        if prob.plan is None:
            raise ValueError("LocalBAGraph needs the problem's SegmentPlan "
                             "(segment_plan)")
        static = (tuple(float(c) for c in cam), float(bf),
                  tuple(int(s) for s in stage_iters), int(cg_iters),
                  bool(huber))

        def run(*inputs):
            return bundle_adjust(_problem_of(inputs), cam, static[1],
                                 stage_iters=static[2], cg_iters=static[3],
                                 huber=static[4])

        return self.replay(static, _problem_tensors(prob), run)


def timed_solve(graph: Optional[LocalBAGraph], prob: BAProblem, cam: Pinhole,
                bf: float, stage_iters: Tuple[int, int], log: list,
                stage: str) -> BAResult:
    """One BA solve read to the host (a numpy ``BAResult``): the replay of
    ``graph`` on the card, the eager solve without one (on the CPU).
    Appends (stage, host seconds, whether the call captured a graph) to
    ``log``."""
    n = len(graph.capture_seconds) if graph is not None else 0
    t0 = time.perf_counter()
    res = fetch((graph or bundle_adjust)(prob, cam, bf,
                                         stage_iters=stage_iters))
    captured = graph is not None and len(graph.capture_seconds) > n
    log.append((stage, time.perf_counter() - t0, captured))
    return res

"""Sim3 pose-graph (essential graph) optimization.

Counterpart of ``xfeatslam_tpu/optim/pose_graph.py`` (the role of
ORB-SLAM3's Optimizer::OptimizeEssentialGraph): after a loop correction,
optimize every keyframe's Sim3 pose over the essential graph (spanning
tree, loop edges, strong covisibility edges) with per-edge residuals
r = log_sim3(S_meas_ji * S_i * S_j^-1). The edge Jacobians are forward-mode
derivatives (one ``torch.func.jvp`` over the edges times the 7 tangent
directions, the JAX package's ``jax.vmap(jax.jacfwd(...))``); the normal
equations are solved matrix-free by block-Jacobi preconditioned conjugate
gradients.

The sums over each vertex's edges follow a fixed order (``_vertex_rows``:
each vertex's edge ends gathered into one padded row, built on the host per
problem), on the CPU and on the card alike: a scatter-add would add in the
order its atomics land on the card. The small products are broadcast
multiply-and-sum, never ``@``.

``mode="4dof"`` is the inertial essential graph
(OptimizeEssentialGraph4DoF): SE3 edges weighted as the reference's
matLambda, and vertices that move only in yaw about the gravity-aligned
world z and in translation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import lie
from ..ops.lie import mat_vec


class PoseGraphProblem(NamedTuple):
    s: torch.Tensor  # (C,)
    R: torch.Tensor  # (C,3,3) world->camera Sim3
    t: torch.Tensor  # (C,3)
    fixed: torch.Tensor  # (C,) bool
    cam_valid: torch.Tensor  # (C,)
    edge_i: torch.Tensor  # (E,) int32
    edge_j: torch.Tensor  # (E,)
    # measurement m = S_j * S_i^{-1} (g2o's EdgeSim3 convention: the
    # residual log(m * S_i * S_j^{-1}) vanishes when consistent; m maps
    # vertex-i camera coords into vertex-j camera coords)
    m_s: torch.Tensor  # (E,)
    m_R: torch.Tensor  # (E,3,3)
    m_t: torch.Tensor  # (E,3)
    e_valid: torch.Tensor  # (E,) bool


def _edge_residual(si, Ri, ti, sj, Rj, tj, ms, mR, mt):
    """r = log(S_ji * S_i * S_j^{-1}) (...,7)."""
    inv_s, inv_R, inv_t = lie.sim3_inverse(sj, Rj, tj)
    cs, cR, ct = lie.sim3_compose(si, Ri, ti, inv_s, inv_R, inv_t)
    es, eR, et = lie.sim3_compose(ms, mR, mt, cs, cR, ct)
    return lie.sim3_log(es, eR, et)


def _apply(s, R, t, d):
    """Left update S <- exp(d) S."""
    ds, dR, dt = lie.sim3_exp(d)
    return lie.sim3_compose(ds, dR, dt, s, R, t)


# sqrt information of 4-DoF edges: the reference weights the two
# gravity-constrained rotation axes 1e3 (matLambda)
_W4 = (31.622776, 31.622776, 1.0, 1.0, 1.0, 1.0)


def _edge_residual_4dof(si, Ri, ti, sj, Rj, tj, ms, mR, mt):
    """The SE3 edge residual in this module's m = T_j T_i^-1 convention:
    E = m T_i T_j^-1, r = [log_so3(E_R); E_t] (the Edge4DoF error), whitened
    by matLambda. The scales are ignored (SE3). (...,6)."""
    Rij = lie.mat_mul(Ri, Rj.transpose(-1, -2))  # T_i T_j^-1
    tij = ti - mat_vec(Rij, tj)
    eR = lie.so3_log(lie.mat_mul(mR, Rij))
    et = mt + mat_vec(mR, tij)
    w = torch.tensor(_W4, dtype=eR.dtype).to(eR.device)
    return torch.cat([eR, et], -1) * w


def _apply_4dof(s, R, t, d):
    """The 4-D world-frame update [dyaw, dt]: yaw about the gravity-aligned
    world +z only (roll and pitch pinned by the IMU) and a world
    translation (VertexPose4DoF::oplusImpl). The scale stays."""
    zero = torch.zeros_like(d[..., 0])
    dR = lie.so3_exp(torch.stack([zero, zero, d[..., 0]], -1))
    R_wc = R.transpose(-1, -2)
    C = -mat_vec(R_wc, t)
    R2 = lie.mat_mul(dR, R_wc).transpose(-1, -2)
    return s, R2, -mat_vec(R2, C + d[..., 1:4])


def _vertex_rows(edge_i, edge_j, n_vertices: int, device):
    """(C, D) rows into the 2E edge ends [i-ends, j-ends], each vertex's
    ends in edge order, padded with 2E (a zero row)."""
    ends = np.concatenate([np.asarray(edge_i), np.asarray(edge_j)])
    order = np.argsort(ends, kind="stable")
    counts = np.bincount(ends, minlength=n_vertices)
    width = max(1, int(counts.max()) if len(counts) else 1)
    rank = np.arange(len(order)) - (np.cumsum(counts) - counts)[ends[order]]
    rows = np.full((n_vertices, width), len(ends), np.int64)
    rows[ends[order], rank] = order
    return torch.from_numpy(rows).to(device)


@torch.no_grad()
def optimize_pose_graph(prob: PoseGraphProblem, iters: int = 20,
                        cg_iters: int = 50, mode: str = "sim3"):
    """LM over all free vertices. Returns the optimized (s, R, t).

    mode="sim3": 7-dof Sim3 vertices (OptimizeEssentialGraph).
    mode="4dof": yaw and translation vertices with the scale, roll and
    pitch frozen, the inertial essential graph (gravity has pinned roll
    and pitch, the IMU the scale)."""
    if mode not in ("sim3", "4dof"):
        raise ValueError(f"pose graph mode {mode!r}: 'sim3' or '4dof'")
    C = prob.s.shape[0]
    D = 7 if mode == "sim3" else 4
    edge_res = _edge_residual if mode == "sim3" else _edge_residual_4dof
    apply_one = _apply if mode == "sim3" else _apply_4dof
    dtype, dev = prob.R.dtype, prob.R.device
    free = (~prob.fixed) & prob.cam_valid
    free_f = free[:, None].to(dtype)
    ei, ej = prob.edge_i.long(), prob.edge_j.long()
    rows = _vertex_rows(prob.edge_i.cpu().numpy().astype(np.int64),
                        prob.edge_j.cpu().numpy().astype(np.int64), C, dev)
    w_e = prob.e_valid.to(dtype)
    eyeD = torch.eye(D, dtype=dtype, device=dev)

    def vertex_sums(vals_i, vals_j):
        """sum over each vertex's edge ends, in a fixed order."""
        ends = torch.cat([vals_i, vals_j,
                          vals_i.new_zeros((1,) + vals_i.shape[1:])])
        return ends[rows].sum(1)

    def residuals(s, R, t):
        return edge_res(s[ei], R[ei], t[ei], s[ej], R[ej], t[ej],
                              prob.m_s, prob.m_R, prob.m_t)

    def apply_delta(s, R, t, dx):
        """dx: (C,D) tangent, applied on the free vertices."""
        s2, R2, t2 = apply_one(s, R, t, dx)
        return (torch.where(free, s2, s),
                torch.where(free[:, None, None], R2, R),
                torch.where(free[:, None], t2, t))

    def edge_jacobians(s, R, t):
        """J_i, J_j: (E,RD,D) with respect to the delta of vertex i / j: one
        forward-mode product over the edges times the D tangent directions
        (a batch, not a vmap: on 0-dim tensors torch's forward mode
        promotes some tangents to float64)."""
        def rows(x):  # (E,...) -> (E,D,...), one row per direction
            return x[:, None].expand((x.shape[0], D) + x.shape[1:])

        si, Ri, ti, sj, Rj, tj, ms, mR, mt = map(rows, (
            s[ei], R[ei], t[ei], s[ej], R[ej], t[ej], prob.m_s, prob.m_R,
            prob.m_t))
        dz = torch.zeros((ei.shape[0], D, D), dtype=dtype, device=dev)
        dirs = eyeD.expand_as(dz)

        def jac(fn):
            return torch.func.jvp(fn, (dz,), (dirs,))[1].transpose(-1, -2)

        Ji = jac(lambda d: edge_res(*apply_one(si, Ri, ti, d), sj, Rj, tj,
                                    ms, mR, mt))
        Jj = jac(lambda d: edge_res(si, Ri, ti, *apply_one(sj, Rj, tj, d),
                                    ms, mR, mt))
        return Ji, Jj

    def total_cost(s, R, t):
        r = residuals(s, R, t)
        return (w_e * (r * r).sum(-1)).sum()

    def JtV(J, v):
        """J^T v per edge: (E,RD,D), (E,RD) -> (E,D)."""
        return (J * v[..., None]).sum(-2)

    s, R, t = prob.s, prob.R, prob.t
    lam = torch.full((), 1e-4, dtype=dtype, device=dev)
    for _ in range(iters):
        r = residuals(s, R, t)  # (E,7)
        Ji, Jj = edge_jacobians(s, R, t)  # (E,7,7)
        Jiw = Ji * w_e[:, None, None]
        Jjw = Jj * w_e[:, None, None]
        g = -vertex_sums(JtV(Jiw, r), JtV(Jjw, r)) * free_f
        Hii = vertex_sums((Jiw[..., :, None] * Ji[..., None, :]).sum(1),
                          (Jjw[..., :, None] * Jj[..., None, :]).sum(1))
        diag = torch.diagonal(Hii, dim1=-2, dim2=-1)
        dd = lam * diag + 1e-6
        Hd = Hii + dd[..., None] * eyeD
        Hd = torch.where(free[:, None, None], Hd, eyeD)
        M_inv = torch.linalg.inv_ex(Hd)[0]

        def Hv(v):
            rv = (mat_vec(Ji, v[ei]) + mat_vec(Jj, v[ej])) * w_e[:, None]
            hv = vertex_sums(JtV(Ji, rv), JtV(Jj, rv))
            return (hv + dd * v) * free_f

        def precond(r_):
            return mat_vec(M_inv, r_) * free_f

        x = torch.zeros((C, D), dtype=dtype, device=dev)
        rr = g
        z = precond(g)
        p = z
        rz = (g * z).sum()
        for _ in range(cg_iters):
            Ap = Hv(p)
            pAp = (p * Ap).sum()
            alpha = rz / torch.where(pAp.abs() < 1e-12, 1e-12, pAp)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz2 = (rr * z).sum()
            beta = rz2 / torch.where(rz.abs() < 1e-12, 1e-12, rz)
            p = z + beta * p
            rz = rz2

        s2, R2, t2 = apply_delta(s, R, t, x)
        c0 = total_cost(s, R, t)
        c1 = total_cost(s2, R2, t2)
        ok = (c1 < c0) & torch.isfinite(x).all()
        s = torch.where(ok, s2, s)
        R = torch.where(ok, R2, R)
        t = torch.where(ok, t2, t)
        lam = torch.where(ok, lam * 0.5, lam * 4.0)
    return s, R, t

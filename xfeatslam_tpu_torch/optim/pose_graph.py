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

Only the 7-dof Sim3 mode is ported; the inertial 4-dof mode
(OptimizeEssentialGraph4DoF) waits for ROADMAP item 15.
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

    mode="sim3": 7-dof Sim3 vertices (OptimizeEssentialGraph). The "4dof"
    mode of the JAX package (yaw and translation, the inertial essential
    graph) is not ported."""
    if mode != "sim3":
        raise NotImplementedError(
            f"pose graph mode {mode!r}: the inertial 4-DoF essential graph "
            "waits for ROADMAP item 15")
    C = prob.s.shape[0]
    D = 7
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
        return _edge_residual(s[ei], R[ei], t[ei], s[ej], R[ej], t[ej],
                              prob.m_s, prob.m_R, prob.m_t)

    def apply_delta(s, R, t, dx):
        """dx: (C,D) tangent, applied on the free vertices."""
        s2, R2, t2 = _apply(s, R, t, dx)
        return (torch.where(free, s2, s),
                torch.where(free[:, None, None], R2, R),
                torch.where(free[:, None], t2, t))

    def edge_jacobians(s, R, t):
        """J_i, J_j: (E,7,D) with respect to the delta of vertex i / j: one
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

        Ji = jac(lambda d: _edge_residual(*_apply(si, Ri, ti, d), sj, Rj, tj,
                                          ms, mR, mt))
        Jj = jac(lambda d: _edge_residual(si, Ri, ti, *_apply(sj, Rj, tj, d),
                                          ms, mR, mt))
        return Ji, Jj

    def total_cost(s, R, t):
        r = residuals(s, R, t)
        return (w_e * (r * r).sum(-1)).sum()

    def JtV(J, v):
        """J^T v per edge: (E,7,D), (E,7) -> (E,D)."""
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

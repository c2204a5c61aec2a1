"""SO3 / SE3 Lie-group operations on tensors.

Counterpart of ``xfeatslam_tpu/ops/lie.py``. Conventions, as there:
  * rotations are 3x3 matrices; an SE3 element is the pair (R, t) with
    x_out = R @ x + t, a Sim3 element the triple (s, R, t) with
    x_out = s R @ x + t;
  * se3 tangent vectors are [rho(3), phi(3)] (translation first), sim3
    ones [rho(3), phi(3), sigma(1)] with s = exp(sigma);
  * every function broadcasts over leading batch dimensions, and the
    small-angle branches are selected with ``torch.where`` (no host sync).

The 3x3 products are written as broadcast multiply-and-sum (``mat_mul``,
``mat_vec``), never as ``@``: a float32 matmul on the GPU runs in TF32
(about three decimal digits) when ``torch.backends.cuda.matmul.allow_tf32``
is set, and geometry must not, whatever the caller's flags. The JAX package
gets the same guarantee from its global ``highest`` matmul precision.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def mat_mul(a, b):
    """a (...,n,k) @ b (...,k,m) in full float32, elementwise (no TF32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def mat_vec(A, x):
    """A (...,n,k) @ x (...,k) in full float32, elementwise (no TF32)."""
    return (A * x[..., None, :]).sum(-1)


def _eye_like(x, shape):
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(shape)


def _safe_div(num, den, eps=_EPS):
    """num/den with den clamped away from zero (sign-preserving)."""
    signed = torch.where(den < 0, -eps, eps)
    return num / torch.where(den.abs() < eps, signed, den)


# ---------------------------------------------------------------------------
# SO3


def so3_hat(phi):
    """(...,3) -> (...,3,3) skew-symmetric matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def so3_vee(Phi):
    """(...,3,3) skew matrix -> (...,3)."""
    return torch.stack([Phi[..., 2, 1], Phi[..., 0, 2], Phi[..., 1, 0]], -1)


def so3_exp(phi):
    """Rodrigues formula with a Taylor branch near zero. (...,3) ->
    (...,3,3)."""
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    Phi = so3_hat(phi)
    return (_eye_like(phi, Phi.shape) + a[..., None, None] * Phi
            + b[..., None, None] * mat_mul(Phi, Phi))


def rotation_to_quaternion(R):
    """(...,3,3) -> unit quaternion (w,x,y,z) with w >= 0, by a branchless
    Shepperd extraction: all four candidates, the best-conditioned one
    selected."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    t0 = 1.0 + r00 + r11 + r22  # 4w^2
    t1 = 1.0 + r00 - r11 - r22  # 4x^2
    t2 = 1.0 - r00 + r11 - r22  # 4y^2
    t3 = 1.0 - r00 - r11 + r22  # 4z^2

    def s_of(t):
        return torch.sqrt(t.clamp(min=_EPS)) * 2.0

    s0, s1, s2, s3 = s_of(t0), s_of(t1), s_of(t2), s_of(t3)
    cands = torch.stack([
        torch.stack([0.25 * s0, (r21 - r12) / s0, (r02 - r20) / s0,
                     (r10 - r01) / s0], -1),
        torch.stack([(r21 - r12) / s1, 0.25 * s1, (r01 + r10) / s1,
                     (r02 + r20) / s1], -1),
        torch.stack([(r02 - r20) / s2, (r01 + r10) / s2, 0.25 * s2,
                     (r12 + r21) / s2], -1),
        torch.stack([(r10 - r01) / s3, (r02 + r20) / s3, (r12 + r21) / s3,
                     0.25 * s3], -1),
    ], -2)  # (...,4,4)
    best = torch.stack([t0, t1, t2, t3], -1).argmax(-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 4))[..., 0, :]
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quaternion_to_rotation(q):
    """Unit quaternion (w,x,y,z) (...,4) -> (...,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                        2 * (x * z + w * y)], -1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - w * x)], -1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                        1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], -2)


def so3_log(R):
    """Matrix log of SO3 via the quaternion, theta = 2 atan2(|v|, w), exact
    for all angles. (...,3,3) -> (...,3)."""
    q = rotation_to_quaternion(R)
    w = q[..., 0]
    v = q[..., 1:]
    nv2 = (v * v).sum(-1)
    small = nv2 < 1e-12
    nv_safe = torch.sqrt(torch.where(small, 1.0, nv2))
    theta = 2.0 * torch.atan2(torch.where(small, 0.0, nv_safe), w)
    # small |v|: theta/|v| ~ 2/w * (1 - |v|^2/(3 w^2))
    scale = torch.where(
        small,
        2.0 / w.clamp(min=0.5) * (1.0 - nv2 / (3.0 * (w * w).clamp(min=0.25))),
        theta / nv_safe)
    return scale[..., None] * v


def so3_left_jacobian(phi):
    """Left Jacobian of SO3, J_l = I + b Phi + c Phi^2 with
    b = (1-cos)/t^2, c = (t-sin)/t^3 (the SE3 'V' matrix). (...,3) ->
    (...,3,3)."""
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    Phi = so3_hat(phi)
    return (_eye_like(phi, Phi.shape) + b[..., None, None] * Phi
            + c[..., None, None] * mat_mul(Phi, Phi))


def so3_left_jacobian_inv(phi):
    """Inverse of the SO3 left Jacobian. (...,3) -> (...,3,3)."""
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    half = 0.5 * theta
    cot = _safe_div(torch.cos(half), torch.sin(half))
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    _safe_div(1.0 - 0.5 * theta * cot, theta2))
    Phi = so3_hat(phi)
    return (_eye_like(phi, Phi.shape) - 0.5 * Phi
            + c[..., None, None] * mat_mul(Phi, Phi))


# ---------------------------------------------------------------------------
# SE3


def se3_exp(xi):
    """se3 tangent [rho, phi] (...,6) -> (R (...,3,3), t (...,3))."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    return so3_exp(phi), mat_vec(so3_left_jacobian(phi), rho)


def se3_log(R, t):
    """(R, t) -> tangent [rho, phi] (...,6)."""
    phi = so3_log(R)
    return torch.cat([mat_vec(so3_left_jacobian_inv(phi), t), phi], -1)


def se3_compose(Ra, ta, Rb, tb):
    """(a o b): first apply b, then a."""
    return mat_mul(Ra, Rb), mat_vec(Ra, tb) + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -mat_vec(Rt, t)


def se3_apply(R, t, x):
    """Transform points x (...,3). Broadcasts (R,t) against x."""
    return mat_vec(R, x) + t


def se3_matrix(R, t):
    """(R,t) -> homogeneous (...,4,4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def normalize_rotation(R):
    """Project a near-rotation matrix to SO3 via SVD, fixing a reflection."""
    u, _, vt = torch.linalg.svd(R)
    Rn = mat_mul(u, vt)
    det = torch.linalg.det(Rn)
    u_fixed = torch.cat([u[..., :, :2], u[..., :, 2:] * torch.sign(det)[
        ..., None, None]], -1)
    return torch.where(det[..., None, None] > 0, Rn, mat_mul(u_fixed, vt))


def project_rotation(R, iters: int = 4):
    """``normalize_rotation`` for near-rotations without an SVD: Newton's
    polar iteration X <- (X + X^-T) / 2, with X^-T as the cofactor matrix
    (rows' cross products) over the determinant. It converges to the
    polar factor U V^T, the SVD projection, quadratically; a CUDA SVD
    synchronizes with the host, and this can be captured in a CUDA graph."""
    for _ in range(iters):
        r0, r1, r2 = R[..., 0, :], R[..., 1, :], R[..., 2, :]
        cof = torch.stack([torch.linalg.cross(r1, r2),
                           torch.linalg.cross(r2, r0),
                           torch.linalg.cross(r0, r1)], -2)
        det = (r0 * cof[..., 0, :]).sum(-1)
        R = 0.5 * (R + cof / det[..., None, None])
    return R


def np_normalize_rotation(R):
    """Host-side (numpy, float64) SO3 projection, for rotations written at
    the tracking and map boundaries: float32 rotation chains lose
    orthonormality multiplicatively through the motion-model loop."""
    u, _, vt = np.linalg.svd(np.asarray(R, np.float64))
    Rn = u @ vt
    if np.linalg.det(Rn) < 0:
        u[..., :, 2] *= -1.0
        Rn = u @ vt
    return Rn.astype(np.float32)


# ---------------------------------------------------------------------------
# Sim3


def _sim3_W(phi, sigma):
    """The Sim3 'W' matrix: t = W @ rho for exp([rho, phi, sigma]).

    W = C*I + (A/theta)*Phi + (Bc/theta^2)*Phi^2 where
      C  = int_0^1 e^{sigma u} du
      A  = int_0^1 e^{sigma u} sin(theta u) du
      Bc = int_0^1 e^{sigma u} (1 - cos(theta u)) du
    in closed form, with Taylor branches for small sigma and theta."""
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    s = torch.exp(sigma)
    sigma2 = sigma * sigma
    small_sigma = sigma.abs() < 1e-4
    small_theta = theta2 < 1e-8

    C = torch.where(small_sigma, 1.0 + 0.5 * sigma + sigma2 / 6.0,
                    _safe_div(s - 1.0, sigma))
    denom = sigma2 + theta2
    # closed forms (valid when denom > 0)
    A_cf = _safe_div(s * (sigma * torch.sin(theta) - theta * torch.cos(theta))
                     + theta, denom)
    D_cf = _safe_div(s * (sigma * torch.cos(theta) + theta * torch.sin(theta))
                     - sigma, denom)
    Bc_cf = C - D_cf
    # Taylor in theta, any sigma: A ~ theta E1, Bc ~ theta^2/2 E2 with
    # E1 = int e^{su} u du, E2 = int e^{su} u^2 du
    E1 = torch.where(small_sigma, 0.5 + sigma / 3.0 + sigma2 / 8.0,
                     _safe_div(s * (sigma - 1.0) + 1.0, sigma2))
    E2 = torch.where(small_sigma, 1.0 / 3.0 + sigma / 4.0 + sigma2 / 10.0,
                     _safe_div(s * (sigma2 - 2.0 * sigma + 2.0) - 2.0,
                               sigma2 * sigma))
    A = torch.where(small_theta, theta * E1, A_cf)
    Bc = torch.where(small_theta, 0.5 * theta2 * E2, Bc_cf)
    # the exact small-theta limits of the coefficients
    coef1 = torch.where(small_theta, E1, _safe_div(A, theta))
    coef2 = torch.where(small_theta, 0.5 * E2, _safe_div(Bc, theta2))
    Phi = so3_hat(phi)
    return (C[..., None, None] * _eye_like(phi, Phi.shape)
            + coef1[..., None, None] * Phi
            + coef2[..., None, None] * mat_mul(Phi, Phi))


def sim3_exp(xi):
    """sim3 tangent [rho(3), phi(3), sigma(1)] (...,7) -> (s, R, t)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return (torch.exp(sigma), so3_exp(phi),
            mat_vec(_sim3_W(phi, sigma), rho))


def sim3_log(s, R, t):
    """(s, R, t) -> tangent (...,7); rho solves W rho = t."""
    sigma = torch.log(s)
    phi = so3_log(R)
    W = _sim3_W(phi, sigma)
    rho = torch.linalg.solve(W, t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], -1)


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    """(a o b): x -> sa Ra (sb Rb x + tb) + ta."""
    return sa * sb, mat_mul(Ra, Rb), sa[..., None] * mat_vec(Ra, tb) + ta


def sim3_inverse(s, R, t):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return s_inv, Rt, -s_inv[..., None] * mat_vec(Rt, t)


def sim3_apply(s, R, t, x):
    return s[..., None] * mat_vec(R, x) + t

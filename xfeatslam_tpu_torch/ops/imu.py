"""IMU preintegration (Forster style) on tensors.

Counterpart of ``xfeatslam_tpu/ops/imu.py`` (the role of ORB-SLAM3's
ImuTypes.cc): ``Preintegrated`` holds the dR / dV / dP deltas between two
states, the 15x15 covariance [rot, vel, pos, bg, ba] and the five bias
Jacobians, at a linearization bias. ``preintegrate`` folds a padded window
of samples in as the JAX package's ``lax.scan`` does: a Python loop over the
window whose masked steps keep the state (``torch.where``, no host read),
in float32 and in JAX's operation order. ``preintegrate_segment`` pads a
host window to JAX's power-of-two buckets (8, 16, 32, ...), so the device
sees one static shape per bucket; on the card it replays one CUDA graph per
bucket (an ``optim/inertial.InertialGraph`` of ``preintegrate``).

The small products are broadcast multiply-and-sum (``lie.mat_mul`` /
``mat_vec``), never ``@`` (see ``ops/lie``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..optim.track_step import fetch
from . import lie
from .lie import mat_mul, mat_vec

GRAVITY = (0.0, 0.0, -9.81)


def constant(values, like):
    """A small constant vector on ``like``'s device, written by fill kernels
    (no host-to-device copy, which a CUDA-graph capture does not allow)."""
    return torch.cat([torch.full((1,), float(v), dtype=like.dtype,
                                 device=like.device) for v in values])


def gravity_like(x):
    """The world gravity (0, 0, -9.81) as a tensor on ``x``'s device."""
    return constant(GRAVITY, x)


class ImuCalib(NamedTuple):
    """Noise densities (continuous), bias random walks and the body<-camera
    extrinsic (ImuTypes.h Calib)."""

    noise_gyro: float = 1.7e-4
    noise_acc: float = 2.0e-3
    walk_gyro: float = 1.9e-5
    walk_acc: float = 3.0e-3
    R_bc: np.ndarray = None  # body<-camera
    t_bc: np.ndarray = None


class Preintegrated(NamedTuple):
    """Deltas over [t_i, t_j] at the linearization bias (bg, ba): tensors,
    or numpy arrays on the host side of the tracker and the mapper."""

    dt: object  # () total time
    dR: object  # (3,3)
    dV: object  # (3,)
    dP: object  # (3,)
    cov: object  # (15,15) [rot, vel, pos, bg, ba]
    JRg: object  # (3,3) d dR / d bg
    JVg: object
    JVa: object
    JPg: object
    JPa: object
    bg: object  # (3,) linearization gyro bias
    ba: object  # (3,) linearization acc bias


def to_tensors(pre: Preintegrated, device) -> Preintegrated:
    """A host ``Preintegrated`` as float32 tensors on ``device``."""
    return Preintegrated(*(torch.as_tensor(np.asarray(f, np.float32)).to(device)
                           for f in pre))


def to_numpy(pre: Preintegrated) -> Preintegrated:
    return Preintegrated(*(np.asarray(f.detach().cpu().numpy()
                                      if isinstance(f, torch.Tensor) else f)
                           for f in pre))


def _right_jacobian(phi):
    """Right Jacobian of SO3 (RightJacobianSO3)."""
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + 1e-20)
    Phi = lie.so3_hat(phi)
    Phi2 = mat_mul(Phi, Phi)
    small = theta2 < 1e-8
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1 - torch.cos(theta)) / theta2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye - a[..., None, None] * Phi + b[..., None, None] * Phi2


def _mT(A):
    return A.transpose(-1, -2)


@torch.no_grad()
def preintegrate(acc, gyro, dts, valid, bg, ba,
                 noise_gyro: float = 1.7e-4, noise_acc: float = 2.0e-3,
                 walk_gyro: float = 1.9e-5, walk_acc: float = 3.0e-3):
    """Integrate a padded window of IMU samples (IntegrateNewMeasurement).

    acc, gyro: (N,3); dts: (N,) per-sample intervals; valid: (N,) bool
    (padding); bg, ba: (3,) linearization biases. Returns Preintegrated
    with the full 15x15 covariance: the 9x9 block propagated through the
    A/B system and the bias block accumulating the random walk."""
    dtype, dev = acc.dtype, acc.device
    ng2, na2 = noise_gyro * noise_gyro, noise_acc * noise_acc
    wg2, wa2 = walk_gyro * walk_gyro, walk_acc * walk_acc
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    n_ga = constant([ng2, ng2, ng2, na2, na2, na2], acc)
    walk_d = constant([wg2, wg2, wg2, wa2, wa2, wa2], acc)
    z33 = torch.zeros((3, 3), dtype=dtype, device=dev)
    dR = eye3
    dV = torch.zeros(3, dtype=dtype, device=dev)
    dP = torch.zeros(3, dtype=dtype, device=dev)
    cov = torch.zeros((15, 15), dtype=dtype, device=dev)
    JRg = JVg = JVa = JPg = JPa = z33
    T = torch.zeros((), dtype=dtype, device=dev)
    for i in range(acc.shape[0]):
        v = valid[i]
        dt = torch.where(v, dts[i], 0.0)
        a_c = acc[i] - ba
        w_c = gyro[i] - bg

        # position and velocity with the current rotation
        acc_w = mat_vec(dR, a_c)
        dP_new = dP + dV * dt + 0.5 * acc_w * dt * dt
        dV_new = dV + acc_w * dt

        # covariance propagation: the A / B blocks
        a_hat = lie.so3_hat(a_c)
        phi = w_c * dt
        dRi = lie.so3_exp(phi)
        Jr = _right_jacobian(phi)
        dRa = mat_mul(dR, a_hat)
        A = torch.cat([
            torch.cat([_mT(dRi), z33, z33], 1),
            torch.cat([-dRa * dt, eye3, z33], 1),
            torch.cat([-0.5 * dRa * dt * dt, eye3 * dt, eye3], 1)], 0)
        B = torch.cat([
            torch.cat([Jr * dt, z33], 1),
            torch.cat([z33, dR * dt], 1),
            torch.cat([z33, 0.5 * dR * dt * dt], 1)], 0)
        Nga = torch.diag(n_ga) / torch.clamp(dt, min=1e-6)
        c9 = (mat_mul(mat_mul(A, cov[:9, :9]), _mT(A))
              + mat_mul(mat_mul(B, Nga), _mT(B)))
        # the bias random walk accumulates in the (9:15, 9:15) block
        walk = torch.diag(walk_d) * torch.clamp(dt, min=0.0)
        cov_new = torch.cat([
            torch.cat([c9, cov[:9, 9:]], 1),
            torch.cat([cov[9:, :9], cov[9:, 9:] + walk], 1)], 0)

        # the bias Jacobians
        dRaJ = mat_mul(dRa, JRg)
        JPa_new = JPa + JVa * dt - 0.5 * dR * dt * dt
        JPg_new = JPg + JVg * dt - 0.5 * dRaJ * dt * dt
        JVa_new = JVa - dR * dt
        JVg_new = JVg - dRaJ * dt
        JRg_new = mat_mul(_mT(dRi), JRg) - Jr * dt
        dR_new = mat_mul(dR, dRi)

        dR = torch.where(v, dR_new, dR)
        dV = torch.where(v, dV_new, dV)
        dP = torch.where(v, dP_new, dP)
        cov = torch.where(v, cov_new, cov)
        JRg = torch.where(v, JRg_new, JRg)
        JVg = torch.where(v, JVg_new, JVg)
        JVa = torch.where(v, JVa_new, JVa)
        JPg = torch.where(v, JPg_new, JPg)
        JPa = torch.where(v, JPa_new, JPa)
        T = torch.where(v, T + dt, T)
    dR = lie.project_rotation(dR)
    return Preintegrated(T, dR, dV, dP, cov, JRg, JVg, JVa, JPg, JPa, bg, ba)


def _bucket(n: int) -> int:
    """JAX's window bucket: 8, 16, 32, ... (one shape per bucket)."""
    bucket = 8
    while bucket < n:
        bucket *= 2
    return bucket


def _noise_kw(calib: Optional[ImuCalib]) -> dict:
    if calib is None:
        return {}
    return dict(noise_gyro=float(calib.noise_gyro),
                noise_acc=float(calib.noise_acc),
                walk_gyro=float(calib.walk_gyro),
                walk_acc=float(calib.walk_acc))


def preintegrate_segment(acc, gyro, dts, bg, ba, calib: ImuCalib = None,
                         device=None, graph=None) -> Preintegrated:
    """Preintegrate a variable-length host window: pad it to a power-of-two
    bucket and integrate it on ``device`` (CUDA unless given); on the card
    through ``graph`` (an ``InertialGraph`` of ``preintegrate``) when one is
    passed. Returns a Preintegrated of numpy arrays."""
    from .. import resolve_device

    dev = resolve_device(device)
    n = len(acc)
    pad = _bucket(n) - n

    def padded(a):
        a = np.asarray(a, np.float32)
        a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], np.float32)])
        return torch.from_numpy(a).to(dev)

    valid = torch.from_numpy(
        np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])).to(dev)
    tensors = (padded(acc), padded(gyro), padded(dts), valid,
               torch.from_numpy(np.asarray(bg, np.float32)).to(dev),
               torch.from_numpy(np.asarray(ba, np.float32)).to(dev))
    kw = _noise_kw(calib)
    pre = (graph(tensors, **kw) if graph is not None
           else preintegrate(*tensors, **kw))
    return Preintegrated(*fetch(tuple(pre)))


def relinearize(pre: Preintegrated, bg_new, ba_new) -> Preintegrated:
    """Re-express a preintegration at a new linearization bias, first order
    through the stored Jacobians: the deltas move, the Jacobians and the
    covariance stay."""
    dR, dV, dP = delta_with_bias(pre, bg_new, ba_new)
    return pre._replace(dR=lie.project_rotation(dR), dV=dV, dP=dP,
                        bg=bg_new, ba=ba_new)


def merge_previous(prev: Preintegrated, cur: Preintegrated) -> Preintegrated:
    """Concatenate two consecutive preintegrations (MergePrevious): the
    delta over [t0, t2] at the current segment's linearization bias."""
    dR1, dV1, dP1 = delta_with_bias(prev, cur.bg, cur.ba)
    dR2, dV2, dP2 = cur.dR, cur.dV, cur.dP
    t2 = cur.dt
    dR = lie.project_rotation(mat_mul(dR1, dR2))
    dV = dV1 + mat_vec(dR1, dV2)
    dP = dP1 + dV1 * t2 + mat_vec(dR1, dP2)

    # transport: state_2 = F @ state_1 + G @ state_seg2
    dtype, dev = dR.dtype, dR.device
    F = torch.eye(15, dtype=dtype, device=dev)
    F[0:3, 0:3] = _mT(dR2)
    F[6:9, 3:6] = torch.eye(3, dtype=dtype, device=dev) * t2
    G = torch.eye(15, dtype=dtype, device=dev)
    G[3:6, 3:6] = dR1
    G[6:9, 6:9] = dR1
    cov = (mat_mul(mat_mul(F, prev.cov), _mT(F))
           + mat_mul(mat_mul(G, cur.cov), _mT(G)))
    # the bias-walk block once
    cov[9:, 9:] = prev.cov[9:, 9:] + cur.cov[9:, 9:]

    JRg = mat_mul(_mT(dR2), prev.JRg) + cur.JRg
    JVg = (prev.JVg + mat_mul(dR1, cur.JVg)
           - mat_mul(mat_mul(dR1, lie.so3_hat(dV2)), prev.JRg))
    JVa = prev.JVa + mat_mul(dR1, cur.JVa)
    JPg = (prev.JPg + prev.JVg * t2 + mat_mul(dR1, cur.JPg)
           - mat_mul(mat_mul(dR1, lie.so3_hat(dP2)), prev.JRg))
    JPa = prev.JPa + prev.JVa * t2 + mat_mul(dR1, cur.JPa)
    return Preintegrated(prev.dt + cur.dt, dR, dV, dP, cov,
                         JRg, JVg, JVa, JPg, JPa, cur.bg, cur.ba)


def delta_with_bias(pre: Preintegrated, bg_new, ba_new):
    """Bias-corrected deltas (GetDeltaRotation / Velocity / Position),
    first order through the stored Jacobians."""
    dbg = bg_new - pre.bg
    dba = ba_new - pre.ba
    dR = mat_mul(pre.dR, lie.so3_exp(mat_vec(pre.JRg, dbg)))
    dV = pre.dV + mat_vec(pre.JVg, dbg) + mat_vec(pre.JVa, dba)
    dP = pre.dP + mat_vec(pre.JPg, dbg) + mat_vec(pre.JPa, dba)
    return dR, dV, dP


def predict_state(R_wb, p_wb, v_w, pre: Preintegrated, bg_new=None,
                  ba_new=None, gravity=None):
    """Propagate a body state through a preintegrated delta
    (PredictStateIMU)."""
    if gravity is None:
        gravity = gravity_like(p_wb)
    if bg_new is None:
        bg_new = pre.bg
    if ba_new is None:
        ba_new = pre.ba
    dR, dV, dP = delta_with_bias(pre, bg_new, ba_new)
    t = pre.dt
    R_new = mat_mul(R_wb, dR)
    v_new = v_w + gravity * t + mat_vec(R_wb, dV)
    p_new = p_wb + v_w * t + 0.5 * gravity * t * t + mat_vec(R_wb, dP)
    return R_new, p_new, v_new


def inertial_residual(R_i, p_i, v_i, R_j, p_j, v_j, bg, ba,
                      pre: Preintegrated, gravity=None):
    """The 9-D preintegration residual [e_R, e_v, e_p] (EdgeInertial)."""
    if gravity is None:
        gravity = gravity_like(p_i)
    dR, dV, dP = delta_with_bias(pre, bg, ba)
    t = pre.dt
    R_iT = _mT(R_i)
    e_R = lie.so3_log(mat_mul(_mT(dR), mat_mul(R_iT, R_j)))
    e_v = mat_vec(R_iT, v_j - v_i - gravity * t) - dV
    e_p = mat_vec(R_iT, p_j - p_i - v_i * t - 0.5 * gravity * t * t) - dP
    return torch.cat([e_R, e_v, e_p], -1)

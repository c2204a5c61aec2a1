"""Pose-only optimization: robust Levenberg-Marquardt on SE3.

Counterpart of ``xfeatslam_tpu/optim/pose_opt.py`` (the reference's
Optimizer::PoseOptimization): one SE3 pose, unary mono (u,v) and stereo
(u,v,uR) reprojection edges, Huber kernels at chi2 5.991 / 7.815, 4 rounds
of 10 LM iterations with chi2 inlier reclassification between rounds, and
a second, graduated schedule; the candidate with the lower final robust
cost wins. Updates are left-multiplicative: T <- exp([rho,phi]) * T.

On CUDA tensors the whole call is one launch of the hand-written kernel
``csrc/pose_lm.cu`` (``ops/cuda_kernels.pose_lm``); on CPU tensors it is
the kernel's plain version, ``cuda_kernels.pose_lm_plain``, whose 3x3 and
6x6 products are broadcast multiply-and-sum, so TF32 never reaches them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import cuda_kernels as ck
from ..ops.camera import Pinhole


class PoseOptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor      # (N,) bool, edge classified inlier at the end
    num_inliers: torch.Tensor  # () int32
    chi2: torch.Tensor         # (N,) final per-edge chi2


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
    return PoseOptResult(*ck.pose_lm(R0, t0, Xw, obs_uv, obs_ur, inv_sigma2,
                                     is_stereo, valid, cam, bf, rounds,
                                     iters))

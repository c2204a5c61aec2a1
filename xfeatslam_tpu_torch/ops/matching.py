"""Descriptor matching: distance matrices, mutual nearest neighbours, and
the projection, window, general and stereo searches.

Counterpart of ``xfeatslam_tpu/ops/matching.py``. ``match_mutual_nn``'s
fused route goes through the single-pair kernel
(``cuda_kernels.mutual_nn_top2``); the searches are masked distance
matrices, one plain matrix product each, as the JAX package leaves them to
XLA. Scalar arguments (radii, thresholds) are Python numbers or tensors on
the inputs' device, so no host value is copied to the device here.

Distance convention (reference ORBmatcher::DescriptorDistance): XFeat mode
is squared-L2 x 512 on L2-normalized descriptors, d = (2 - 2 a.b) * 512,
with thresholds TH_HIGH=1000 and TH_LOW=100; ORB mode is raw Hamming.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import cuda_kernels as ck
from .lie import mat_vec

TH_HIGH = 1000.0
TH_LOW = 100.0
ORB_TH_HIGH = 100.0
ORB_TH_LOW = 50.0
INVALID = 1e9


class MatchResult(NamedTuple):
    idx: torch.Tensor   # (N,) best column per row (-1 if unmatched)
    dist: torch.Tensor  # (N,) distance of the match
    mask: torch.Tensor  # (N,) bool valid match


def xfeat_distance_matrix(desc_a, desc_b):
    """(N,D),(M,D) L2-normalized -> (N,M) distances = L2^2 * 512."""
    return (2.0 - 2.0 * (desc_a @ desc_b.T)) * 512.0


def hamming_distance_matrix(desc_a, desc_b):
    """(N,D),(M,D) 0/1 vectors -> (N,M) Hamming distance via one matmul
    (on binary vectors L2^2 == Hamming)."""
    na = desc_a.sum(dim=-1, keepdim=True)
    nb = desc_b.sum(dim=-1)
    return na + nb[None, :] - 2.0 * (desc_a @ desc_b.T)


def distance_matrix(desc_a, desc_b, binary: bool = False):
    return (hamming_distance_matrix if binary else xfeat_distance_matrix)(
        desc_a, desc_b)


def _mask_dist(dist, valid_a, valid_b):
    return torch.where(valid_a[:, None] & valid_b[None, :], dist, INVALID)


def _best_two(dist):
    """Row-wise (best, second, argbest) of dist (N,M); ties go to the first
    column, and second excludes only the argbest column."""
    best, idx = dist.min(dim=1)
    if dist.shape[1] < 2:
        return best, torch.full_like(best, INVALID), idx.to(torch.int32)
    second = dist.scatter(1, idx[:, None], float("inf")).amin(dim=1)
    return best, second, idx.to(torch.int32)


def _dedup_best(ok, best, idx, n_cols: int):
    """Keep, per column, only the rows at that column's smallest accepted
    distance (a scatter-min over the accepted rows). Two rows at exactly
    the same distance both survive."""
    keyed = torch.where(ok, best, INVALID)
    col_min = torch.full((n_cols,), INVALID, dtype=best.dtype,
                         device=best.device)
    col_min = col_min.scatter_reduce(0, torch.where(ok, idx, 0).long(), keyed,
                                     "amin", include_self=True)
    return ok & (best <= col_min[idx.long().clamp(0, n_cols - 1)])


def match_mutual_nn(desc_a, desc_b, valid_a, valid_b,
                    max_dist: float = TH_LOW, ratio: float = 1.0,
                    binary: bool = False,
                    fused: Optional[bool] = None) -> MatchResult:
    """Mutual nearest-neighbour matching with an optional Lowe ratio test.
    Returns MatchResult over rows of desc_a.

    ``fused`` picks the route: the single-pair kernel
    (``cuda_kernels.mutual_nn_top2``, never storing the (N,M) matrix) or
    the full masked distance matrix. None takes the kernel route when every
    input lies on CUDA and ``binary`` is false; True on CPU tensors runs
    the kernel route through the kernels' plain versions. ``dist`` keeps
    each route's convention: inf for an invalid row on the kernel route,
    INVALID (1e9) on the matrix route."""
    if fused is None:
        fused = not binary and all(
            t.is_cuda for t in (desc_a, desc_b, valid_a, valid_b))
    if fused and not binary:
        best, second, idx, col_best_row = ck.mutual_nn_top2(
            desc_a, desc_b, valid_a, valid_b)
        back = col_best_row[idx.long().clamp(0, desc_b.shape[0] - 1)]
        mutual = back == torch.arange(desc_a.shape[0], device=desc_a.device)
        ok = (best <= max_dist) & (best <= ratio * second) & mutual & valid_a
        return MatchResult(torch.where(ok, idx, -1), best, ok)
    dist = _mask_dist(distance_matrix(desc_a, desc_b, binary), valid_a, valid_b)
    best, second, idx = _best_two(dist)
    # row i's best column j must have row i as ITS best row
    col_best_row = dist.argmin(dim=0)
    mutual = col_best_row[idx.long()] == torch.arange(dist.shape[0],
                                                      device=dist.device)
    ok = (best <= max_dist) & (best <= ratio * second) & mutual & valid_a
    return MatchResult(torch.where(ok, idx, -1), best, ok)


def search_by_projection(pred_uv, mp_desc, valid_mp, kpt_uv, kpt_desc,
                         valid_kpt, radius, max_dist=TH_HIGH,
                         ratio: float = 0.9, kpt_free=None,
                         binary: bool = False, kpt_octave=None, oct_lo=None,
                         oct_hi=None) -> MatchResult:
    """Projection-guided matching of map points to keypoints within a pixel
    radius (ORBmatcher::SearchByProjection family).

    Args:
      pred_uv (M,2) predicted pixel of each map point; mp_desc (M,D);
        valid_mp (M,) bool.
      kpt_uv (N,2) undistorted keypoints; kpt_desc (N,D); valid_kpt (N,).
      radius: a number or an (M,) tensor of per-point radii in pixels.
      max_dist, ratio: accept threshold and best/second ratio gate.
      kpt_free: optional (N,) bool, keypoint not bound yet.
      kpt_octave/oct_lo/oct_hi: optional scale gate, keypoint n is a
        candidate of point m when oct_lo[m] <= kpt_octave[n] <= oct_hi[m].
    Returns MatchResult over map points, deduplicated so each keypoint
    keeps only its best map point."""
    # a per-point radius broadcasts as a column against (M,N)
    r = radius[:, None] if isinstance(radius, torch.Tensor) and radius.ndim \
        else radius
    d_uv = pred_uv[:, None, :] - kpt_uv[None, :, :]
    within = (d_uv[..., 0].abs() <= r) & (d_uv[..., 1].abs() <= r)
    if kpt_free is not None:
        within = within & kpt_free[None, :]
    if kpt_octave is not None and oct_lo is not None:
        within = within & ((kpt_octave[None, :] >= oct_lo[:, None])
                           & (kpt_octave[None, :] <= oct_hi[:, None]))
    dist = _mask_dist(distance_matrix(mp_desc, kpt_desc, binary), valid_mp,
                      valid_kpt)
    dist = torch.where(within, dist, INVALID)
    best, second, idx = _best_two(dist)
    ok = (best <= max_dist) & (best <= ratio * second) & valid_mp
    keep = _dedup_best(ok, best, idx, kpt_uv.shape[0])
    return MatchResult(torch.where(keep, idx, -1), best, keep)


def fuse_project_batched(pos, desc, alive, R2, t2, kpt_uv, kpt_desc,
                         valid_kpt, fx, fy, cx, cy, radius, max_dist,
                         ratio: float = 0.9,
                         binary: bool = False) -> MatchResult:
    """Project ONE keyframe's landmark set (pos (M,3), desc, alive) into a
    stack of Nn neighbour keyframes (R2 (Nn,3,3), t2 (Nn,3), kpt_uv
    (Nn,N,2), kpt_desc, valid_kpt) and window-match in each. Returns a
    MatchResult with (Nn,M) fields."""
    results = []
    for R, t, kuv, kd, kv in zip(R2, t2, kpt_uv, kpt_desc, valid_kpt):
        Xc = mat_vec(R, pos) + t
        z = Xc[:, 2]
        vis = z > 0.05
        zs = torch.where(vis, z, 1.0)
        uv = torch.stack([fx * Xc[:, 0] / zs + cx, fy * Xc[:, 1] / zs + cy],
                         -1)
        results.append(search_by_projection(
            uv, desc, alive & vis, kuv, kd, kv, radius=radius,
            max_dist=max_dist, ratio=ratio, binary=binary))
    return MatchResult(*(torch.stack(f) for f in zip(*results)))


def search_window(kpt_uv1, desc1, valid1, kpt_uv2, desc2, valid2,
                  radius: float = 100.0, max_dist: float = TH_LOW,
                  ratio: float = 0.9, binary: bool = False) -> MatchResult:
    """Windowed matching around the same pixel location, for monocular
    initialization (ORBmatcher::SearchForInitialization): window,
    best/second ratio, and reverse-best dedup. Returns MatchResult over
    rows of frame 1."""
    d_uv = kpt_uv1[:, None, :] - kpt_uv2[None, :, :]
    within = (d_uv[..., 0].abs() <= radius) & (d_uv[..., 1].abs() <= radius)
    dist = _mask_dist(distance_matrix(desc1, desc2, binary), valid1, valid2)
    dist = torch.where(within, dist, INVALID)
    best, second, idx = _best_two(dist)
    ok = (best <= max_dist) & (best <= ratio * second) & valid1
    keep = _dedup_best(ok, best, idx, kpt_uv2.shape[0])
    return MatchResult(torch.where(keep, idx, -1), best, keep)


def match_general(desc_a, valid_a, desc_b, valid_b,
                  max_dist: float = TH_LOW, ratio: float = 0.75,
                  pair_mask=None, binary: bool = False) -> MatchResult:
    """General masked best match with ratio test and column dedup (the
    SearchByBoW role over the full matrix; ``pair_mask`` (N,M) restricts
    the candidates)."""
    dist = _mask_dist(distance_matrix(desc_a, desc_b, binary), valid_a, valid_b)
    if pair_mask is not None:
        dist = torch.where(pair_mask, dist, INVALID)
    best, second, idx = _best_two(dist)
    ok = (best <= max_dist) & (best <= ratio * second) & valid_a
    keep = _dedup_best(ok, best, idx, desc_b.shape[0])
    return MatchResult(torch.where(keep, idx, -1), best, keep)


def rotation_consistency_filter(angles_a, angles_b, idx, mask,
                                n_bins: int = 30, keep_bins: int = 3):
    """Host-side (numpy) rotation-histogram consistency check (ORBmatcher
    HISTO_LENGTH=30 + ComputeThreeMaxima): keep only matches whose angle
    delta falls in the 3 dominant bins. No-op when neither side has
    orientation (all angles ~0, as for XFeat)."""
    angles_a = np.asarray(angles_a)
    angles_b = np.asarray(angles_b)
    idx = np.asarray(idx)
    mask = np.asarray(mask).copy()
    if not mask.any():
        return mask
    if np.abs(angles_a).max() < 1e-9 and np.abs(angles_b).max() < 1e-9:
        return mask
    rows = np.nonzero(mask)[0]
    d = np.mod(angles_a[rows] - angles_b[idx[rows]], 2.0 * np.pi)
    bins = np.minimum((d / (2.0 * np.pi) * n_bins).astype(int), n_bins - 1)
    counts = np.bincount(bins, minlength=n_bins)
    order = np.argsort(-counts)
    best = {order[0]}
    if counts[order[1]] > 0.1 * counts[order[0]]:
        best.add(order[1])
    if counts[order[2]] > 0.1 * counts[order[0]]:
        best.add(order[2])
    mask[rows[~np.isin(bins, list(best))]] = False
    return mask


def stereo_match_rows(kpt_uv_l, desc_l, valid_l, octave_l,
                      kpt_uv_r, desc_r, valid_r, octave_r,
                      min_disp: float = 0.0, max_disp: float = 128.0,
                      row_band: float = 2.0,
                      max_dist: float = (ORB_TH_HIGH + ORB_TH_LOW) / 2,
                      binary: bool = True):
    """Row-banded stereo matching for rectified pairs
    (Frame::ComputeStereoMatches role): per left keypoint, the best right
    keypoint within +-row_band rows, [min_disp, max_disp] disparity and the
    same octave, accepted below max_dist, deduplicated per right keypoint.
    Returns (MatchResult over left keypoints, disparity (-1 unmatched))."""
    dv = kpt_uv_l[:, None, 1] - kpt_uv_r[None, :, 1]
    disp = kpt_uv_l[:, None, 0] - kpt_uv_r[None, :, 0]
    within = ((dv.abs() <= row_band) & (disp >= min_disp) & (disp <= max_disp)
              & (octave_l[:, None] == octave_r[None, :]))
    dist = _mask_dist(distance_matrix(desc_l, desc_r, binary), valid_l, valid_r)
    dist = torch.where(within, dist, INVALID)
    best, _, idx = _best_two(dist)
    ok = (best <= max_dist) & valid_l
    keep = _dedup_best(ok, best, idx, kpt_uv_r.shape[0])
    disparity = torch.gather(disp, 1, idx.long()[:, None])[:, 0]
    return (MatchResult(torch.where(keep, idx, -1), best, keep),
            torch.where(keep, disparity, -1.0))

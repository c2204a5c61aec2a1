"""Descriptor matching: distance matrices and mutual nearest neighbours.

Counterpart of the float mutual-NN part of ``xfeatslam_tpu/ops/matching.py``
(the projection and window searches come with a later slice).

Distance convention (reference ORBmatcher::DescriptorDistance): XFeat mode
is squared-L2 x 512 on L2-normalized descriptors, d = (2 - 2 a.b) * 512,
with thresholds TH_HIGH=1000 and TH_LOW=100; ORB mode is raw Hamming.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TH_HIGH = 1000.0
TH_LOW = 100.0
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


def match_mutual_nn(desc_a, desc_b, valid_a, valid_b,
                    max_dist: float = TH_LOW, ratio: float = 1.0,
                    binary: bool = False) -> MatchResult:
    """Mutual nearest-neighbour matching with an optional Lowe ratio test,
    over the full masked distance matrix. Returns MatchResult over rows of
    desc_a."""
    dist = _mask_dist(distance_matrix(desc_a, desc_b, binary), valid_a, valid_b)
    best, second, idx = _best_two(dist)
    # row i's best column j must have row i as ITS best row
    col_best_row = dist.argmin(dim=0)
    mutual = col_best_row[idx.long()] == torch.arange(dist.shape[0],
                                                      device=dist.device)
    ok = (best <= max_dist) & (best <= ratio * second) & mutual & valid_a
    return MatchResult(torch.where(ok, idx, -1), best, ok)

"""Batched offline pipeline: extract features for a batch of frames, then
mutual-NN match every consecutive pair.

Counterpart of ``extract_batch`` and ``match_consecutive`` in
``xfeatslam_tpu/parallel/batched.py`` (BASELINE config 4). On CUDA tensors
both go through the CUDA kernels of ``ops/cuda_kernels.py``; on CPU
tensors through their plain versions. The multi-device sharded pipeline is
not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import cuda_kernels as ck
from ..ops import detect as detect_ops
from ..ops import matching


@torch.no_grad()
def extract_batch(model, images, num_keypoints: int,
                  compute_dtype=torch.float32):
    """(B,H,W,C) float images -> dict of (B,K,...) features (kpts, scores,
    desc, valid), H and W multiples of 32."""
    feats, logits, heat = model(images, compute_dtype=compute_dtype)
    return detect_ops.select_keypoints(feats, logits, heat, num_keypoints)


@torch.no_grad()
def match_consecutive(desc, valid, max_dist=matching.TH_LOW * 6, ratio=0.95,
                      fused: Optional[bool] = None):
    """MNN-match frames (i, i+1) for all i: desc (B,K,64), valid (B,K) ->
    MatchResult of (B-1,K) tensors.

    None and True run the pair-batched kernel (``mutual_nn_pairs``, one
    launch for all pairs); False runs ``matching.match_mutual_nn`` pair
    by pair, the JAX package's vmapped form, which on CUDA tensors takes
    the single-pair kernel (two launches per pair)."""
    if fused is False:
        results = [matching.match_mutual_nn(desc[i], desc[i + 1], valid[i],
                                            valid[i + 1], max_dist=max_dist,
                                            ratio=ratio)
                   for i in range(desc.shape[0] - 1)]
        return matching.MatchResult(*(torch.stack(f) for f in zip(*results)))
    K = desc.shape[1]
    best, second, idx, col_best = ck.mutual_nn_pairs(
        desc[:-1], desc[1:], valid[:-1], valid[1:])
    back = torch.gather(col_best, 1, idx.long().clamp(0, K - 1))
    mutual = back == torch.arange(K, device=desc.device)
    ok = ((best <= max_dist) & (best <= ratio * second) & mutual
          & valid[:-1])
    return matching.MatchResult(torch.where(ok, idx, -1), best, ok)

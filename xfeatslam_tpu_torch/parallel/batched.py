"""Batched offline pipeline: extract features for a batch of frames, then
mutual-NN match every consecutive pair.

Counterpart of ``xfeatslam_tpu/parallel/batched.py`` (BASELINE config 4):
``extract_batch``, ``match_consecutive`` and the pipeline sharded over a
mesh's data axis (``make_sharded_pipeline``). On CUDA tensors they go
through the CUDA kernels of ``ops/cuda_kernels.py``; on CPU tensors
through their plain versions.
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


def make_sharded_pipeline(mesh, model, num_keypoints: int = 1000,
                          compute_dtype=torch.bfloat16):
    """Returns ``pipeline(images)``: (B,H,W,C) images, the whole batch on
    every rank, -> (kpts, desc, valid, match_idx, match_mask) of the whole
    batch on every rank, with the frames split over the mesh's "data" axis
    and ``model`` whole on every rank. B must divide by the data axis.

    Each data rank extracts its frames and matches its pairs, the pair
    across its boundary with the next rank's first frame included (taken
    from the gathered descriptors); a mesh of one rank runs
    ``extract_batch`` and ``match_consecutive`` as they are."""

    def pipeline(images):
        if mesh.size == 1:
            out = extract_batch(model, images, num_keypoints, compute_dtype)
            res = match_consecutive(out["desc"], out["valid"])
            return out["kpts"], out["desc"], out["valid"], res.idx, res.mask
        B = images.shape[0]
        out = extract_batch(model, mesh.shard_batch(images), num_keypoints,
                            compute_dtype)
        kpts, desc, valid = (mesh.gather_batch(out[k])
                             for k in ("kpts", "desc", "valid"))
        b = out["kpts"].shape[0]
        lo = mesh.coords[0] * b
        d, v = desc[lo:lo + b + 1], valid[lo:lo + b + 1]
        if len(d) == b:  # the last rank: one pair of its last frame with
            d = torch.cat([d, d[-1:]])  # itself, which is dropped
            v = torch.cat([v, v[-1:]])
        res = match_consecutive(d, v)
        return (kpts, desc, valid, mesh.gather_batch(res.idx)[:B - 1],
                mesh.gather_batch(res.mask)[:B - 1])

    return pipeline

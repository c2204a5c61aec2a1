"""``parallel.batched.make_sharded_pipeline`` on a data mesh: every rank
holds the whole batch, extracts its share of the frames and matches its
pairs (the pair across its boundary from the gathered descriptors), and
gathers the whole batch's answers. It returns no scores and no match
distances."""

import torch

from xfeatslam_tpu_torch.parallel import batched

from . import _common


class Entry:
    stages = ("pipeline",)
    subpixel = False

    def __init__(self, model, cfg, device, mesh=None):
        _common.check(cfg, self.subpixel)
        _common.check_defaults(cfg, batched.match_consecutive)
        self.mesh = mesh
        self.pipeline = batched.make_sharded_pipeline(
            mesh, model, cfg["extractor"]["num_keypoints"],
            compute_dtype=_common.dtype(cfg))

    @torch.no_grad()
    def step(self, x):
        kpts, desc, valid, idx, mask = self.pipeline(x)
        return {"kpts": kpts, "desc": desc, "valid": valid,
                "match_idx": idx, "match_mask": mask}

    def traced_step(self, x, mark):
        out = self.step(x)
        mark("pipeline")
        return out

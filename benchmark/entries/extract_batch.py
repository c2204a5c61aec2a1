"""``parallel.batched.extract_batch`` then ``match_consecutive``: the code
that a mesh of one runs in ``make_sharded_pipeline``, for frames whose
sides are multiples of 32 (no resize, no sub-pixel offsets)."""

import torch

from xfeatslam_tpu_torch.ops import detect
from xfeatslam_tpu_torch.parallel import batched

from . import _common


class Entry:
    stages = ("network", "select", "match")
    subpixel = False

    def __init__(self, model, cfg, device, mesh=None):
        _common.check(cfg, self.subpixel)
        H, W = cfg["frame"]["height"], cfg["frame"]["width"]
        if H % 32 or W % 32:
            raise ValueError("extract_batch takes sides that are multiples "
                             "of 32")
        self.model = model
        self.K = cfg["extractor"]["num_keypoints"]
        self.mc = cfg["matcher"]
        self.dtype = _common.dtype(cfg)

    @torch.no_grad()
    def step(self, x):
        out = batched.extract_batch(self.model, x, self.K, self.dtype)
        return _common.with_matches(out, batched.match_consecutive(
            out["desc"], out["valid"], self.mc["max_dist"], self.mc["ratio"]))

    @torch.no_grad()
    def traced_step(self, x, mark):
        feats, logits, heat = self.model(x, compute_dtype=self.dtype)
        mark("network")
        out = detect.select_keypoints(feats, logits, heat, self.K)
        mark("select")
        res = batched.match_consecutive(out["desc"], out["valid"],
                                        self.mc["max_dist"], self.mc["ratio"])
        mark("match")
        return _common.with_matches(out, res)

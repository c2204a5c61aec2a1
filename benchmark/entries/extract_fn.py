"""``models.extractor.extract_fn`` then ``parallel.batched.
match_consecutive``: frames of any size, resized to the floor multiple of
32, keypoints with sub-pixel offsets, coordinates rescaled to the frame."""

import torch

from xfeatslam_tpu_torch.models import extractor
from xfeatslam_tpu_torch.ops import detect
from xfeatslam_tpu_torch.ops import image as image_ops
from xfeatslam_tpu_torch.parallel import batched

from . import _common


class Entry:
    stages = ("resize", "network", "select", "match")
    subpixel = True

    def __init__(self, model, cfg, device, mesh=None):
        _common.check(cfg, self.subpixel)
        self.model = model
        self.K = cfg["extractor"]["num_keypoints"]
        self.mc = cfg["matcher"]
        self.dtype = _common.dtype(cfg)

    @torch.no_grad()
    def step(self, x):
        out = extractor.extract_fn(self.model, x, self.K, self.dtype)
        return _common.with_matches(out, batched.match_consecutive(
            out["desc"], out["valid"], self.mc["max_dist"], self.mc["ratio"]))

    @torch.no_grad()
    def traced_step(self, x, mark):
        # extract_fn's body, a call at a time
        _, H, W, _ = x.shape
        H32, W32 = (H // 32) * 32, (W // 32) * 32
        if (H32, W32) != (H, W):
            x = image_ops.resize_bilinear(x, (H32, W32))
        mark("resize")
        feats, logits, heat = self.model(x, compute_dtype=self.dtype)
        mark("network")
        out = detect.select_keypoints(feats, logits, heat, self.K,
                                      subpixel=True)
        k = out["kpts"]
        out["kpts"] = torch.stack([k[..., 0] * (W / W32),
                                   k[..., 1] * (H / H32)], -1)
        mark("select")
        res = batched.match_consecutive(out["desc"], out["valid"],
                                        self.mc["max_dist"], self.mc["ratio"])
        mark("match")
        return _common.with_matches(out, res)

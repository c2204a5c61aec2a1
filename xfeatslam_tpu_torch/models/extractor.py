"""XFeat feature extractor: the front end of the SLAM pipeline.

Counterpart of ``xfeatslam_tpu/models/extractor.py``: resize to a multiple
of 32, run the network, select keypoints with sub-pixel offsets, rescale
the coordinates to the input frame, and hand numpy arrays to the host in
one transfer.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .. import resolve_device
from ..ops import detect as detect_ops
from ..ops import image as image_ops
from . import weights as wio
from .xfeat import XFeat, init_params

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@torch.no_grad()
def extract_fn(model: XFeat, images, num_keypoints: int,
               compute_dtype=torch.float32):
    """Batched extraction.

    Args:
      images: (B, H, W, C) float32 in [0,1]. H and W need not be multiples
        of 32: the images are resized to the floor multiple and the
        coordinates scaled back.
    Returns dict: kpts (B,K,2) in ORIGINAL pixel coords, scores (B,K),
      desc (B,K,64) L2-normalized, valid (B,K).
    """
    _, H, W, _ = images.shape
    H32, W32 = (H // 32) * 32, (W // 32) * 32
    x = images
    if (H32, W32) != (H, W):
        x = image_ops.resize_bilinear(x, (H32, W32))
    feats, logits, heatmap = model(x, compute_dtype=compute_dtype)
    out = detect_ops.select_keypoints(feats, logits, heatmap, num_keypoints,
                                      subpixel=True)
    # scaled by Python numbers, so no host value is copied to the device
    k = out["kpts"]
    out["kpts"] = torch.stack([k[..., 0] * (W / W32), k[..., 1] * (H / H32)],
                              -1)
    return out


class XFeatExtractor:
    """Host-side facade holding the model and the static config.
    ``nfeatures`` is the YAML ORBextractor.nFeatures setting."""

    def __init__(self, model: Optional[XFeat] = None, nfeatures: int = 1000,
                 weights_path: Optional[str] = None,
                 compute_dtype=torch.float32, seed: int = 0, device=None):
        self.device = resolve_device(device)
        if model is None:
            if weights_path is None:
                weights_path = self._default_weights()
            if weights_path is None:
                model = wio.from_jax_params(init_params(seed), self.device)
            elif weights_path.endswith(".npz"):
                model = wio.load_npz(weights_path, self.device)
            else:
                model = wio.load_torch(weights_path, self.device)
        self.model = model
        self.nfeatures = nfeatures
        self.compute_dtype = compute_dtype

    @staticmethod
    def _default_weights():
        """Weight resolution order: $XFEATSLAM_WEIGHTS, then the repo's
        weights/xfeat_synthetic.npz, then weights/xfeat.pt. None -> the
        analytic init."""
        env = os.environ.get("XFEATSLAM_WEIGHTS")
        if env and os.path.exists(env):
            return env
        for name in ("weights/xfeat_synthetic.npz", "weights/xfeat.pt"):
            p = os.path.join(_REPO, name)
            if os.path.exists(p):
                return p
        return None

    def __call__(self, images):
        """images: uint8/float (H,W), (H,W,C), or (B,H,W,C) -> numpy dict."""
        x = image_ops.to_float_image(images, self.device)
        out = extract_fn(self.model, x, self.nfeatures, self.compute_dtype)
        return {k: v.cpu().numpy() for k, v in out.items()}

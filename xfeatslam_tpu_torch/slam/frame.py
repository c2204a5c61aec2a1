"""Frame construction: extraction -> undistortion -> depth to virtual right.

Counterpart of ``xfeatslam_tpu/slam/frame.py`` (the XFeat Frame
constructors of ORB-SLAM3's Frame.cc, RGB-D): extraction, undistortion and
the depth lookup run on the extractor's device and come back to the host
in one transfer. The JAX package gates depth with ``cv2.erode`` /
``cv2.dilate`` over the whole map; here the 3x3 minimum and maximum are 9
clamped reads at the keypoints (``track_step.keypoint_depth``), which
matches cv2's default border (only in-image pixels count). The stereo and
fisheye constructors wait for ROADMAP item 14, the monocular one for item
12.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..models.extractor import XFeatExtractor, extract_fn
from ..ops import camera as camera_ops
from ..ops import image as image_ops
from ..optim import track_step

# the relative 3x3 depth spread above which a keypoint's depth is dropped
DEPTH_EDGE_REL = 0.05


@dataclass
class Frame:
    fid: int
    timestamp: float
    kpts: np.ndarray  # (K,2) raw pixel coords
    kpts_un: np.ndarray  # (K,2) undistorted
    desc: np.ndarray  # (K,64)
    scores: np.ndarray  # (K,)
    valid: np.ndarray  # (K,) bool
    depth: np.ndarray  # (K,) metric depth (<=0 none)
    ur: np.ndarray  # (K,) virtual right u (<0 none)
    angle: np.ndarray = None  # (K,) keypoint orientation (0 for XFeat)
    octave: np.ndarray = None  # (K,) pyramid level (0 for XFeat)
    R: Optional[np.ndarray] = None  # world->camera
    t: Optional[np.ndarray] = None
    mp_ids: np.ndarray = None  # (K,) int64 map-point binding, -1 free
    inlier: np.ndarray = None  # (K,) bool after pose opt

    def __post_init__(self):
        K = len(self.kpts)
        if self.mp_ids is None:
            self.mp_ids = np.full(K, -1, np.int64)
        if self.inlier is None:
            self.inlier = np.zeros(K, bool)
        if self.angle is None:
            self.angle = np.zeros(K, np.float32)
        if self.octave is None:
            self.octave = np.zeros(K, np.int32)

    @property
    def n_valid(self):
        return int(self.valid.sum())

    def center(self):
        return (-self.R.T @ self.t).astype(np.float32)


class FramePipeline:
    """Builds Frames from (gray, depth) pairs.

    depth_factor: raw-depth / meters divisor (RGBD.DepthMapFactor, 5000 for
    TUM). bf: stereo baseline x focal (Camera.bf) for the virtual right
    coordinate (Frame::ComputeStereoFromRGBD)."""

    def __init__(self, extractor: XFeatExtractor, cam: camera_ops.Pinhole,
                 bf: float, depth_factor: float = 5000.0):
        self.extractor = extractor
        self.cam = cam
        self.bf = float(bf)
        self.depth_factor = float(depth_factor)
        self._next_id = 0

    def depth_meters(self, depth_raw: np.ndarray) -> np.ndarray:
        """Raw depth -> float32 meters."""
        depth_m = np.asarray(depth_raw, np.float32)
        if self.depth_factor != 1.0:
            depth_m = depth_m / self.depth_factor
        return depth_m

    @torch.no_grad()
    def build_rgbd(self, gray: np.ndarray, depth_raw: np.ndarray,
                   timestamp: float) -> Frame:
        """Extract, undistort and look up the gated depth on the
        extractor's device; one host transfer."""
        ex = self.extractor
        dev = ex.device
        out = extract_fn(ex.model, image_ops.to_float_image(gray, dev),
                         ex.nfeatures, ex.compute_dtype)
        kpts = out["kpts"][0]
        kpts_un = camera_ops.undistort_points(self.cam, out["kpts"])[0]
        valid = out["valid"][0]
        depth_m = torch.from_numpy(self.depth_meters(depth_raw)).to(dev)
        d, ur = track_step.keypoint_depth(depth_m, kpts, kpts_un, valid,
                                          self.bf, DEPTH_EDGE_REL)
        return self.assemble_rgbd(track_step.fetch(dict(
            kpts=kpts, kpts_un=kpts_un, desc=out["desc"][0],
            scores=out["scores"][0], valid=valid, depth=d, ur=ur)), timestamp)

    def assemble_rgbd(self, out: dict, timestamp: float) -> Frame:
        """A Frame from per-keypoint numpy arrays computed elsewhere (the
        whole-frame step runs extraction, undistortion and the depth lookup
        and hands back the finished arrays)."""
        f = Frame(
            fid=self._next_id,
            timestamp=timestamp,
            kpts=out["kpts"],
            kpts_un=out["kpts_un"],
            desc=out["desc"],
            scores=out["scores"],
            valid=out["valid"],
            depth=out["depth"],
            ur=out["ur"],
        )
        self._next_id += 1
        return f

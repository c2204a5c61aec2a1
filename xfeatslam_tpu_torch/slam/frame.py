"""Frame construction: extraction -> undistortion -> depth to virtual right.

Counterpart of ``xfeatslam_tpu/slam/frame.py`` (the Frame constructors of
ORB-SLAM3's Frame.cc, RGB-D and monocular, XFeat or ORB): extraction,
undistortion and the depth lookup run on the extractor's device and come
back to the host in one transfer (after the ORB extractor's own two
reads). The JAX package gates depth with ``cv2.erode`` / ``cv2.dilate``
over the whole map; here the 3x3 minimum and maximum are 9
clamped reads at the keypoints (``track_step.keypoint_depth``), which
matches cv2's default border (only in-image pixels count). Stereo frames:
a rectified pair by row-band matching (``build_stereo``, depth bf /
disparity), a fisheye (KannalaBrandt8) rig by matching in the lapping
columns and triangulating both rays (``build_stereo_fisheye``).

With a ``timer`` (``utils.timing.StageTimer``) a build records the spans
``track.extract`` (the extractor calls, both views of a stereo pair in
one span) and, for stereo pairs, ``track.stereo_match`` (the matching,
the depth and the frame's one host read); the caller times the whole
build as ``track.frame_build``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..models.extractor import XFeatExtractor, extract_fn
from ..ops import camera as camera_ops
from ..ops import image as image_ops
from ..ops import matching
from ..optim import track_step

# the relative 3x3 depth spread above which a keypoint's depth is dropped
DEPTH_EDGE_REL = 0.05
# a rectified pair's disparity range and thOrbDist = (TH_HIGH + TH_LOW) / 2
# in each profile's units (75 Hamming for ORB, 550 for XFeat), shared by
# build_stereo and the tracker's whole-frame stereo step
STEREO_MIN_DISP, STEREO_MAX_DISP = 0.5, 192.0
STEREO_TH_ORB = (matching.ORB_TH_HIGH + matching.ORB_TH_LOW) / 2
STEREO_TH_XFEAT = (matching.TH_HIGH + matching.TH_LOW) / 2


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
    # inertial state of the frame
    v_w: Optional[np.ndarray] = None  # (3,) body velocity in world
    bg: Optional[np.ndarray] = None  # (3,) gyro bias
    ba: Optional[np.ndarray] = None  # (3,) acc bias
    pre_last: object = None  # Preintegrated from the previous frame

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

    def __init__(self, extractor: XFeatExtractor, cam, bf: float,
                 depth_factor: float = 5000.0, timer=None):
        self.extractor = extractor
        self.cam = cam
        self.bf = float(bf)
        self.depth_factor = float(depth_factor)
        self.timer = timer
        self._next_id = 0

    def _span(self, name):
        return (self.timer.span(name) if self.timer is not None
                else contextlib.nullcontext())

    def depth_meters(self, depth_raw: np.ndarray) -> np.ndarray:
        """Raw depth -> float32 meters."""
        depth_m = np.asarray(depth_raw, np.float32)
        if self.depth_factor != 1.0:
            depth_m = depth_m / self.depth_factor
        return depth_m

    def _extract(self, *grays) -> list:
        """Run the configured extractor on each image (one span) and
        undistort the keypoints on the extractor's device; unbatched
        tensors per image. XFeat runs the network on the device; ORB (another
        backend) hands back numpy arrays, which go to the device for the
        undistortion and the depth lookup. KannalaBrandt8 keypoints stay raw
        (``kpts_un = kpts``): the fisheye model unprojects them itself."""
        ex = self.extractor
        dev = ex.device
        with self._span("track.extract"):
            if isinstance(ex, XFeatExtractor):
                outs = [{k: v[0] for k, v in extract_fn(
                    ex.model, image_ops.to_float_image(g, dev), ex.nfeatures,
                    ex.compute_dtype).items()} for g in grays]
            else:
                outs = [{k: torch.from_numpy(v[0]).to(dev)
                         for k, v in ex(g).items()} for g in grays]
        for out in outs:
            out["kpts_un"] = (
                out["kpts"] if isinstance(self.cam, camera_ops.KannalaBrandt8)
                else camera_ops.undistort_points(self.cam,
                                                 out["kpts"][None])[0])
        return outs

    @torch.no_grad()
    def build_rgbd(self, gray: np.ndarray, depth_raw: np.ndarray,
                   timestamp: float) -> Frame:
        """Extract, undistort and look up the gated depth on the
        extractor's device; one host transfer after the extraction."""
        out, = self._extract(gray)
        depth_m = torch.from_numpy(self.depth_meters(depth_raw)).to(
            out["kpts"].device)
        out["depth"], out["ur"] = track_step.keypoint_depth(
            depth_m, out["kpts"], out["kpts_un"], out["valid"], self.bf,
            DEPTH_EDGE_REL)
        return self.assemble_rgbd(track_step.fetch(out), timestamp)

    @torch.no_grad()
    def build_mono(self, gray: np.ndarray, timestamp: float) -> Frame:
        """Extract and undistort on the extractor's device; every keypoint
        a monocular observation (no depth, no right coordinate)."""
        out, = self._extract(gray)
        kpts = out["kpts"]
        K = kpts.shape[0]
        out["depth"] = torch.zeros(K, dtype=torch.float32, device=kpts.device)
        out["ur"] = torch.full((K,), -1.0, dtype=torch.float32,
                               device=kpts.device)
        return self.assemble_rgbd(track_step.fetch(out), timestamp)

    def _octave(self, out):
        return out.get("octave", torch.zeros(
            out["kpts"].shape[0], dtype=torch.int32, device=out["kpts"].device))

    @torch.no_grad()
    def build_stereo(self, gray_l: np.ndarray, gray_r: np.ndarray,
                     timestamp: float, min_disp: float = STEREO_MIN_DISP,
                     max_disp: float = STEREO_MAX_DISP) -> Frame:
        """A rectified stereo frame (the Frame stereo constructor with
        ComputeStereoMatches): both images extracted, the left keypoints
        matched row by row against the right ones (same octave, within the
        disparity range, under thOrbDist in the profile's units), depth
        bf / disparity, the virtual right coordinate u - disparity."""
        out_l, out_r = self._extract(gray_l, gray_r)
        binary = out_l["desc"].shape[-1] > 64
        th = STEREO_TH_ORB if binary else STEREO_TH_XFEAT
        with self._span("track.stereo_match"):
            out_l["depth"], out_l["ur"] = track_step.stereo_depth(
                out_l["kpts_un"], out_l["desc"], out_l["valid"],
                self._octave(out_l), out_r["kpts_un"], out_r["desc"],
                out_r["valid"], self._octave(out_r), self.bf, min_disp,
                max_disp, th, binary)
            host = track_step.fetch(out_l)
        return self.assemble_rgbd(host, timestamp)

    @torch.no_grad()
    def build_stereo_fisheye(self, gray_l: np.ndarray, gray_r: np.ndarray,
                             timestamp: float, cam2, T_c1_c2: np.ndarray,
                             lapping1=None, lapping2=None,
                             max_dist: float = None) -> Frame:
        """A two-camera (KannalaBrandt8) stereo frame (the stereo fisheye
        Frame constructor with ComputeStereoFishEyeMatches): both views
        extracted, the descriptors matched among the keypoints in the
        lapping columns (ratio 0.7), every match triangulated in one
        batched call (``camera.stereo_triangulate_matches``); left
        keypoints whose triangulation holds and lies beyond 0.1 m carry
        its depth. As in the JAX package the right view gives depth only
        (no right keypoints in the frame) and ur stays -1."""
        out_l, out_r = self._extract(gray_l, gray_r)
        kpts_l, kpts_r = out_l["kpts"], out_r["kpts"]
        m_l, m_r = out_l["valid"], out_r["valid"]
        if lapping1 is not None:
            m_l = m_l & (kpts_l[:, 0] >= lapping1[0]) & (
                kpts_l[:, 0] <= lapping1[1])
        if lapping2 is not None:
            m_r = m_r & (kpts_r[:, 0] >= lapping2[0]) & (
                kpts_r[:, 0] <= lapping2[1])
        binary = out_l["desc"].shape[-1] > 64
        if max_dist is None:
            max_dist = matching.ORB_TH_LOW if binary else matching.TH_LOW * 6
        with self._span("track.stereo_match"):
            res = matching.match_general(out_l["desc"], m_l, out_r["desc"],
                                         m_r, max_dist=max_dist, ratio=0.7,
                                         binary=binary)
            safe = res.idx.long().clamp(min=0)
            sf = float(getattr(self.extractor, "scale_factor", 1.2))
            oct_l = self._octave(out_l).to(torch.float64)
            oct_r = self._octave(out_r)[safe].to(torch.float64)
            T = torch.from_numpy(np.asarray(T_c1_c2, np.float32)).to(
                kpts_l.device)
            _, z1, ok = camera_ops.stereo_triangulate_matches(
                self.cam, cam2, kpts_l, kpts_r[safe], T[:3, :3], T[:3, 3],
                sigma2_1=(sf ** (2.0 * oct_l)).to(torch.float32),
                sigma2_2=(sf ** (2.0 * oct_r)).to(torch.float32))
            ok = ok & res.mask
            out_l["depth"] = torch.where(ok & (z1 > 0.1), z1, 0.0)
            out_l["ur"] = torch.full_like(z1, -1.0)
            host = track_step.fetch(out_l)
        return self.assemble_rgbd(host, timestamp)

    def assemble_rgbd(self, out: dict, timestamp: float) -> Frame:
        """A Frame from per-keypoint numpy arrays (the whole-frame step
        runs extraction, undistortion and the depth lookup and hands back
        the finished arrays); ORB's ``angle`` and ``octave`` when given."""
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
            angle=out.get("angle"),
            octave=out.get("octave"),
        )
        self._next_id += 1
        return f

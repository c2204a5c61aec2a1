"""The per-frame tracking step: project -> match -> rotation check ->
widen-on-failure -> robust pose LM, and the whole steady-state RGB-D (or
monocular) XFeat frame built on it.

Counterpart of ``xfeatslam_tpu/optim/track_step.py``. There each step is
one jitted XLA graph (``match_pose_step`` is the jit of
``_match_pose_step_impl``, ``two_stage_track_step`` of ``_two_stage_impl``);
here each is one eager function that keeps every intermediate on the
device and never reads a device value on the host: both widen passes are
computed and selected with ``torch.where``, as the JAX graph does, and
scalar settings are Python numbers. The caller fetches the result once
(``fetch``). On the card the whole frame step is captured as one CUDA
graph and replayed (``RgbdFrameStepGraph``; ``StereoFrameStepGraph`` for a
rectified stereo pair, ``xfeat_stereo_frame_step``); a frame built
outside the step (ORB) replays both tracking stages as one graph
(``TwoStageTrackGraph``).

Two configurations cover the two tracking stages:
  - motion-model step: fresh bindings, widen x2 when matches are scarce
    (Tracking::TrackWithMotionModel);
  - local-map step: keeps the earlier bindings as extra pose edges, gates
    candidates by predicted scale (TrackLocalMap).
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import NamedTuple

import torch

from ..models.extractor import extract_fn
from ..ops import camera as camera_ops
from ..ops import cuda_kernels as ck
from ..ops import lie, matching
from ..ops.camera import Pinhole
from . import pose_opt


class TrackStepResult(NamedTuple):
    R: torch.Tensor          # (3,3) optimized Tcw
    t: torch.Tensor          # (3,)
    slot_mp: torch.Tensor    # (N,) int32 row into the map-point arrays or -1
    inlier: torch.Tensor     # (N,) pose-opt inlier classification
    n_matched: torch.Tensor  # () int32 new matches (after the rotation check)
    n_inliers: torch.Tensor  # () int32 pose-opt inliers
    visible: torch.Tensor    # (M,) map points that passed the frustum gates


def _rotation_consistency(mp_angle, kpt_angle, idx, mask, n_bins: int = 30):
    """Rotation-histogram check (ORBmatcher HISTO_LENGTH=30 +
    ComputeThreeMaxima): keep matches in the 3 dominant delta-angle bins
    (the 2nd and 3rd only above 0.1x the 1st). No-op when neither side
    carries orientation (XFeat), decided on the device."""
    has_angle = ((mp_angle.abs().max() > 1e-9)
                 | (kpt_angle.abs().max() > 1e-9))
    d = torch.remainder(mp_angle - kpt_angle[idx.long().clamp(min=0)],
                        2.0 * math.pi)
    bins = (d / (2.0 * math.pi) * n_bins).to(torch.int32).clamp(
        max=n_bins - 1).long()
    counts = torch.zeros(n_bins, dtype=torch.int32, device=mask.device)
    counts = counts.scatter_add(0, bins, mask.to(torch.int32))
    top3 = torch.topk(counts, 3).values
    thr = torch.maximum(top3[2], (0.1 * top3[0]).to(torch.int32))
    ok = (counts >= thr.clamp(min=1))[bins]
    return torch.where(has_angle, mask & ok, mask)


def match_pose_step(R0, t0,
                    # map-point side (M rows, padded)
                    pos_w, mp_desc, valid_mp, mp_angle, mp_octave, dmin,
                    dmax, normal,
                    # frame side (N slots, padded)
                    kpt_uv, kpt_desc, kpt_valid, kpt_angle, kpt_octave,
                    obs_ur, inv_sigma2, kpt_free,
                    # bindings of an earlier stage, kept as pose edges
                    prev_Xw, prev_valid,
                    cam: Pinhole, bf,
                    radius, max_dist, ratio, widen_below, scale_factor,
                    img_w, img_h,
                    binary: bool = False, scale_gate: bool = False,
                    band_gate: bool = False, n_levels: int = 1,
                    widen: bool = True) -> TrackStepResult:
    """One tracking step. ``widen_below``: a second pass with twice the
    radius replaces the first when the first finds fewer new matches (the
    reference's widen-on-failure); both passes are computed."""
    # ---- frustum + gating (Frame::isInFrustum) ----
    Xc = lie.mat_vec(R0, pos_w) + t0
    z = Xc[:, 2]
    vis = z > 0.05
    zs = torch.where(vis, z, 1.0)
    u = cam.fx * Xc[:, 0] / zs + cam.cx
    v = cam.fy * Xc[:, 1] / zs + cam.cy
    vis = vis & (u >= -20) & (u < img_w + 20) & (v >= -20) & (v < img_h + 20)
    C = -lie.mat_vec(R0.T, t0)
    dvec = pos_w - C
    dist = torch.linalg.vector_norm(dvec, dim=-1)
    if band_gate:
        vis = vis & (dist >= 0.8 * dmin) & (dist <= 1.2 * dmax)
        view = dvec / dist[:, None].clamp(min=1e-9)
        vis = vis & ((view * normal).sum(-1) > 0.5)
    pred_uv = torch.stack([u, v], -1)
    valid_m = valid_mp & vis

    # ---- per-point radius + octave window ----
    if scale_gate and n_levels > 1:
        # PredictScale (MapPoint.cc:579)
        ratio_d = dmax / dist.clamp(min=1e-9)
        level = torch.ceil(torch.log(ratio_d.clamp(min=1e-9))
                           / math.log(scale_factor))
        level = level.clamp(0, n_levels - 1).to(torch.int32)
        r_scale = scale_factor ** level.float()
        oct_kw = dict(kpt_octave=kpt_octave, oct_lo=level - 1, oct_hi=level)
    elif n_levels > 1:
        # frame to frame: a window around the last observation's octave
        r_scale = scale_factor ** mp_octave.float()
        oct_kw = dict(kpt_octave=kpt_octave, oct_lo=mp_octave - 1,
                      oct_hi=mp_octave + 1)
    else:
        r_scale = torch.ones_like(dist)
        oct_kw = {}

    def one_pass(mult):
        res = matching.search_by_projection(
            pred_uv, mp_desc, valid_m, kpt_uv, kpt_desc, kpt_valid,
            radius=radius * r_scale * mult, max_dist=max_dist, ratio=ratio,
            kpt_free=kpt_free, binary=binary, **oct_kw)
        return res.idx, _rotation_consistency(mp_angle, kpt_angle, res.idx,
                                              res.mask)

    idx, mask = one_pass(1.0)
    if widen:
        idx2, m2 = one_pass(2.0)
        use2 = mask.sum(dtype=torch.int32) < widen_below
        idx = torch.where(use2, idx2, idx)
        mask = torch.where(use2, m2, mask)
    n_matched = mask.sum(dtype=torch.int32)

    # ---- scatter matches to keypoint slots; slot N collects the rest ----
    # Two map points at exactly the same distance to one keypoint both
    # survive the matcher (common with integer Hamming distances): the
    # later row wins, as a sequential scatter on the CPU (and the JAX
    # package's) does, by a max that gives the same bits on the card
    N = kpt_uv.shape[0]
    M = pos_w.shape[0]
    rows = torch.arange(M, dtype=torch.int32, device=pos_w.device)
    slot_mp = torch.full((N + 1,), -1, dtype=torch.int32, device=pos_w.device)
    slot_mp = slot_mp.scatter_reduce(
        0, torch.where(mask, idx, N).long(), torch.where(mask, rows, -1),
        "amax")[:N]
    new_valid = slot_mp >= 0
    Xw_new = pos_w[slot_mp.long().clamp(min=0)]
    # union with the earlier bindings (new ones fill only free slots)
    edge_valid = prev_valid | new_valid
    Xw = torch.where(prev_valid[:, None], prev_Xw, Xw_new)

    # ---- robust pose LM (Optimizer::PoseOptimization) ----
    res = pose_opt.pose_optimization(
        R0, t0, Xw, kpt_uv, obs_ur, inv_sigma2, (obs_ur > 0) & edge_valid,
        edge_valid & kpt_valid, cam, bf)
    return TrackStepResult(res.R, res.t, slot_mp, res.inliers, n_matched,
                           res.num_inliers, vis & valid_mp)


def two_stage_track_step(
        R0, t0,
        # stage 1: motion-model candidates (last frame's bindings, M1 rows)
        pos1, desc1, valid1, angle1, octave1, ids1,
        # stage 2: local-map snapshot (M2 rows)
        pos2, desc2, valid2, angle2, octave2, ids2, dmax2,
        # frame side (N slots)
        kpt_uv, kpt_desc, kpt_valid, kpt_angle, kpt_octave, obs_ur,
        inv_sigma2, cam: Pinhole, bf,
        radius1, radius2, max_dist, ratio, widen_below, scale_factor,
        img_w, img_h, binary: bool = False, n_levels: int = 1):
    """Both tracking stages (TrackWithMotionModel then TrackLocalMap). The
    motion stage's inlier bindings become the local stage's prior pose
    edges; the local stage drops snapshot rows whose map id stage 1 bound.
    Returns (stage-1 TrackStepResult, stage-2 TrackStepResult)."""
    N = kpt_uv.shape[0]
    dev = kpt_uv.device
    M1, M2 = pos1.shape[0], pos2.shape[0]
    zeros1 = torch.zeros(M1, dtype=torch.float32, device=dev)
    r1 = match_pose_step(
        R0, t0, pos1, desc1, valid1, angle1, octave1,
        zeros1, zeros1 + 1e9, torch.zeros((M1, 3), device=dev),
        kpt_uv, kpt_desc, kpt_valid, kpt_angle, kpt_octave, obs_ur,
        inv_sigma2, torch.ones(N, dtype=torch.bool, device=dev),
        torch.zeros((N, 3), device=dev),
        torch.zeros(N, dtype=torch.bool, device=dev),
        cam, bf, radius1, max_dist, ratio, widen_below, scale_factor,
        img_w, img_h, binary=binary, scale_gate=False, band_gate=False,
        n_levels=n_levels, widen=True)
    bound1 = (r1.slot_mp >= 0) & r1.inlier
    safe = r1.slot_mp.long().clamp(min=0)
    prev_Xw = pos1[safe]
    bid = torch.where(bound1, ids1[safe], -1)
    # snapshot rows already bound by stage 1 are not fresh candidates
    # (valid rows carry ids >= 0, so the -1 sentinel never collides)
    fresh2 = valid2 & ~(ids2[:, None] == bid[None, :]).any(dim=1)
    r2 = match_pose_step(
        r1.R, r1.t, pos2, desc2, fresh2, angle2, octave2,
        torch.zeros(M2, dtype=torch.float32, device=dev), dmax2,
        torch.zeros((M2, 3), device=dev),
        kpt_uv, kpt_desc, kpt_valid, kpt_angle, kpt_octave, obs_ur,
        inv_sigma2, ~bound1, prev_Xw, bound1,
        cam, bf, radius2, max_dist, ratio, 0, scale_factor, img_w, img_h,
        binary=binary, scale_gate=True, band_gate=False, n_levels=n_levels,
        widen=False)
    return r1, r2


def keypoint_depth(depth_m, kpts, kpts_un, valid, bf, depth_edge_rel):
    """Metric depth and virtual right u at the keypoints (K,2) of a
    (H,W) depth map: the depth at the rounded pixel, dropped where the 3x3
    neighbourhood's max - min exceeds ``depth_edge_rel`` times it (a
    silhouette) or holds no depth. The neighbours are 9 clamped gathers at
    the K keypoints: the 3x3 erosion and dilation of the JAX package's
    ``FramePipeline.build_rgbd``, whose border counts only in-image
    pixels. Returns (d, ur), d = 0 and ur = -1 where there is no depth."""
    H, W = depth_m.shape
    xi = torch.round(kpts[:, 0]).long().clamp(0, W - 1)
    yi = torch.round(kpts[:, 1]).long().clamp(0, H - 1)
    d0 = depth_m[yi, xi]
    dmin = d0
    dmax = d0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            dn = depth_m[(yi + dy).clamp(0, H - 1), (xi + dx).clamp(0, W - 1)]
            dmin = torch.minimum(dmin, dn)
            dmax = torch.maximum(dmax, dn)
    d = torch.where(valid, d0, 0.0)
    edge = (dmax - dmin) > depth_edge_rel * d.clamp(min=1e-6)
    d = torch.where(edge | (dmin <= 0), 0.0, d)
    ur = torch.where(d > 0, kpts_un[:, 0] - bf / d.clamp(min=1e-6), -1.0)
    return d, ur


@torch.no_grad()
def xfeat_rgbd_frame_step(
        model, image, depth_m, R0, t0,
        # stage 1: motion-model candidates (last frame's bindings, M1 rows)
        pos1, desc1, valid1, angle1, octave1, ids1,
        # stage 2: local-map snapshot (M2 rows)
        pos2, desc2, valid2, angle2, octave2, ids2, dmax2,
        cam: Pinhole, bf, depth_edge_rel, inv_sigma2_0,
        radius1, radius2, max_dist, ratio, widen_below, scale_factor,
        img_w, img_h, num_keypoints: int, n_levels: int = 1,
        has_depth: bool = True):
    """The whole steady-state RGB-D XFeat frame: extraction (the detect and
    descriptor kernels at batch 1), keypoint undistortion, depth to virtual
    right u, and both tracking stages, with no host sync.

    model: the port's ``XFeat``; image: (1,H,W,C) float in [0,1];
    depth_m: (H,W) float32 metric depth. A keypoint's depth is dropped
    where the 3x3 neighbourhood's max - min exceeds ``depth_edge_rel`` times
    the depth (a silhouette), evaluated with 9 clipped gathers at the K
    keypoints. ``has_depth=False`` is the monocular configuration: depth_m
    is ignored and every keypoint is a mono observation (d=0, ur=-1).
    Returns (frame dict of kpts, kpts_un, desc, scores, valid, depth, ur;
    stage-1 TrackStepResult; stage-2 TrackStepResult)."""
    out = extract_fn(model, image, num_keypoints)
    kpts = out["kpts"][0]
    kpts_un = camera_ops.undistort_points(cam, out["kpts"])[0]
    desc = out["desc"][0]
    valid = out["valid"][0]
    K = kpts.shape[0]
    dev = kpts.device

    if has_depth:
        d, ur = keypoint_depth(depth_m, kpts, kpts_un, valid, bf,
                               depth_edge_rel)
    else:
        d = torch.zeros(K, dtype=torch.float32, device=dev)
        ur = torch.full((K,), -1.0, dtype=torch.float32, device=dev)

    zeros_k = torch.zeros(K, dtype=torch.float32, device=dev)
    r1, r2 = two_stage_track_step(
        R0, t0, pos1, desc1, valid1, angle1, octave1, ids1,
        pos2, desc2, valid2, angle2, octave2, ids2, dmax2,
        kpts_un, desc, valid, zeros_k, zeros_k.to(torch.int32), ur,
        zeros_k + inv_sigma2_0, cam, bf,
        radius1, radius2, max_dist, ratio, widen_below, scale_factor,
        img_w, img_h, binary=False, n_levels=n_levels)
    frame_out = {"kpts": kpts, "kpts_un": kpts_un, "desc": desc,
                 "scores": out["scores"][0], "valid": valid, "depth": d,
                 "ur": ur}
    return frame_out, r1, r2


def stereo_depth(kpt_uv_l, desc_l, valid_l, octave_l, kpt_uv_r, desc_r,
                 valid_r, octave_r, bf, min_disp, max_disp, max_dist,
                 binary: bool):
    """Depth and virtual right u of the left keypoints of a rectified pair
    (ComputeStereoMatches): ``matching.stereo_match_rows`` (row band, same
    octave, disparity in [min_disp, max_disp], distance <= max_dist,
    deduplicated), depth bf / disparity where the match holds and the
    disparity exceeds min_disp, ur = u - disparity there. Returns (d, ur),
    d = 0 and ur = -1 elsewhere."""
    res, disp = matching.stereo_match_rows(
        kpt_uv_l, desc_l, valid_l, octave_l, kpt_uv_r, desc_r, valid_r,
        octave_r, min_disp=min_disp, max_disp=max_disp, max_dist=max_dist,
        binary=binary)
    d = torch.where(res.mask & (disp > min_disp), bf / disp.clamp(min=1e-6),
                    0.0)
    ur = torch.where(d > 0, kpt_uv_l[:, 0] - disp, -1.0)
    return d, ur


@torch.no_grad()
def xfeat_stereo_frame_step(
        model, images, R0, t0,
        # stage 1: motion-model candidates (last frame's bindings, M1 rows)
        pos1, desc1, valid1, angle1, octave1, ids1,
        # stage 2: local-map snapshot (M2 rows)
        pos2, desc2, valid2, angle2, octave2, ids2, dmax2,
        cam: Pinhole, bf, min_disp, max_disp, stereo_max_dist, inv_sigma2_0,
        radius1, radius2, max_dist, ratio, widen_below, scale_factor,
        img_w, img_h, num_keypoints: int, n_levels: int = 1):
    """The whole steady-state rectified-stereo XFeat frame: both views
    extracted as one batch of 2 (one detect and one descriptor launch for
    the pair), undistortion, row-band stereo matching, disparity to depth
    and virtual right u (``stereo_depth``), and both tracking stages, with
    no host sync.

    images: (2,H,W,C) float in [0,1], the left view at 0 and the right at
    1. Returns (frame dict of the left view's kpts, kpts_un, desc, scores,
    valid, depth, ur; stage-1 TrackStepResult; stage-2 TrackStepResult)."""
    out = extract_fn(model, images, num_keypoints)
    kpts_un = camera_ops.undistort_points(cam, out["kpts"])
    kl_un, dl, vl = kpts_un[0], out["desc"][0], out["valid"][0]
    K = kl_un.shape[0]
    dev = kl_un.device
    oct0 = torch.zeros(K, dtype=torch.int32, device=dev)
    d, ur = stereo_depth(kl_un, dl, vl, oct0, kpts_un[1], out["desc"][1],
                         out["valid"][1], oct0, bf, min_disp, max_disp,
                         stereo_max_dist, binary=False)
    zeros_k = torch.zeros(K, dtype=torch.float32, device=dev)
    r1, r2 = two_stage_track_step(
        R0, t0, pos1, desc1, valid1, angle1, octave1, ids1,
        pos2, desc2, valid2, angle2, octave2, ids2, dmax2,
        kl_un, dl, vl, zeros_k, oct0, ur, zeros_k + inv_sigma2_0, cam, bf,
        radius1, radius2, max_dist, ratio, widen_below, scale_factor,
        img_w, img_h, binary=False, n_levels=n_levels)
    frame_out = {"kpts": out["kpts"][0], "kpts_un": kl_un, "desc": dl,
                 "scores": out["scores"][0], "valid": vl, "depth": d,
                 "ur": ur}
    return frame_out, r1, r2


@contextlib.contextmanager
def gc_paused():
    """Collect garbage, then keep Python's cyclic collector off until the
    block ends. Around a CUDA-graph capture: a collection during the
    capture can free another graph, whose reset is not permitted while a
    stream captures and invalidates the capture."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple    # static input buffers, in the call's tensor order
    outputs: object  # the graph's static outputs
    launches: dict   # kernel launches one replay makes, per wrapper


class CapturedCalls:
    """A call captured as one CUDA graph per static signature and replayed:
    the counterpart of one jitted JAX function.

    ``replay(static, tensors, run)`` keys a graph on each tensor's shape
    and dtype and on ``static``, which must hold everything ``run`` does
    not read from a tensor (a value missing from the key would replay the
    old one). A new key copies ``tensors`` into static input buffers, calls
    ``run(*buffers)`` WARMUP times on a side stream and captures one more
    call (the ``torch.cuda.graphs`` recipe); a known key copies ``tensors``
    (on the CPU or the card) into its buffers. Then the graph replays and
    its static outputs come back: the next replay overwrites them, so read
    them (``fetch``) first. A failed capture raises; nothing falls back to
    the eager call. The kernel wrappers count a launch when called, which a
    replay does not do, so each replay adds the launches its capture
    recorded to their counters."""

    WARMUP = 3

    def __init__(self, device, eager: str):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"{type(self).__name__} needs a CUDA device; "
                             f"call {eager} on the CPU")
        self._graphs: dict = {}
        # host seconds of each capture (warm-up included), in order
        self.capture_seconds: list = []
        # calls served, the capturing ones included
        self.calls = 0

    def captured_launches(self) -> list:
        """The kernel launches each captured graph makes per replay."""
        return [dict(e.launches) for e in self._graphs.values()]

    def replay(self, static, tensors, run):
        key = (tuple((tuple(x.shape), x.dtype) for x in tensors), static)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(tensors, run)
        else:
            for dst, src in zip(entry.inputs, tensors):
                dst.copy_(src, non_blocking=True)
        entry.graph.replay()
        self.calls += 1
        for w in ck._WRAPPERS:
            w.launches += entry.launches.get(w.__name__, 0)
        return entry.outputs

    def _capture(self, tensors, run) -> _Captured:
        t0 = time.perf_counter()
        inputs = tuple(torch.empty(x.shape, dtype=x.dtype, device=self.device)
                       for x in tensors)
        for dst, src in zip(inputs, tensors):
            dst.copy_(src)
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                run(*inputs)
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = ck.launch_counts()
        with gc_paused(), torch.cuda.graph(graph):
            outputs = run(*inputs)
        # the capture recorded these launches without running them
        launches = {}
        for w in ck._WRAPPERS:
            n = w.launches - before[w.__name__]
            w.launches = before[w.__name__]
            if n:
                launches[w.__name__] = n
        stream.synchronize()
        self.capture_seconds.append(time.perf_counter() - t0)
        return _Captured(graph, inputs, outputs, launches)


class RgbdFrameStepGraph(CapturedCalls):
    """``xfeat_rgbd_frame_step`` captured and replayed (``CapturedCalls``).

    The eager step launches ~40k small kernels per frame and is bound by
    their host cost; a replay launches the same kernels from the graph.
    The graph's key holds, besides the tensor arguments' shapes and dtypes,
    the camera's intrinsics and distortion, every Python scalar (bf,
    depth_edge_rel, inv_sigma2_0, both radii, max_dist, ratio, widen_below,
    scale_factor, img_w, img_h) and the static flags (num_keypoints,
    n_levels, has_depth). Returns (frame dict, stage-1 result, stage-2
    result), the graph's static outputs."""

    def __init__(self, model):
        super().__init__(next(model.parameters()).device,
                         "xfeat_rgbd_frame_step")
        self.model = model

    def __call__(self, image, depth_m, R0, t0,
                 pos1, desc1, valid1, angle1, octave1, ids1,
                 pos2, desc2, valid2, angle2, octave2, ids2, dmax2,
                 cam: Pinhole, bf, depth_edge_rel, inv_sigma2_0,
                 radius1, radius2, max_dist, ratio, widen_below, scale_factor,
                 img_w, img_h, num_keypoints: int, n_levels: int = 1,
                 has_depth: bool = True):
        tensors = (image, depth_m, R0, t0, pos1, desc1, valid1, angle1,
                   octave1, ids1, pos2, desc2, valid2, angle2, octave2, ids2,
                   dmax2)
        scalars = tuple(float(x) for x in (
            bf, depth_edge_rel, inv_sigma2_0, radius1, radius2, max_dist,
            ratio)) + (int(widen_below),) + tuple(float(x) for x in (
                scale_factor, img_w, img_h))
        flags = (int(num_keypoints), int(n_levels), bool(has_depth))

        def run(*inputs):
            return xfeat_rgbd_frame_step(
                self.model, *inputs, cam, *scalars,
                num_keypoints=flags[0], n_levels=flags[1],
                has_depth=flags[2])

        return self.replay((tuple(float(c) for c in cam), scalars, flags),
                           tensors, run)


class StereoFrameStepGraph(CapturedCalls):
    """``xfeat_stereo_frame_step`` captured and replayed
    (``CapturedCalls``). The key holds, besides the tensor arguments'
    shapes and dtypes, the camera's intrinsics and distortion, every Python
    scalar (bf, min_disp, max_disp, stereo_max_dist, inv_sigma2_0, both
    radii, max_dist, ratio, widen_below, scale_factor, img_w, img_h) and
    the static flags (num_keypoints, n_levels). Returns (frame dict,
    stage-1 result, stage-2 result), the graph's static outputs."""

    def __init__(self, model):
        super().__init__(next(model.parameters()).device,
                         "xfeat_stereo_frame_step")
        self.model = model

    def __call__(self, images, R0, t0,
                 pos1, desc1, valid1, angle1, octave1, ids1,
                 pos2, desc2, valid2, angle2, octave2, ids2, dmax2,
                 cam: Pinhole, bf, min_disp, max_disp, stereo_max_dist,
                 inv_sigma2_0, radius1, radius2, max_dist, ratio,
                 widen_below, scale_factor, img_w, img_h,
                 num_keypoints: int, n_levels: int = 1):
        tensors = (images, R0, t0, pos1, desc1, valid1, angle1, octave1,
                   ids1, pos2, desc2, valid2, angle2, octave2, ids2, dmax2)
        scalars = tuple(float(x) for x in (
            bf, min_disp, max_disp, stereo_max_dist, inv_sigma2_0, radius1,
            radius2, max_dist, ratio)) + (int(widen_below),) + tuple(
                float(x) for x in (scale_factor, img_w, img_h))
        flags = (int(num_keypoints), int(n_levels))

        def run(*inputs):
            return xfeat_stereo_frame_step(
                self.model, *inputs, cam, *scalars,
                num_keypoints=flags[0], n_levels=flags[1])

        return self.replay((tuple(float(c) for c in cam), scalars, flags),
                           tensors, run)


class TwoStageTrackGraph(CapturedCalls):
    """``two_stage_track_step`` on a frame built outside the step (the ORB
    frames), captured and replayed (``CapturedCalls``): the pose LM's two
    launches and the matchers' tensor ops by one replay. The key holds,
    besides the tensor arguments' shapes and dtypes, the camera's
    intrinsics and distortion, every Python scalar (bf, both radii,
    max_dist, ratio, widen_below, scale_factor, img_w, img_h) and the
    static flags (binary, n_levels). Returns (stage-1 result, stage-2
    result), the graph's static outputs."""

    def __init__(self, device):
        super().__init__(device, "two_stage_track_step")

    def __call__(self, R0, t0,
                 pos1, desc1, valid1, angle1, octave1, ids1,
                 pos2, desc2, valid2, angle2, octave2, ids2, dmax2,
                 kpt_uv, kpt_desc, kpt_valid, kpt_angle, kpt_octave, obs_ur,
                 inv_sigma2, cam: Pinhole, bf,
                 radius1, radius2, max_dist, ratio, widen_below, scale_factor,
                 img_w, img_h, binary: bool = False, n_levels: int = 1):
        tensors = (R0, t0, pos1, desc1, valid1, angle1, octave1, ids1,
                   pos2, desc2, valid2, angle2, octave2, ids2, dmax2,
                   kpt_uv, kpt_desc, kpt_valid, kpt_angle, kpt_octave, obs_ur,
                   inv_sigma2)
        scalars = tuple(float(x) for x in (
            bf, radius1, radius2, max_dist, ratio)) + (int(widen_below),) \
            + tuple(float(x) for x in (scale_factor, img_w, img_h))
        flags = (bool(binary), int(n_levels))

        def run(*inputs):
            return two_stage_track_step(*inputs, cam, *scalars,
                                        binary=flags[0], n_levels=flags[1])

        return self.replay((tuple(float(c) for c in cam), scalars, flags),
                           tensors, run)


def fetch(tree):
    """numpy copies of the tensors of ``tree`` (a tensor, or nested tuples,
    lists, dicts and NamedTuples of tensors), with one host synchronization
    for all CUDA tensors: the counterpart of the JAX tracker's single
    ``jax.device_get`` per frame."""
    pending = []

    def to_host(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x, non_blocking=True)
                pending.append(x.device)
                return h
            return x
        if isinstance(x, dict):
            return {k: to_host(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(to_host(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(to_host(v) for v in x)
        return x

    host = to_host(tree)
    for dev in set(pending):
        torch.cuda.current_stream(dev).synchronize()

    def to_numpy(x):
        if isinstance(x, torch.Tensor):
            return x.numpy()
        if isinstance(x, dict):
            return {k: to_numpy(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(to_numpy(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(to_numpy(v) for v in x)
        return x

    return to_numpy(host)

"""Tracking: the per-frame state machine, monocular, stereo and RGB-D,
with or without an IMU.

Counterpart of ``xfeatslam_tpu/slam/tracking.py`` (the role of ORB-SLAM3's
Tracking.cc): the states NOT_INITIALIZED / OK / RECENTLY_LOST / LOST,
motion-model prediction, projection matching and the pose-only LM on the
device, local-map tracking and the keyframe policy, with the host doing
control flow and map bookkeeping in numpy.

Every steady-state XFeat frame runs extraction and both tracking stages
as one device call: on the card the frame step's CUDA graph
(``track_step.RgbdFrameStepGraph``), on the CPU the eager
``xfeat_rgbd_frame_step``; a monocular frame takes the same step without
depth, a rectified stereo pair ``xfeat_stereo_frame_step`` (both views as
a batch of 2, row-band stereo matching for the depth;
``track_step.StereoFrameStepGraph`` on the card). Its outputs come back in
one transfer. An ORB frame (binary descriptors, 8 octaves), an RGB-D
image or a stereo pair, is built first and then tracked by both stages in
one call (``track_step.TwoStageTrackGraph`` on the card). Stereo frames
carry depth and take the RGB-D initialization and keyframe policy.

A monocular map starts from two frames (``_initialize_mono``): windowed
matches, the two-view H/F reconstruction (``optim/two_view``, its RANSAC
sets drawn from a generator seeded by the frame id), the median-depth
normalization, two keyframes with their points, and a global BA of the
pair through ``optim/local_ba`` (the BA kernels on the card).

A lost frame relocalizes (retrieval candidates, descriptor matching, PnP
RANSAC, the pose LM and the guided widening ladder); localization mode
(``only_tracking``) tracks without growing the map and falls back to
visual odometry on the last frame's depth points off the map
(``vo_mode``).

Visual-inertial tracking (``imu_calib``; RGB-D, stereo or monocular
frames): IMU samples are queued (``grab_imu``) and preintegrated between
frames (``ops/imu``, a CUDA graph per window bucket on the card); once the
map is IMU-initialized the pose is predicted from the last keyframe's state
and solved by the visual-inertial pose LMs (``optim/inertial``: anchored to
the last keyframe, or chained through the previous frame's marginalized
prior), each a CUDA graph on the card. Inertial frames take the split path
(projection matching, then the pose solve), as in the JAX package; a
monocular inertial map starts its IMU chain at its two initial keyframes.
"""

from __future__ import annotations

import contextlib
import enum
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import camera as camera_ops
from ..ops import imu as imu_ops
from ..ops import lie
from ..ops import image as image_ops
from ..ops import matching
from ..optim import inertial as in_opt
from ..optim import local_ba, pnp, pose_opt, track_step, two_view
from ..optim.inertial import np_body_to_cam, np_cam_to_body
from ..optim.track_step import fetch
from .frame import (DEPTH_EDGE_REL, STEREO_MAX_DISP, STEREO_MIN_DISP,
                    STEREO_TH_XFEAT, Frame, FramePipeline)
from .map import KeyFrame, SlamMap
from .retrieval import aggregate_global_desc

LOCAL_MP_BUCKET = 4096  # static shape of the local-map snapshots


def resolve_trajectory(traj_rel, active_map, atlas=None):
    """Resolve a relative trajectory log against the CURRENT keyframe
    poses, T_frame = T_rel * T_refKF (System::SaveTrajectoryTUM). Culled
    references walk their recorded relative-to-parent chain; merged maps are
    chased through the atlas remap records. Entries whose reference chain
    cannot be resolved keep their track-time pose. Returns
    [(timestamp, R, t, state)] world->camera."""
    out = []
    for (ts, state, map_id, ref_kid, R_rel, t_rel, R_abs, t_abs) in traj_rel:
        m = active_map if map_id == active_map.map_id else None
        if m is None and atlas is not None:
            m = atlas.maps.get(map_id)
            while m is None and map_id in atlas.remaps:
                map_id, off = atlas.remaps[map_id]
                if ref_kid >= 0:
                    ref_kid += off
                m = atlas.maps.get(map_id)
        R, t = R_abs, t_abs
        if m is not None and ref_kid >= 0 and R_rel is not None:
            Rr, tr = R_rel, t_rel
            kid = ref_kid
            hops = 0
            while kid not in m.keyframes and kid in m.culled and hops < 1000:
                parent, R_cp, t_cp = m.culled[kid]
                # T_frame = T_rel*T_kid, T_kid = T_cp*T_parent
                Rr, tr = Rr @ R_cp, Rr @ t_cp + tr
                if parent < 0:
                    # parentless anchor: (R_cp, t_cp) is the culled pose
                    kid = -1
                    break
                kid = parent
                hops += 1
            kf = m.keyframes.get(kid)
            if kf is not None:
                R = Rr @ kf.R
                t = Rr @ kf.t + tr
            elif kid == -1:
                R, t = Rr, tr
        out.append((ts, lie.np_normalize_rotation(np.asarray(R)),
                    np.asarray(t, np.float32), state))
    return out


class State(enum.Enum):
    NO_IMAGES = 0
    NOT_INITIALIZED = 1
    OK = 2
    RECENTLY_LOST = 3
    LOST = 4


@dataclass
class TrackerConfig:
    fps: float = 30.0
    th_depth: float = 3.0  # Stereo.ThDepth * baseline, meters
    # depth beyond this never becomes a map point; None = off
    th_far_points: Optional[float] = None
    min_init_points: int = 300  # real detections needed to initialize
    motion_radius: float = 15.0  # SearchByProjection radius, frame to frame
    local_radius: float = 10.0
    min_inliers_motion: int = 20
    min_inliers_local: int = 30
    kf_ref_ratio: float = 0.75  # thRefRatio RGB-D
    max_frames_between_kf: Optional[int] = None  # default fps
    recently_lost_seconds: float = 5.0
    obs_sigma: float = 1.0  # observation noise in px (level 0)
    n_levels: int = 1
    scale_factor: float = 1.2
    # no new depth point within this many px of a local-map projection
    create_dedup_px: float = 2.0
    # the matching profile (the USE_ORB switch): binary descriptors are
    # compared by Hamming distance
    binary: bool = False
    th_high: float = matching.TH_HIGH
    th_low: float = matching.TH_LOW
    # reference-KF matching threshold: generous for float descriptors, the
    # raw TH_HIGH for ORB; None picks by the profile
    refkf_max_dist: Optional[float] = None
    # keep anchoring the inertial chain with keyframes while RECENTLY_LOST
    # (IMU.InsertKFsWhenLost)
    insert_kfs_when_lost: bool = True
    # relocalization acceptance: inliers after the guided widening ladder
    reloc_min_inliers: int = 50

    def __post_init__(self):
        if self.refkf_max_dist is None:
            self.refkf_max_dist = (self.th_high if self.binary
                                   else self.th_low * 7)


class Tracking:
    def __init__(self, pipeline: FramePipeline, slam_map: SlamMap,
                 cam: camera_ops.Pinhole, config: TrackerConfig, atlas,
                 timer=None, retrieval=None, sensor: str = "rgbd",
                 imu_calib: Optional[imu_ops.ImuCalib] = None):
        """sensor: "rgbd" (RGB-D and stereo frames, which carry depth) or
        "mono". timer: an optional ``utils.timing.StageTimer`` that
        receives the spans ``track.frame_build`` (a frame built outside the
        frame step: ORB frames, and XFeat's first; the pipeline's own
        ``track.extract`` and ``track.stereo_match`` lie inside it),
        ``track.snapshot`` (the host's inputs of the frame step or of the
        tracking stages) and ``track.frame_step`` (the step or the stages,
        and their one host read). retrieval:
        the keyframe database that relocalization queries (loop closing's;
        None without it, and candidates come from a brute-force cosine over
        the keyframes' global descriptors). imu_calib: the IMU calibration
        of visual-inertial tracking (None without an IMU)."""
        if sensor not in ("rgbd", "mono"):
            raise ValueError(f"sensor {sensor!r}: 'rgbd' or 'mono'")
        self.sensor = sensor
        self.pipeline = pipeline
        self.map = slam_map
        self.timer = timer
        self.device = pipeline.extractor.device
        # on the card: the XFeat frame step's CUDA graph, and the two
        # tracking stages' graph for frames built outside the step (ORB);
        # the eager calls on the CPU
        self._xfeat = hasattr(pipeline.extractor, "model")
        on_card = self.device.type == "cuda"
        self._graph = (track_step.RgbdFrameStepGraph(pipeline.extractor.model)
                       if on_card and self._xfeat else None)
        self._stereo_graph = (
            track_step.StereoFrameStepGraph(pipeline.extractor.model)
            if on_card and self._xfeat else None)
        self._track_graph = (track_step.TwoStageTrackGraph(self.device)
                             if on_card else None)
        # inertial state (GrabImuData / PreintegrateIMU): the sample queue,
        # the preintegrations last KF -> last frame and last KF -> current
        # frame, and the marginalized last-frame prior (R_wb, p_wb, v_w, bg,
        # ba, sqrt-information (15,15), the map's change_index)
        self.imu_calib = imu_calib
        self.imu_queue: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self._pre_from_kf = None
        self._pre_cur = None
        self._frame_prior = None
        self._prior_pending = None
        # on the card: preintegration and both inertial pose LMs as CUDA
        # graphs
        inertial_card = on_card and imu_calib is not None
        self._pre_graph = (in_opt.InertialGraph(self.device,
                                                imu_ops.preintegrate)
                           if inertial_card else None)
        self._pose_inertial_graph = (
            in_opt.InertialGraph(self.device, in_opt.pose_inertial_flat)
            if inertial_card else None)
        self._pose_inertial_lf_graph = (
            in_opt.InertialGraph(self.device,
                                 in_opt.pose_inertial_last_frame_flat)
            if inertial_card else None)
        self.last_kf_id: Optional[int] = None  # most recent created KF
        self.retrieval = retrieval
        self.atlas = atlas
        self.cam = cam
        self.cfg = config
        if self.cfg.max_frames_between_kf is None:
            self.cfg.max_frames_between_kf = int(self.cfg.fps)
        self.state = State.NO_IMAGES
        self.last_frame: Optional[Frame] = None
        self.velocity: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.ref_kf: Optional[int] = None
        self.last_kf_frame_id = 0
        self.next_kf_id = 0
        self.matches_inliers = 0
        self.lost_since: Optional[float] = None
        # localization mode (mbOnlyTracking): pose tracking runs, keyframe
        # insertion and map growth do not
        self.only_tracking = False
        # mbVO: in localization mode, the last pose solve held fewer than
        # 10 map-point inliers, so tracking rides on the last frame's depth
        # points off the mapped area
        self.vo_mode = False
        # track-time trajectory log (timestamp, R, t, state); the savers
        # use resolved_trajectory() instead
        self.trajectory: List[Tuple[float, np.ndarray, np.ndarray, State]] = []
        # relative log for save-time re-basing (mlRelativeFramePoses):
        # (timestamp, state, map_id, ref_kid, R_rel, t_rel, R_abs, t_abs)
        self.traj_rel: List[tuple] = []
        self.new_keyframes: List[int] = []  # queue for local mapping
        self.stats = {"motion_ok": 0, "refkf_ok": 0, "local_fail": 0, "kfs": 0}
        self._rel_pose = None
        self._last_local_ids = None
        self._last_n_matched = 0
        # monocular initialization's held reference frame
        self._mono_init_frame: Optional[Frame] = None

    def _t(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------ API

    def grab_rgbd(self, gray, depth_raw, timestamp, imu=None):
        """imu: the (acc (3,), gyro (3,), t) samples since the previous
        frame; a tracker without ``imu_calib`` queues and never reads
        them, as the JAX package's does."""
        self._queue_imu(imu)
        frame = self._grab_rgbd_fused(gray, depth_raw, timestamp)
        if frame is None:
            with self._span("track.frame_build"):
                frame = self.pipeline.build_rgbd(gray, depth_raw, timestamp)
        return self._track(frame)

    def grab_stereo(self, gray_l, gray_r, timestamp, imu=None):
        """A rectified stereo pair (GrabImageStereo): the stereo frame step
        first (XFeat), else the pair built by ``build_stereo``; stereo depth
        then drives the RGB-D initialization and point creation. imu: as
        grab_rgbd's."""
        self._queue_imu(imu)
        frame = self._grab_stereo_fused(gray_l, gray_r, timestamp)
        if frame is None:
            with self._span("track.frame_build"):
                frame = self.pipeline.build_stereo(gray_l, gray_r, timestamp)
        return self._track(frame)

    def grab_mono(self, gray, timestamp, imu=None):
        """A monocular frame: the frame step without depth first, as
        grab_rgbd (imu: as grab_rgbd's)."""
        self._queue_imu(imu)
        frame = self._grab_rgbd_fused(gray, None, timestamp)
        if frame is None:
            with self._span("track.frame_build"):
                frame = self.pipeline.build_mono(gray, timestamp)
        return self._track(frame)

    def grab_imu(self, acc, gyro, timestamp: float):
        """GrabImuData: enqueue one IMU sample (body-frame acc m/s^2, gyro
        rad/s)."""
        self.imu_queue.append((float(timestamp),
                               np.asarray(acc, np.float32),
                               np.asarray(gyro, np.float32)))

    def _queue_imu(self, imu):
        if imu:
            for (acc, gyro, t) in imu:
                self.grab_imu(acc, gyro, t)

    def _fused_grab_setup(self, timestamp):
        """Preconditions and speculative inputs of the whole-frame step: the
        XFeat backend (float descriptors), a pinhole camera, OK state, no
        IMU, a monotonic timestamp; the motion-model pose prediction and the
        stage-1 / stage-2 snapshots voted from the LAST frame's bindings."""
        last = self.last_frame
        if (self.state != State.OK or self.imu_calib is not None
                or self.only_tracking or last is None
                or last.R is None or self.cfg.binary or not self._xfeat
                or timestamp < last.timestamp  # would start a new map
                or type(self.cam) is not camera_ops.Pinhole):
            return None
        ids = self._local_map_points(last)
        if ids is None or len(ids) == 0:
            return None
        if self.velocity is not None:
            Rv, tv = self.velocity
            R0 = lie.np_normalize_rotation(Rv @ last.R)
            t0 = (Rv @ last.t + tv).astype(np.float32)
        else:
            R0, t0 = last.R.copy(), last.t.copy()
        bound = (last.mp_ids >= 0) & last.inlier
        safe1 = np.where(bound, last.mp_ids, 0)
        valid1 = bound & self.map.points.alive[safe1]
        ids1 = np.where(valid1, last.mp_ids, -1)
        pos, desc, valid2, padded_ids = self.map.point_snapshot(
            ids, LOCAL_MP_BUCKET)
        safe2 = np.clip(padded_ids, 0, None)
        return (R0, t0, ids, ids1, safe1, valid1, pos, desc, valid2,
                padded_ids, safe2)

    def _grab_rgbd_fused(self, gray, depth_raw, timestamp) -> Optional[Frame]:
        """Speculative whole-frame grab: extraction, undistortion, the depth
        gate and both tracking stages in one device call (the frame step's
        CUDA graph on the card, the eager step on the CPU) and one host
        transfer. Returns a Frame with the two-stage result stashed for
        _track_frame_fused, or None when the preconditions do not hold
        (then the frame is built and tracked the split way). Without
        ``depth_raw`` the step runs its monocular configuration."""
        with self._span("track.snapshot"):
            setup = self._fused_grab_setup(timestamp)
            if setup is None:
                return None
            # the monocular step ignores its depth input
            depth_m = (np.zeros((1, 1), np.float32) if depth_raw is None
                       else self.pipeline.depth_meters(depth_raw))
            tensors, (ids, ids1, padded_ids, R0, t0) = self._step_inputs(
                setup)
            tensors = [image_ops.to_float_image(gray, self.device),
                       self._t(depth_m)] + tensors
        cfg = self.cfg
        scalars = (self.cam, self.pipeline.bf, DEPTH_EDGE_REL,
                   1.0 / cfg.obs_sigma ** 2, cfg.motion_radius,
                   cfg.local_radius, cfg.th_high, 0.9,
                   cfg.min_inliers_motion, cfg.scale_factor,
                   2.0 * float(self.cam.cx), 2.0 * float(self.cam.cy))
        kw = dict(num_keypoints=self.pipeline.extractor.nfeatures,
                  n_levels=cfg.n_levels, has_depth=depth_raw is not None)
        with self._span("track.frame_step"):
            if self._graph is not None:
                res = self._graph(*tensors, *scalars, **kw)
            else:
                res = track_step.xfeat_rgbd_frame_step(
                    self.pipeline.extractor.model, *tensors, *scalars, **kw)
            out, r1, r2 = fetch(res)
        frame = self.pipeline.assemble_rgbd(out, timestamp)
        frame.R, frame.t = R0, t0
        frame._fused_pending = (r1, r2, ids, ids1, padded_ids)
        self.stats["fused_grab"] = self.stats.get("fused_grab", 0) + 1
        return frame

    def _span(self, name):
        return (self.timer.span(name) if self.timer is not None
                else contextlib.nullcontext())

    def _grab_stereo_fused(self, gray_l, gray_r, timestamp) -> Optional[Frame]:
        """Speculative whole-frame stereo grab: both views as one batch of
        2, row-band stereo matching, the depth and both tracking stages in
        one device call (``StereoFrameStepGraph`` on the card, the eager
        ``xfeat_stereo_frame_step`` on the CPU) and one host transfer. The
        same contract as ``_grab_rgbd_fused``: None before initialization,
        for ORB, or when the two images differ in size, and then the pair
        is built by ``build_stereo``."""
        if gray_l.shape != gray_r.shape:
            return None
        with self._span("track.snapshot"):
            setup = self._fused_grab_setup(timestamp)
            if setup is None:
                return None
            tensors, (ids, ids1, padded_ids, R0, t0) = self._step_inputs(
                setup)
            images = torch.cat([image_ops.to_float_image(g, self.device)
                                for g in (gray_l, gray_r)])
            tensors = [images] + tensors
        cfg = self.cfg
        scalars = (self.cam, self.pipeline.bf, STEREO_MIN_DISP,
                   STEREO_MAX_DISP, STEREO_TH_XFEAT,
                   1.0 / cfg.obs_sigma ** 2, cfg.motion_radius,
                   cfg.local_radius, cfg.th_high, 0.9,
                   cfg.min_inliers_motion, cfg.scale_factor,
                   2.0 * float(self.cam.cx), 2.0 * float(self.cam.cy))
        kw = dict(num_keypoints=self.pipeline.extractor.nfeatures,
                  n_levels=cfg.n_levels)
        with self._span("track.frame_step"):
            if self._stereo_graph is not None:
                res = self._stereo_graph(*tensors, *scalars, **kw)
            else:
                res = track_step.xfeat_stereo_frame_step(
                    self.pipeline.extractor.model, *tensors, *scalars, **kw)
            out, r1, r2 = fetch(res)
        frame = self.pipeline.assemble_rgbd(out, timestamp)
        frame.R, frame.t = R0, t0
        frame._fused_pending = (r1, r2, ids, ids1, padded_ids)
        self.stats["fused_grab"] = self.stats.get("fused_grab", 0) + 1
        return frame

    def _step_inputs(self, setup):
        """The frame step's tensor arguments after the image (and depth),
        on the device."""
        (R0, t0, ids, ids1, safe1, valid1, pos, desc, valid2, padded_ids,
         safe2) = setup
        pts = self.map.points
        tensors = [
            self._t(R0), self._t(t0),
            self._t(pts.pos[safe1]), self._t(pts.desc[safe1]),
            self._t(valid1), self._t(pts.angle[safe1]),
            self._t(self.last_frame.octave.astype(np.int32)),
            self._t(ids1.astype(np.int32)),
            self._t(pos), self._t(desc), self._t(valid2),
            self._t(pts.angle[safe2]),
            self._t(pts.octave[safe2].astype(np.int32)),
            self._t(padded_ids.astype(np.int32)), self._t(pts.dmax[safe2]),
        ]
        return tensors, (ids, ids1, padded_ids, R0, t0)

    # ------------------------------------------------------------ internals

    def _current_bias(self):
        kf = self.map.keyframes.get(self.last_kf_id)
        if kf is not None and kf.bg is not None:
            return kf.bg, kf.ba
        return self.map.imu_bg, self.map.imu_ba

    def _preintegrate(self, frame: Frame):
        """PreintegrateIMU: integrate the queued samples in (t_last, t_cur]
        at the current bias estimate; keep both the last-frame segment and
        the accumulation from the last keyframe."""
        t_cur = frame.timestamp
        if self.last_frame is None:
            self.imu_queue = [s for s in self.imu_queue if s[0] > t_cur]
            frame.pre_last = None
            self._pre_cur = None
            return
        t_prev = self.last_frame.timestamp
        take = [s for s in self.imu_queue if t_prev < s[0] <= t_cur + 1e-9]
        self.imu_queue = [s for s in self.imu_queue if s[0] > t_cur + 1e-9]
        seg = None
        if take:
            bg, ba = self._current_bias()
            ts = np.array([s[0] for s in take])
            dts = np.diff(np.concatenate([[t_prev], ts])).astype(np.float32)
            seg = imu_ops.preintegrate_segment(
                np.stack([s[1] for s in take]),
                np.stack([s[2] for s in take]),
                dts, bg, ba, self.imu_calib, device=self.device,
                graph=self._pre_graph)
        frame.pre_last = seg
        if seg is not None:
            if self._pre_from_kf is None:
                self._pre_cur = seg
            else:
                self._pre_cur = imu_ops.to_numpy(imu_ops.merge_previous(
                    imu_ops.to_tensors(self._pre_from_kf, "cpu"),
                    imu_ops.to_tensors(seg, "cpu")))
        else:
            self._pre_cur = self._pre_from_kf

    def _track(self, frame: Frame):
        if self._check_timestamp_jump(frame):
            self.last_frame = frame
            return self.state, None
        self._prior_pending = None  # only this frame's solve may set it
        if self.imu_calib is not None:
            self._preintegrate(frame)
        if self.state in (State.NO_IMAGES, State.NOT_INITIALIZED):
            self.state = State.NOT_INITIALIZED
            init = (self._initialize_rgbd(frame) if self.sensor == "rgbd"
                    else self._initialize_mono(frame))
            if init:
                self.state = State.OK
        elif self.state == State.LOST:
            if self._relocalization(frame):
                self.state = State.OK
                self._update_velocity(frame)
                self._store_relative_pose(frame)
            else:
                self._handle_lost_map(frame)
        else:
            ok = False
            local_done = False
            if self.state == State.OK:
                # fast path: both tracking stages in one device call; None
                # falls back to the split path below
                if self._track_frame_fused(frame):
                    ok = local_done = True
                else:
                    ok = self._track_with_motion_model(frame)
                    if ok:
                        self.stats["motion_ok"] += 1
                    else:
                        ok = self._track_reference_keyframe(frame)
                        if ok:
                            self.stats["refkf_ok"] += 1
            elif self.state == State.RECENTLY_LOST:
                ok = self._track_with_motion_model(frame)
                if not ok:
                    ok = self._track_reference_keyframe(frame)
                if not ok:
                    ok = self._relocalization(frame)
                    if ok:
                        self.stats["reloc_ok"] = self.stats.get(
                            "reloc_ok", 0) + 1

            if self.only_tracking and self.vo_mode:
                # mbVO: the map is out of view; dead-reckon on the last
                # frame's depth points while trying to relocalize every
                # frame, and re-attach when that succeeds
                mm = None
                if ok and frame.R is not None:
                    mm = (frame.R.copy(), frame.t.copy(),
                          frame.mp_ids.copy(), frame.inlier.copy(), self.map)
                if self._relocalization(frame):
                    self.vo_mode = False
                    ok = True
                elif mm is not None:
                    # keep the motion-model result: a failed attempt moves
                    # the frame's pose and bindings
                    frame.R, frame.t, frame.mp_ids, frame.inlier, m_mm = mm
                    if self.map is not m_mm:
                        self.atlas.change_map(m_mm.map_id)
                        self.map = m_mm
            if ok and not local_done and not (self.only_tracking
                                              and self.vo_mode):
                ok = self._track_local_map(frame)
                if not ok:
                    self.stats["local_fail"] += 1

            if ok:
                self.state = State.OK
                self.lost_since = None
                self._update_velocity(frame)
                # localization mode never inserts keyframes or map points
                if not self.only_tracking and self._need_new_keyframe(frame):
                    self._create_keyframe(frame)
                self._store_relative_pose(frame)
            else:
                if self.state == State.OK:
                    self.state = State.RECENTLY_LOST
                    self.lost_since = frame.timestamp
                elif self.state == State.RECENTLY_LOST:
                    if (frame.timestamp - self.lost_since
                            > self.cfg.recently_lost_seconds):
                        self.state = State.LOST
                # hold the last pose while lost
                if frame.R is None and self.last_frame is not None:
                    frame.R = self.last_frame.R.copy()
                    frame.t = self.last_frame.t.copy()
                self.velocity = None
                # inertial: keep anchoring the preintegration chain with
                # keyframes at the IMU-predicted pose, so the map can absorb
                # the dead-reckoned stretch once tracking recovers
                # (InsertKFsWhenLost)
                last_kf = self.map.keyframes.get(self.last_kf_id)
                if (self.state == State.RECENTLY_LOST
                        and self.cfg.insert_kfs_when_lost
                        and not self.only_tracking
                        and self.imu_calib is not None
                        and self.map.imu_initialized
                        and frame.R is not None
                        and self._pre_cur is not None
                        and last_kf is not None
                        and frame.timestamp - last_kf.timestamp >= 0.25):
                    self._create_keyframe(frame)

        if frame.R is not None:
            self.trajectory.append(
                (frame.timestamp, frame.R.copy(), frame.t.copy(), self.state)
            )
            self._log_relative_pose(frame)
        self.last_frame = frame
        if self.imu_calib is not None:
            # roll the from-last-KF accumulation forward (None right after a
            # keyframe was made from this frame: the accumulator restarts)
            self._pre_from_kf = self._pre_cur
        # this frame's marginalized posterior becomes the next frame's
        # prior; a failed frame breaks the chain
        self._frame_prior = (self._prior_pending if self.state == State.OK
                             else None)
        pose = (frame.R, frame.t) if frame.R is not None else None
        return self.state, pose

    def _relocalization(self, frame: Frame) -> bool:
        """Relocalization (Tracking::Relocalization): retrieval candidates,
        descriptor matching against each candidate keyframe's map points,
        PnP RANSAC, the pose LM and the guided widening ladder; accepted
        with ``reloc_min_inliers`` inliers. The active map first, then the
        atlas's stored maps; tracking switches into the map that
        relocalizes. The RANSAC draws come from a generator seeded by the
        frame id."""
        maps = [self.atlas.active] + [
            m for m in self.atlas.all_maps() if m is not self.atlas.active]
        if int(frame.valid.sum()) < 30:
            return False
        g = aggregate_global_desc(frame.desc, frame.valid)
        for m in maps:
            cands = []
            if self.retrieval is not None and m is self.map:
                # covisibility-group scoring with a relative cutoff
                # (KeyFrameDatabase::DetectRelocalizationCandidates)
                cands = [k for k, _s in self.retrieval.query_grouped(
                    g, set(), covisibles=m.covisible_kfs, top_n=5,
                    min_score=0.3, map_id=m.map_id)]
            if not cands:
                # brute-force cosine over the map's keyframes
                sims = sorted(((float(k.global_desc @ g), k.kid)
                               for k in m.keyframes.values()), reverse=True)
                cands = [kid for _s, kid in sims[:3]]
            for kid in cands:
                if self._reloc_candidate(frame, m, kid):
                    return True
        return False

    def _reloc_candidate(self, frame: Frame, m: SlamMap, kid: int) -> bool:
        """One candidate keyframe of the relocalization search."""
        kf = m.keyframes.get(kid)
        if kf is None:
            return False
        bound = kf.mp_ids >= 0
        valid_kf = bound & kf.valid & m.points.alive[
            np.where(bound, kf.mp_ids, 0)]
        res = matching.match_general(
            self._t(kf.desc), self._t(valid_kf), self._t(frame.desc),
            self._t(frame.valid), max_dist=self.cfg.refkf_max_dist,
            ratio=0.75, binary=self.cfg.binary)
        idx, mask = fetch((res.idx, res.mask))
        mask = matching.rotation_consistency_filter(
            kf.angle, frame.angle, np.clip(idx, 0, None), mask)
        if mask.sum() < 15:
            return False
        Xw = m.points.pos[np.where(mask, kf.mp_ids, 0)]
        uv = frame.kpts_un[np.clip(idx, 0, None)]
        gen = torch.Generator(device=self.device).manual_seed(frame.fid)
        pr = fetch(pnp.pnp_ransac(
            self._t(np.where(mask[:, None], Xw, 0).astype(np.float32)),
            self._t(np.where(mask[:, None], uv, 0).astype(np.float32)),
            self._t(mask), self.cam, generator=gen, min_inliers=12))
        if not bool(pr.success):
            return False
        frame.R = np.asarray(pr.R)
        frame.t = np.asarray(pr.t)
        frame.mp_ids[:] = -1
        keep = mask & pr.inliers
        frame.mp_ids[idx[keep]] = kf.mp_ids[keep]
        if m is not self.map:
            self.atlas.change_map(m.map_id)
            self.map = m
        # visual only: the IMU anchor is dead-reckoned from the lost
        # stretch and would drag the candidate pose back toward it
        inl = self._pose_optimize(frame, visual_only=True)
        # the guided widening ladder: short of 50 inliers, re-search the
        # candidate's neighbourhood by projection in a wide window and
        # re-optimize; a second narrow round when close
        if inl < 50:
            if self._reloc_widen(frame, m, kid, radius=10.0, dist_scale=2.0):
                inl = self._pose_optimize(frame, visual_only=True)
            if 30 <= inl < 50:
                if self._reloc_widen(frame, m, kid, radius=3.0,
                                     dist_scale=1.28):
                    inl = self._pose_optimize(frame, visual_only=True)
        if inl >= self.cfg.reloc_min_inliers:
            self.ref_kf = kid
            self.lost_since = None
            return True
        return False

    RELOC_WIDEN_BUCKET = 2048  # static candidate count of a widening round

    def _reloc_widen(self, frame: Frame, m: SlamMap, kid: int, radius: float,
                     dist_scale: float) -> bool:
        """One guided re-search round of the ladder (SearchByProjection,
        frame against keyframe): project the map points of the candidate
        and its covisible keyframes at the current pose and bind matches
        into free keypoint slots. Returns True if anything bound."""
        kf = m.keyframes.get(kid)
        if kf is None:
            return False
        mp_ids = [int(x) for x in kf.mp_ids[kf.mp_ids >= 0]]
        for ck in m.covisible_kfs(kid, 10):
            ckf = m.keyframes.get(ck)
            if ckf is not None:
                mp_ids.extend(int(x) for x in ckf.mp_ids[ckf.mp_ids >= 0])
        mp_ids = [mp for mp in dict.fromkeys(mp_ids) if m.points.alive[mp]]
        B = self.RELOC_WIDEN_BUCKET
        if len(mp_ids) > B:
            from ..utils import verbose

            verbose.print_mess(
                f"reloc widen cap hit: {B} of {len(mp_ids)} candidates",
                verbose.Level.VERBOSE)
            mp_ids = mp_ids[:B]
        if not mp_ids:
            return False
        Xc = m.points.pos[mp_ids] @ frame.R.T + frame.t
        z = Xc[:, 2]
        vis = z > 0.05
        zs = np.where(vis, z, 1.0)
        uv = np.stack([float(self.cam.fx) * Xc[:, 0] / zs + float(self.cam.cx),
                       float(self.cam.fy) * Xc[:, 1] / zs + float(self.cam.cy)],
                      -1).astype(np.float32)
        already = set(int(x) for x in frame.mp_ids[frame.mp_ids >= 0])
        M = len(mp_ids)
        cand = np.zeros(B, bool)
        cand[:M] = vis & np.array([mp not in already for mp in mp_ids])
        uv_pad = np.zeros((B, 2), np.float32)
        uv_pad[:M] = uv
        desc_pad = np.zeros((B, m.points.desc.shape[1]), np.float32)
        desc_pad[:M] = m.points.desc[mp_ids]
        res = matching.search_by_projection(
            self._t(uv_pad), self._t(desc_pad), self._t(cand),
            self._t(frame.kpts_un), self._t(frame.desc),
            self._t(frame.valid), radius=radius,
            max_dist=self.cfg.th_low * dist_scale, ratio=0.9,
            kpt_free=self._t(frame.mp_ids < 0), binary=self.cfg.binary)
        idx, mask = fetch((res.idx, res.mask))
        bound = False
        for i in np.nonzero(mask)[0]:
            slot = int(idx[i])
            if frame.mp_ids[slot] < 0:
                frame.mp_ids[slot] = mp_ids[i]
                bound = True
        return bound

    # -- initialization ------------------------------------------------------

    def _unproject(self, kpts_un):
        """Unit-plane rays (K,3) of undistorted pixels, float32."""
        return camera_ops.pinhole_unproject(
            self.cam, torch.from_numpy(kpts_un)).numpy()

    def _initialize_rgbd(self, frame: Frame) -> bool:
        """StereoInitialization: enough valid keypoints; every keypoint with
        depth becomes a map point; the frame pose is the identity."""
        has_depth = frame.valid & (frame.depth > 0)
        if self.cfg.th_far_points is not None:
            has_depth &= frame.depth < self.cfg.th_far_points
        if frame.n_valid <= self.cfg.min_init_points or has_depth.sum() < 100:
            return False
        frame.R = np.eye(3, dtype=np.float32)
        frame.t = np.zeros(3, np.float32)
        kf = self._make_keyframe(frame)
        ray = self._unproject(frame.kpts_un)
        for slot in np.nonzero(has_depth)[0]:
            X = ray[slot] * frame.depth[slot]
            mp = self.map.create_point(X.astype(np.float32), frame.desc[slot],
                                       kf.kid, float(frame.angle[slot]),
                                       octave=int(frame.octave[slot]),
                                       dist_ref=float(np.linalg.norm(X)))
            self.map.add_observation(mp, kf.kid, int(slot), update_links=False)
            frame.mp_ids[slot] = mp
        self.map.update_connections(kf.kid)
        frame.inlier = frame.mp_ids >= 0
        self.ref_kf = kf.kid
        self.last_kf_frame_id = frame.fid
        return True

    # -- monocular initialization ---------------------------------------------

    def _initialize_mono(self, frame: Frame) -> bool:
        """MonocularInitialization + CreateInitialMapMonocular: hold a
        reference frame, window-match against it, reconstruct the two views
        (H/F RANSAC), make two keyframes and the triangulated points,
        normalize by the median scene depth and refine with a global BA."""
        if frame.n_valid <= 100:
            self._mono_init_frame = None
            return False
        ref = self._mono_init_frame
        if ref is None or ref.n_valid <= 100:
            self._hold_mono_init_frame(frame)
            return False
        res = fetch(matching.search_window(
            self._t(ref.kpts_un), self._t(ref.desc), self._t(ref.valid),
            self._t(frame.kpts_un), self._t(frame.desc),
            self._t(frame.valid), radius=100.0,
            max_dist=(self.cfg.th_low if self.cfg.binary
                      else self.cfg.th_low * 6),
            ratio=0.9, binary=self.cfg.binary))
        idx = res.idx
        mask = matching.rotation_consistency_filter(
            ref.angle, frame.angle, np.clip(idx, 0, None), res.mask)
        if mask.sum() < 100:  # the reference asks for >= 100 matches
            self._hold_mono_init_frame(frame)
            return False

        uv1 = np.where(mask[:, None], ref.kpts_un, 0).astype(np.float32)
        uv2 = np.where(mask[:, None], frame.kpts_un[np.clip(idx, 0, None)],
                       0).astype(np.float32)
        gen = torch.Generator(device=self.device).manual_seed(frame.fid)
        valid = self._t(mask)
        tv = fetch(two_view.reconstruct_two_views(
            self._t(uv1), self._t(uv2), valid, self.cam.K.to(self.device),
            idx=two_view.draw_minimal_sets(valid, gen)))
        good = tv.good & mask
        X = tv.points
        # median-depth normalization (CreateInitialMapMonocular)
        med_depth = (float(np.median(X[good][:, 2])) if bool(tv.success)
                     else 0.0)
        if med_depth <= 0:
            # the reference is kept: counted, since kf2's IMU edge then
            # spans more than the frame's last segment (ROADMAP C.18)
            self.stats["two_view_fail"] = (
                self.stats.get("two_view_fail", 0) + 1)
            return False
        X = X / med_depth
        ref.R = np.eye(3, dtype=np.float32)
        ref.t = np.zeros(3, np.float32)
        frame.R = tv.R.astype(np.float32)
        frame.t = (tv.t / med_depth).astype(np.float32)

        # the preintegration from the held reference frame to this one
        pre_init = self._pre_cur
        kf1 = self._make_keyframe(ref)
        kf2 = self._make_keyframe(frame)
        if self.imu_calib is not None:
            # the IMU chain starts at kf1; the kf1 -> kf2 edge is the
            # accumulation since the reference frame (the frame's own
            # last-frame segment when the reference is the previous frame)
            kf1.pre_kf = None
            kf1.prev_kf = -1
            kf2.pre_kf = pre_init
            kf2.prev_kf = kf1.kid
        for slot1 in np.nonzero(good)[0]:
            slot2 = int(idx[slot1])
            mp = self.map.create_point(X[slot1].astype(np.float32),
                                       ref.desc[slot1], kf1.kid,
                                       float(ref.angle[slot1]))
            self.map.add_observation(mp, kf1.kid, int(slot1),
                                     update_links=False)
            self.map.add_observation(mp, kf2.kid, slot2, update_links=False)
            self.map.update_point(mp)
            frame.mp_ids[slot2] = mp
        self.map.update_connections(kf1.kid)
        self.map.update_connections(kf2.kid)
        frame.inlier = frame.mp_ids >= 0

        # global BA over the two-keyframe map (GlobalBundleAdjustemnt(20))
        self._initial_gba(kf1, kf2)
        self.ref_kf = kf2.kid
        self.last_kf_frame_id = frame.fid
        self._mono_init_frame = None
        return True

    def _hold_mono_init_frame(self, frame: Frame):
        """Make ``frame`` the reference of the next two-view attempts. With
        an IMU the accumulation restarts at it, so the initial keyframe
        pair's edge spans exactly the reference frame to the second."""
        self._mono_init_frame = frame
        if self.imu_calib is not None:
            self._pre_cur = None

    # the initial GBA's padded problem: 4 cameras (2 used), 1024 points,
    # 2048 observations
    INIT_GBA_SHAPE = (4, 1024, 2048)

    def _initial_gba(self, kf1, kf2):
        """Bundle-adjust the initial pair (kf1 fixed) over the points kf2
        sees, at most INIT_GBA_SHAPE's, both stages of 10 LM iterations."""
        pt_ids = [int(m) for m in kf2.mp_ids[kf2.mp_ids >= 0]]
        if len(pt_ids) < 20:
            return
        C, P, O = self.INIT_GBA_SHAPE
        if len(pt_ids) > P:
            from ..utils import verbose

            verbose.print_mess(
                f"mono-init GBA point cap hit: {P} of {len(pt_ids)} points",
                verbose.Level.VERBOSE)
        obs_cam, obs_pt, uv = [], [], []
        pt_index = {mp: i for i, mp in enumerate(pt_ids[:P])}
        for mp, i in pt_index.items():
            for kid, slot in self.map.obs.get(mp, {}).items():
                obs_cam.append(0 if kid == kf1.kid else 1)
                obs_pt.append(i)
                uv.append(self.map.keyframes[kid].kpts_un[slot])
        n_obs = len(obs_cam)

        def pad(a, n, fill=0, dtype=None):
            a = np.asarray(a, dtype)
            out = np.full((n,) + a.shape[1:], fill, a.dtype)
            out[: len(a)] = a
            return out

        obs_cam = pad(obs_cam, O, 0, np.int32)
        obs_pt = pad(obs_pt, O, 0, np.int32)
        valid = pad(np.ones(n_obs, bool), O, False)
        eye = np.eye(3, dtype=np.float32)
        prob = local_ba.BAProblem(
            R=self._t(np.stack([kf1.R, kf2.R] + [eye] * (C - 2))),
            t=self._t(np.stack([kf1.t, kf2.t]
                               + [np.zeros(3, np.float32)] * (C - 2))),
            fixed=self._t(np.array([True, False] + [True] * (C - 2))),
            cam_valid=self._t(np.array([True, True] + [False] * (C - 2))),
            X=self._t(pad(self.map.points.pos[pt_ids[:P]], P, 0,
                          np.float32)),
            p_valid=self._t(pad(np.ones(len(pt_index), bool), P, False)),
            obs_cam=self._t(obs_cam), obs_pt=self._t(obs_pt),
            uv=self._t(pad(uv, O, 0.0, np.float32)),
            ur=self._t(np.zeros(O, np.float32)),
            stereo=self._t(np.zeros(O, bool)), valid=self._t(valid),
            inv_sigma2=self._t(np.full(O, 1.0 / self.cfg.obs_sigma ** 2,
                                       np.float32)),
            plan=(local_ba.segment_plan(obs_cam, obs_pt, valid, C, P,
                                        self.device)
                  if self.device.type == "cuda" else None))
        res = fetch(local_ba.bundle_adjust(prob, self.cam, 0.0,
                                           stage_iters=(10, 10)))
        kf2.R = res.R[1]
        kf2.t = res.t[1]
        self.map.points.pos[pt_ids[:P]] = res.X[: len(pt_index)]

    # -- pose tracking -------------------------------------------------------

    def _imu_anchor(self):
        """The inertial anchor state: the most recent keyframe with a
        velocity estimate (mpLastKeyFrame). Returns (kf, R_wb, p_wb), or
        None before IMU initialization."""
        if not (self.imu_calib is not None and self.map.imu_initialized):
            return None
        kf = self.map.keyframes.get(self.last_kf_id)
        if kf is None or kf.vel is None or self._pre_cur is None:
            return None
        cal = self.imu_calib
        R_wb, p_wb = np_cam_to_body(kf.R, kf.t, cal.R_bc, cal.t_bc)
        return kf, R_wb, p_wb

    def _predict_pose(self, frame: Frame):
        anchor = self._imu_anchor()
        if anchor is not None:
            # PredictStateIMU: the last keyframe's state propagated through
            # the accumulated preintegration at the keyframe's bias
            kf, R_wb, p_wb = anchor
            cal = self.imu_calib
            R0, p0, v0, bg, ba = (torch.from_numpy(np.asarray(a, np.float32))
                                  for a in (R_wb, p_wb, kf.vel, kf.bg, kf.ba))
            R_nb, p_nb, v_nb = imu_ops.predict_state(
                R0, p0, v0, imu_ops.to_tensors(self._pre_cur, "cpu"), bg, ba)
            R_nb = lie.np_normalize_rotation(R_nb.numpy())
            frame.R, frame.t = np_body_to_cam(R_nb, p_nb.numpy(), cal.R_bc,
                                              cal.t_bc)
            frame.v_w = v_nb.numpy().astype(np.float32)
            frame.bg = kf.bg.copy()
            frame.ba = kf.ba.copy()
            return
        if self.velocity is not None:
            Rv, tv = self.velocity
            # the SO3 projection keeps float32 orthonormality error from
            # compounding through the velocity feedback loop
            frame.R = lie.np_normalize_rotation(Rv @ self.last_frame.R)
            frame.t = (Rv @ self.last_frame.t + tv).astype(np.float32)
        else:
            frame.R = self.last_frame.R.copy()
            frame.t = self.last_frame.t.copy()

    def _project_points(self, R, t, pos):
        """Host frustum check and pixel prediction (Frame::isInFrustum).
        Returns (uv (M,2), visible (M,))."""
        Xc = pos @ R.T + t
        z = Xc[:, 2]
        ok = z > 0.05
        zs = np.where(ok, z, 1.0)
        fx, fy = float(self.cam.fx), float(self.cam.fy)
        cx, cy = float(self.cam.cx), float(self.cam.cy)
        u = fx * Xc[:, 0] / zs + cx
        v = fy * Xc[:, 1] / zs + cy
        ok &= (u >= -20) & (u < cx * 2 + 20) & (v >= -20) & (v < cy * 2 + 20)
        return np.stack([u, v], -1).astype(np.float32), ok

    def _pose_optimize(self, frame: Frame, visual_only: bool = False) -> int:
        bound = frame.mp_ids >= 0
        ids = np.where(bound, frame.mp_ids, 0)
        Xw = self.map.points.pos[ids]
        alive = self.map.points.alive[ids]
        valid = bound & frame.valid & alive
        is_stereo = valid & (frame.ur > 0)
        anchor = None if visual_only else self._imu_anchor()
        if anchor is not None:
            return self._pose_optimize_inertial(frame, anchor, Xw, is_stereo,
                                                valid)
        res = fetch(pose_opt.pose_optimization(
            self._t(frame.R), self._t(frame.t), self._t(Xw),
            self._t(frame.kpts_un), self._t(frame.ur),
            self._t(self._inv_sigma2(frame)), self._t(is_stereo),
            self._t(valid), self.cam, self.pipeline.bf,
        ))
        frame.R = lie.np_normalize_rotation(res.R)
        frame.t = np.asarray(res.t)
        frame.inlier = res.inliers
        # drop outlier bindings
        frame.mp_ids = np.where(frame.inlier, frame.mp_ids, -1)
        return int(res.num_inliers)

    def _pose_optimize_inertial(self, frame: Frame, anchor, Xw, is_stereo,
                                valid) -> int:
        """PoseInertialOptimization: the joint 15-D body state from the
        reprojection edges and an inertial edge. When the map has not
        changed since the previous frame solved, the LastFrame variant runs
        (the previous frame a free state under its marginalized prior,
        Schur-eliminated after); otherwise the solve anchors to the last
        keyframe (the reference's mbMapUpdated switch). On the card each
        variant replays its CUDA graph."""
        kf, R_wb_i, p_wb_i = anchor
        cal = self.imu_calib
        R_wb_j, p_wb_j = np_cam_to_body(frame.R, frame.t, cal.R_bc, cal.t_bc)
        v_j = frame.v_w if frame.v_w is not None else kf.vel
        prior = self._frame_prior
        use_prior = (prior is not None and frame.pre_last is not None
                     and float(frame.pre_last.dt) > 0
                     and self.map.change_index == prior[-1])
        t = self._t
        visual = (t(Xw.astype(np.float32)), t(frame.kpts_un), t(frame.ur),
                  t(self._inv_sigma2(frame)), t(is_stereo), t(valid),
                  t(cal.R_bc.astype(np.float32)),
                  t(cal.t_bc.astype(np.float32)))
        if use_prior:
            (Rp, pp, vp, bgp, bap, Lp, _chg) = prior
            states = (R_wb_j, p_wb_j, v_j, bgp, bap, Rp, pp, vp, bgp, bap, Lp)
            pre = imu_ops.to_tensors(frame.pre_last, self.device)
            fn, graph = (in_opt.pose_inertial_last_frame_flat,
                         self._pose_inertial_lf_graph)
        else:
            # the accumulated preintegration re-linearized at the anchor's
            # bias, so the bias-walk edge measures drift from the KF's bias
            pre = imu_ops.relinearize(
                imu_ops.to_tensors(self._pre_cur, self.device),
                t(kf.bg), t(kf.ba))
            states = (R_wb_j, p_wb_j, v_j, kf.bg, kf.ba, R_wb_i, p_wb_i,
                      kf.vel)
            fn, graph = (in_opt.pose_inertial_flat, self._pose_inertial_graph)
        # bf last, as a 0-d tensor: not a key of the graph
        bf = torch.tensor(float(self.pipeline.bf), device=self.device)
        flat = (tuple(t(np.asarray(a, np.float32)) for a in states)
                + tuple(pre) + visual + (bf,))
        static = dict(cam=self.cam)
        res = graph(flat, **static) if graph is not None else fn(*flat,
                                                                 **static)
        res = fetch(res)
        R_wb = lie.np_normalize_rotation(res.R_wb)
        frame.R, frame.t = np_body_to_cam(R_wb, res.p_wb, cal.R_bc, cal.t_bc)
        frame.v_w = np.asarray(res.v_w, np.float32)
        frame.bg = np.asarray(res.bg, np.float32)
        frame.ba = np.asarray(res.ba, np.float32)
        frame.inlier = res.inliers
        frame.mp_ids = np.where(frame.inlier, frame.mp_ids, -1)
        # the solved posterior becomes the next frame's prior (promoted at
        # the frame's end: a second solve within this frame must still see
        # the previous frame's prior)
        H = np.asarray(res.H, np.float64)
        try:
            L = np.linalg.cholesky(
                0.5 * (H + H.T) + 1e-4 * np.eye(15)).astype(np.float32)
            self._prior_pending = (
                R_wb.copy(), np.asarray(res.p_wb, np.float32),
                frame.v_w.copy(), frame.bg.copy(), frame.ba.copy(), L,
                self.map.change_index)
        except np.linalg.LinAlgError:
            self._prior_pending = None
        return int(res.num_inliers)

    def _match_against(self, frame: Frame, pos, desc, ids, valid_mp,
                       radius: float, keep_existing: bool, mp_angle=None,
                       radius_scale=None, oct_lo=None, oct_hi=None) -> int:
        """Project map points, match them into frame slots and bind mp_ids
        (the split path of inertial tracking). radius_scale: an optional
        (M,) multiplier on ``radius`` (the predicted octave's pyramid
        factor); oct_lo / oct_hi: optional (M,) octave windows of the
        candidate keypoints."""
        uv, vis = self._project_points(frame.R, frame.t, pos)
        valid_mp = valid_mp & vis
        kpt_free = (frame.mp_ids < 0 if keep_existing
                    else np.ones(len(frame.kpts_un), bool))
        r = (radius if radius_scale is None
             else self._t((radius * radius_scale).astype(np.float32)))
        oct_kw = {}
        if oct_lo is not None:
            oct_kw = dict(kpt_octave=self._t(frame.octave.astype(np.int32)),
                          oct_lo=self._t(oct_lo.astype(np.int32)),
                          oct_hi=self._t(oct_hi.astype(np.int32)))
        res = matching.search_by_projection(
            self._t(uv), self._t(desc.astype(np.float32)), self._t(valid_mp),
            self._t(frame.kpts_un), self._t(frame.desc),
            self._t(frame.valid), radius=r, max_dist=self.cfg.th_high,
            ratio=0.9, kpt_free=self._t(kpt_free), binary=self.cfg.binary,
            **oct_kw)
        idx, mask = fetch((res.idx, res.mask))
        if mp_angle is not None:
            mask = matching.rotation_consistency_filter(
                mp_angle, frame.angle, np.clip(idx, 0, None), mask)
        n = 0
        for m in np.nonzero(mask)[0]:
            slot = idx[m]
            if keep_existing and frame.mp_ids[slot] >= 0:
                continue
            frame.mp_ids[slot] = ids[m]
            n += 1
        return n

    def _inv_sigma2(self, frame: Frame):
        sigma2 = self.cfg.obs_sigma ** 2 * (
            self.cfg.scale_factor ** (2.0 * frame.octave.astype(np.float32))
        )
        return (1.0 / sigma2).astype(np.float32)

    def _fused_step(self, frame: Frame, pos, desc, valid_mp, mp_angle,
                    mp_octave, ids, radius, widen_below, dmax=None,
                    keep_existing=False, scale_gate=False) -> int:
        """Run one match-and-pose step (optim/track_step.match_pose_step)
        and apply the bindings and pose on the host. Returns the pose-opt
        inlier count; the new-match count goes to self._last_n_matched."""
        M = len(pos)
        zeros_m = np.zeros(M, np.float32)
        K = len(frame.kpts_un)
        if keep_existing:
            bound = frame.mp_ids >= 0
            safe = np.where(bound, frame.mp_ids, 0)
            prev_Xw = self.map.points.pos[safe].astype(np.float32)
            prev_valid = bound & self.map.points.alive[safe]
            kpt_free = ~bound
        else:
            prev_Xw = np.zeros((K, 3), np.float32)
            prev_valid = np.zeros(K, bool)
            kpt_free = np.ones(K, bool)
        t = self._t
        res = fetch(track_step.match_pose_step(
            t(frame.R), t(frame.t), t(pos.astype(np.float32)),
            t(desc.astype(np.float32)), t(valid_mp),
            t(mp_angle.astype(np.float32)), t(mp_octave.astype(np.int32)),
            t(zeros_m), t(zeros_m + 1e9 if dmax is None
                          else dmax.astype(np.float32)),
            t(np.zeros((M, 3), np.float32)),
            t(frame.kpts_un), t(frame.desc), t(frame.valid), t(frame.angle),
            t(frame.octave.astype(np.int32)), t(frame.ur),
            t(self._inv_sigma2(frame)), t(kpt_free), t(prev_Xw),
            t(prev_valid), self.cam, self.pipeline.bf, radius,
            self.cfg.th_high, 0.9, widen_below, self.cfg.scale_factor,
            2.0 * float(self.cam.cx), 2.0 * float(self.cam.cy),
            binary=self.cfg.binary, scale_gate=scale_gate, band_gate=False,
            n_levels=self.cfg.n_levels, widen=widen_below > 0,
        ))
        new = res.slot_mp >= 0
        if keep_existing:
            new &= frame.mp_ids < 0
        frame.mp_ids = np.where(new, ids[np.clip(res.slot_mp, 0, None)],
                                frame.mp_ids)
        frame.R = lie.np_normalize_rotation(res.R)
        frame.t = np.asarray(res.t)
        frame.inlier = res.inlier
        frame.mp_ids = np.where(res.inlier, frame.mp_ids, -1)
        self._last_n_matched = int(res.n_matched)
        return int(res.n_inliers)

    def _track_frame_fused(self, frame: Frame) -> Optional[bool]:
        """TrackWithMotionModel and TrackLocalMap in one device call. The
        whole-frame grab (XFeat) has already run both stages and stashed
        the result on the frame; otherwise (ORB frames) both stages run
        here on the built frame, by the ``TwoStageTrackGraph`` replay on the
        card and the eager ``two_stage_track_step`` on the CPU, against the
        local map voted from the LAST frame's bindings. Returns True on
        success, None to fall back to the split path, which re-derives
        everything."""
        pend = getattr(frame, "_fused_pending", None)
        if pend is not None:
            frame._fused_pending = None
            return self._apply_fused_two_stage(frame, *pend)
        last = self.last_frame
        # inertial frames take the split path: their pose solve is the
        # visual-inertial one
        if (self.imu_calib is not None or self.only_tracking or last is None
                or last.R is None):
            return None
        with self._span("track.snapshot"):
            ids = self._local_map_points(last)
            if ids is None or len(ids) == 0:
                return None
            self._predict_pose(frame)
            pts = self.map.points
            bound = (last.mp_ids >= 0) & last.inlier
            safe1 = np.where(bound, last.mp_ids, 0)
            valid1 = bound & pts.alive[safe1]
            ids1 = np.where(valid1, last.mp_ids, -1)
            pos, desc, valid2, padded_ids = self.map.point_snapshot(
                ids, LOCAL_MP_BUCKET)
            safe2 = np.clip(padded_ids, 0, None)
            t = self._t
            tensors = (
                t(frame.R), t(frame.t), t(pts.pos[safe1]),
                t(pts.desc[safe1]), t(valid1), t(pts.angle[safe1]),
                t(last.octave.astype(np.int32)), t(ids1.astype(np.int32)),
                t(pos), t(desc), t(valid2), t(pts.angle[safe2]),
                t(pts.octave[safe2].astype(np.int32)),
                t(padded_ids.astype(np.int32)), t(pts.dmax[safe2]),
                t(frame.kpts_un), t(frame.desc), t(frame.valid),
                t(frame.angle), t(frame.octave.astype(np.int32)),
                t(frame.ur), t(self._inv_sigma2(frame)))
        cfg = self.cfg
        args = (self.cam, self.pipeline.bf, cfg.motion_radius,
                cfg.local_radius, cfg.th_low if cfg.binary else cfg.th_high,
                0.9, cfg.min_inliers_motion, cfg.scale_factor,
                2.0 * float(self.cam.cx), 2.0 * float(self.cam.cy))
        kw = dict(binary=cfg.binary, n_levels=cfg.n_levels)
        with self._span("track.frame_step"):
            if self._track_graph is not None:
                res = self._track_graph(*tensors, *args, **kw)
            else:
                res = track_step.two_stage_track_step(*tensors, *args, **kw)
            r1, r2 = fetch(res)
        return self._apply_fused_two_stage(frame, r1, r2, ids, ids1,
                                           padded_ids)

    def _apply_fused_two_stage(self, frame: Frame, r1, r2, ids, ids1,
                               padded_ids) -> Optional[bool]:
        """Gate and apply a fetched two-stage result."""
        # the split path's motion and local acceptance criteria
        if (int(r1.n_matched) < self.cfg.min_inliers_motion
                or int(r1.n_inliers) < 10
                or int(r2.n_inliers) < self.cfg.min_inliers_local):
            return None
        bound1 = (r1.slot_mp >= 0) & r1.inlier
        new2 = (r2.slot_mp >= 0) & ~bound1
        mp = np.where(
            new2, padded_ids[np.clip(r2.slot_mp, 0, None)],
            np.where(bound1, ids1[np.clip(r1.slot_mp, 0, None)], -1))
        frame.mp_ids = np.where(r2.inlier, mp, -1)
        frame.R = lie.np_normalize_rotation(r2.R)
        frame.t = np.asarray(r2.t)
        frame.inlier = r2.inlier
        # bookkeeping parity with the split path
        self._last_local_ids = np.asarray(ids)
        self.map.points.visible[ids[self.map.points.alive[ids]]] += 1
        found = frame.mp_ids[(frame.mp_ids >= 0) & frame.inlier]
        self.map.points.found[found] += 1
        self.matches_inliers = int(r2.n_inliers)
        self.stats["motion_ok"] += 1
        return True

    def _track_with_motion_model(self, frame: Frame) -> bool:
        """TrackWithMotionModel: constant-velocity prediction, the last
        frame's points projected, widened x2 on failure, pose LM; at least
        10 inliers. One match-and-pose step on the device; inertial
        tracking keeps the split path (``_track_with_motion_model_split``),
        its pose solve being the visual-inertial one."""
        if self.last_frame is None or self.last_frame.R is None:
            return False
        self._predict_pose(frame)
        last = self.last_frame
        if self.imu_calib is not None:
            return self._track_with_motion_model_split(frame, last)
        bound = (last.mp_ids >= 0) & last.inlier
        ids = np.where(bound, last.mp_ids, 0)
        valid_mp = bound & self.map.points.alive[ids]
        pos = self.map.points.pos[ids]
        desc = self.map.points.desc[ids]
        angle = self.map.points.angle[ids]
        if self.only_tracking:
            vo = self._vo_candidates(last, ~valid_mp)
            if vo is not None:
                vo_mask, vo_pos = vo
                pos = np.where(vo_mask[:, None], vo_pos, pos)
                desc = np.where(vo_mask[:, None], last.desc, desc)
                angle = np.where(vo_mask, last.angle, angle)
                valid_mp = valid_mp | vo_mask
        frame.mp_ids = np.full_like(frame.mp_ids, -1)
        inl = self._fused_step(
            frame, pos, desc, valid_mp, angle, last.octave,
            np.where(bound, last.mp_ids, -1),
            radius=self.cfg.motion_radius,
            widen_below=self.cfg.min_inliers_motion,
        )
        if self.only_tracking:
            # mbVO: fewer than 10 of the inliers are map points, so the
            # solve rides on the temporal depth points
            self.vo_mode = int(
                ((frame.mp_ids >= 0) & frame.inlier).sum()) < 10
        if self._last_n_matched < self.cfg.min_inliers_motion:
            return False
        return inl >= 10

    def _track_with_motion_model_split(self, frame: Frame, last: Frame):
        """The motion model's split path: projection matching (scale gates
        from the last observation's octave, widened x2 below 20 matches),
        then the pose solve."""
        bound = (last.mp_ids >= 0) & last.inlier
        ids = last.mp_ids.copy()
        safe = np.where(bound, ids, 0)
        pos = self.map.points.pos[safe]
        valid_mp = bound & self.map.points.alive[safe]
        desc = self.map.points.desc[safe]
        frame.mp_ids[:] = -1
        mp_angle = self.map.points.angle[safe]
        oct_kw = {}
        if self.cfg.n_levels > 1:
            lo = last.octave.astype(np.int32)
            oct_kw = dict(
                radius_scale=self.cfg.scale_factor ** lo.astype(np.float32),
                oct_lo=lo - 1, oct_hi=lo + 1)
        n = self._match_against(frame, pos, desc, ids, valid_mp,
                                self.cfg.motion_radius, keep_existing=False,
                                mp_angle=mp_angle, **oct_kw)
        if n < 20:
            frame.mp_ids[:] = -1
            n = self._match_against(frame, pos, desc, ids, valid_mp,
                                    self.cfg.motion_radius * 2,
                                    keep_existing=False, mp_angle=mp_angle,
                                    **oct_kw)
        if n < self.cfg.min_inliers_motion:
            return False
        return self._pose_optimize(frame) >= 10

    def _vo_candidates(self, last: Frame, free: np.ndarray):
        """Visual-odometry points of localization mode (the reference's
        mlpTemporalPoints, UpdateLastFrame): last-frame slots with measured
        depth and no surviving map binding become one-shot 3D candidates,
        unprojected at the last pose. They join the motion model's
        candidates with map id -1: they steer the pose off the mapped area
        and never enter the map. Returns (slot mask, world positions) or
        None."""
        if last.R is None:
            return None
        vo_mask = (free & last.valid & (last.depth > 0)
                   & (last.depth < self.cfg.th_depth))
        if not vo_mask.any():
            return None
        z = last.depth
        x = (last.kpts_un[:, 0] - self.cam.cx) / self.cam.fx * z
        y = (last.kpts_un[:, 1] - self.cam.cy) / self.cam.fy * z
        Xc = np.stack([x, y, z], -1).astype(np.float32)
        Xw = (Xc - last.t) @ last.R  # R_cw^T (Xc - t_cw), row form
        return vo_mask, Xw.astype(np.float32)

    def _track_reference_keyframe(self, frame: Frame) -> bool:
        """TrackReferenceKeyFrame: descriptor matching against the
        reference KF (the full matrix where the reference uses BoW), the
        pose starting from the last frame's."""
        if self.ref_kf is None or self.ref_kf not in self.map.keyframes:
            return False
        kf = self.map.keyframes[self.ref_kf]
        frame.R = self.last_frame.R.copy()
        frame.t = self.last_frame.t.copy()
        bound = kf.mp_ids >= 0
        ids = np.where(bound, kf.mp_ids, 0)
        alive = self.map.points.alive[ids]
        valid_kf = bound & kf.valid & alive
        res = matching.match_general(
            self._t(kf.desc), self._t(valid_kf), self._t(frame.desc),
            self._t(frame.valid), max_dist=self.cfg.refkf_max_dist,
            ratio=0.7, binary=self.cfg.binary)
        idx, mask = fetch((res.idx, res.mask))
        mask = matching.rotation_consistency_filter(
            kf.angle, frame.angle, np.clip(idx, 0, None), mask)
        if mask.sum() < 15:
            return False
        frame.mp_ids[:] = -1
        frame.mp_ids[idx[mask]] = kf.mp_ids[mask]
        inl = self._pose_optimize(frame)
        return inl >= 10

    def _local_map_points(self, frame: Frame):
        """UpdateLocalKeyFrames/Points: the KFs sharing observations with
        the frame (and their best covisible neighbours), then the union of
        their map points."""
        votes = {}
        for mp in frame.mp_ids[frame.mp_ids >= 0]:
            for kid in self.map.obs.get(int(mp), {}):
                votes[kid] = votes.get(kid, 0) + 1
        if not votes:
            return None
        local_kfs = sorted(votes, key=votes.get, reverse=True)[:40]
        self.ref_kf = local_kfs[0]
        neighbors = []
        for kid in local_kfs[:10]:
            neighbors.extend(self.map.covisible_kfs(kid, 10))
        seen = set()
        mp_ids = []
        for kid in local_kfs + neighbors:
            kf = self.map.keyframes.get(kid)
            if kf is None or kid in seen:
                continue
            seen.add(kid)
            for mp in kf.mp_ids[kf.mp_ids >= 0]:
                mp = int(mp)
                if (mp + 10 ** 9) not in seen and self.map.points.alive[mp]:
                    seen.add(mp + 10 ** 9)  # no clash with kf ids
                    mp_ids.append(mp)
        uniq = list(dict.fromkeys(mp_ids))
        if len(uniq) > LOCAL_MP_BUCKET:
            from ..utils import verbose

            verbose.print_mess(
                f"local map snapshot cap hit: {LOCAL_MP_BUCKET} of "
                f"{len(uniq)} points", verbose.Level.VERBOSE)
            uniq = uniq[:LOCAL_MP_BUCKET]
        return np.asarray(uniq, np.int64)

    def _track_local_map(self, frame: Frame) -> bool:
        """TrackLocalMap: one match-and-pose step against the local-map
        snapshot; earlier bindings ride along as pose edges."""
        ids = self._local_map_points(frame)
        if ids is None or len(ids) == 0:
            return False
        self._last_local_ids = np.asarray(ids)  # for creation-time dedup
        pos, desc, valid, padded_ids = self.map.point_snapshot(
            ids, LOCAL_MP_BUCKET)
        bound_set = set(frame.mp_ids[frame.mp_ids >= 0].tolist())
        fresh = np.array(
            [i >= 0 and int(i) not in bound_set for i in padded_ids], bool)
        self.map.points.visible[ids[self.map.points.alive[ids]]] += 1
        safe_ids = np.clip(padded_ids, 0, None)
        if self.imu_calib is not None:
            inl = self._track_local_map_split(frame, pos, desc, valid & fresh,
                                              padded_ids)
        else:
            inl = self._fused_step(
                frame, pos, desc, valid & fresh,
                self.map.points.angle[safe_ids],
                self.map.points.octave[safe_ids], padded_ids,
                radius=self.cfg.local_radius, widen_below=0,
                dmax=self.map.points.dmax[safe_ids],
                keep_existing=True, scale_gate=True,
            )
        found = frame.mp_ids[(frame.mp_ids >= 0) & frame.inlier]
        self.map.points.found[found] += 1
        self.matches_inliers = inl
        return inl >= self.cfg.min_inliers_local

    def _track_local_map_split(self, frame: Frame, pos, desc, valid,
                               padded_ids) -> int:
        """The local map's split path: projection matching with the
        predicted-scale gates (radius by the predicted octave's factor,
        candidates within [pred-1, pred]), then the pose solve."""
        safe_ids = np.clip(padded_ids, 0, None)
        oct_kw = {}
        if self.cfg.n_levels > 1:
            C = -frame.R.T @ frame.t
            dist = np.linalg.norm(self.map.points.pos[safe_ids] - C, axis=-1)
            pred = self.map.predict_scale(safe_ids, dist)
            oct_kw = dict(
                radius_scale=self.cfg.scale_factor ** pred.astype(np.float32),
                oct_lo=pred - 1, oct_hi=pred)
        self._match_against(frame, pos, desc, padded_ids, valid,
                            self.cfg.local_radius, keep_existing=True,
                            mp_angle=self.map.points.angle[safe_ids],
                            **oct_kw)
        return self._pose_optimize(frame)

    # -- trajectory logs -------------------------------------------------------

    def _log_relative_pose(self, frame: Frame):
        """One save-time re-basable entry: the frame pose relative to its
        reference keyframe, with the absolute pose as the fallback."""
        kf = self.map.keyframes.get(self.ref_kf)
        if kf is not None:
            R_rel = (frame.R @ kf.R.T).astype(np.float32)
            t_rel = (frame.t - R_rel @ kf.t).astype(np.float32)
            ref_kid = self.ref_kf
        else:
            R_rel = t_rel = None
            ref_kid = -1
        self.traj_rel.append(
            (frame.timestamp, self.state, self.map.map_id, ref_kid,
             R_rel, t_rel, frame.R.copy(), frame.t.copy())
        )

    def resolved_trajectory(self):
        """Every logged frame re-based onto the CURRENT pose of its
        reference keyframe, so local-BA corrections reach the saved
        trajectory."""
        return resolve_trajectory(self.traj_rel, self.map, self.atlas)

    def _store_relative_pose(self, frame: Frame):
        """Remember T_frame_ref so the frame pose can be re-anchored after
        the backend moves keyframes."""
        kf = self.map.keyframes.get(self.ref_kf)
        if kf is None:
            self._rel_pose = None
            return
        R_rel = frame.R @ kf.R.T
        t_rel = frame.t - R_rel @ kf.t
        self._rel_pose = (self.ref_kf, R_rel.astype(np.float32),
                          t_rel.astype(np.float32))

    def reanchor_last_frame(self):
        """Re-base the last frame's pose onto its (possibly BA-moved)
        reference keyframe; System calls it after the backend runs."""
        if self.last_frame is None or self._rel_pose is None:
            return
        kid, R_rel, t_rel = self._rel_pose
        kf = self.map.keyframes.get(kid)
        if kf is None:
            return
        self.last_frame.R = lie.np_normalize_rotation(R_rel @ kf.R)
        self.last_frame.t = (R_rel @ kf.t + t_rel).astype(np.float32)

    def apply_map_transform(self, s: float, R_wg: np.ndarray):
        """The backend rescaled and rotated the map (IMU initialization,
        Map::ApplyScaledRotation): move the tracker's frame-local state the
        same way, so the next motion step matches the moved map."""
        lf = self.last_frame
        if lf is not None and lf.R is not None:
            lf.R = lie.np_normalize_rotation(lf.R @ R_wg)
            lf.t = (s * lf.t).astype(np.float32)
            if lf.v_w is not None:
                lf.v_w = (s * (R_wg.T @ lf.v_w)).astype(np.float32)
        if self._rel_pose is not None:
            kid, R_rel, t_rel = self._rel_pose
            self._rel_pose = (kid, R_rel, (s * t_rel).astype(np.float32))
        self.velocity = None  # the scale changed: constant velocity is stale
        self._frame_prior = None  # its mean is in the old frame

    def _update_velocity(self, frame: Frame):
        lf = self.last_frame
        if lf is not None and lf.R is not None:
            R_lw, t_lw = lf.R, lf.t
            R_wl, t_wl = R_lw.T, -R_lw.T @ t_lw
            Rv = lie.np_normalize_rotation(frame.R @ R_wl)
            tv = frame.R @ t_wl + frame.t
            self.velocity = (Rv, tv.astype(np.float32))

    # -- keyframes -----------------------------------------------------------

    def _make_keyframe(self, frame: Frame) -> KeyFrame:
        kf = KeyFrame(
            kid=self.next_kf_id,
            frame_id=frame.fid,
            timestamp=frame.timestamp,
            kpts_un=frame.kpts_un.copy(),
            desc=frame.desc.copy(),
            valid=frame.valid.copy(),
            ur=frame.ur.copy(),
            depth=frame.depth.copy(),
            angle=frame.angle.copy(),
            octave=frame.octave.copy(),
            R=frame.R.copy(),
            t=frame.t.copy(),
            mp_ids=frame.mp_ids.copy(),
        )
        if self.imu_calib is not None:
            # the inertial chain (CreateNewKeyFrame): the accumulation from
            # the last keyframe moves onto the new one and restarts here
            kf.prev_kf = self.last_kf_id if self.last_kf_id is not None else -1
            kf.pre_kf = self._pre_cur
            kf.vel = None if frame.v_w is None else frame.v_w.copy()
            bg, ba = self._current_bias()
            kf.bg = (frame.bg if frame.bg is not None else bg).copy()
            kf.ba = (frame.ba if frame.ba is not None else ba).copy()
            self._pre_from_kf = None
            self._pre_cur = None
        self.next_kf_id += 1
        self.last_kf_id = kf.kid
        self.map.add_keyframe(kf)
        self.new_keyframes.append(kf.kid)
        self.stats["kfs"] += 1
        return kf

    def _need_new_keyframe(self, frame: Frame) -> bool:
        """NeedNewKeyFrame: reference ratio (0.9 for monocular maps, 0.75
        for monocular inertial ones above 350 local-map inliers),
        close-point pressure and the maximum interval; with an IMU the
        temporal rule, and for monocular inertial tracking the weakly
        tracked frame."""
        if self.ref_kf is None:
            return False
        ref = self.map.keyframes.get(self.ref_kf)
        if ref is None:
            return False
        # nRefMatches counts the ref KF's points with >= minObs
        # observations (minObs = 3 once the map has > 2 KFs)
        min_obs = 3 if self.map.num_keyframes() > 2 else 2
        ratio = self.cfg.kf_ref_ratio if self.map.num_keyframes() >= 2 else 0.4
        if self.sensor == "mono" and self.map.num_keyframes() >= 2:
            # monocular redundancy drops slowly: the reference asks for
            # thRefRatio 0.9, relaxed to 0.75 for IMU_MONOCULAR above 350
            # local-map inliers
            ratio = 0.75 if (self.imu_calib is not None
                             and self.matches_inliers > 350) else 0.9
        ref_mps = ref.mp_ids[ref.mp_ids >= 0]
        n_ref = int((self.map.points.n_obs[ref_mps] >= min_obs).sum()) if len(ref_mps) else 0
        tracked = (frame.mp_ids >= 0) & frame.inlier
        n_tracked = int(tracked.sum())
        close = frame.valid & (frame.depth > 0) & (frame.depth < self.cfg.th_depth)
        tracked_close = int((close & tracked).sum())
        untracked_close = int((close & ~tracked).sum())
        need_close = tracked_close < 100 and untracked_close > 70

        c1a = frame.fid >= self.last_kf_frame_id + self.cfg.max_frames_between_kf
        # a mild throttle: synchronous mapping is always idle, and per-frame
        # KF bursts ratchet pose error into the map
        c1b = frame.fid >= self.last_kf_frame_id + 3
        c1c = n_tracked < n_ref * 0.25 or need_close
        c2 = (n_tracked < n_ref * ratio or need_close) and n_tracked > 15
        # c3: the inertial chain stays dense whatever the visual redundancy
        # (>= 0.5 s since the last keyframe)
        c3 = False
        if self.imu_calib is not None:
            last_kf = self.map.keyframes.get(self.last_kf_id)
            if (last_kf is not None
                    and frame.timestamp - last_kf.timestamp >= 0.5):
                c3 = True
        # c4: a weakly tracked monocular-inertial frame anchors a keyframe
        # at once
        c4 = (self.imu_calib is not None and self.sensor == "mono"
              and 15 < n_tracked < 75)
        return ((c1a or c1b or c1c) and c2) or c3 or c4

    def _create_keyframe(self, frame: Frame):
        """CreateNewKeyFrame: bind the tracked points, then create new close
        map points from depth. A slot within create_dedup_px of an existing
        local-map point's projection spawns no new point: at a slightly
        drifted pose it would duplicate that point and bake the drift into
        the map."""
        kf = self._make_keyframe(frame)
        ray = self._unproject(frame.kpts_un)
        R_wc, t_wc = frame.R.T, -frame.R.T @ frame.t
        free = frame.valid & (frame.mp_ids < 0) & (frame.depth > 0)
        if self.cfg.th_far_points is not None:
            free &= frame.depth < self.cfg.th_far_points
        local_ids = self._last_local_ids
        if local_ids is not None and len(local_ids):
            alive = self.map.points.alive[local_ids]
            pts = self.map.points.pos[local_ids[alive]]
            if len(pts):
                uv, vis = self._project_points(frame.R, frame.t, pts)
                uv = uv[vis]
                if len(uv):
                    d2 = (
                        (frame.kpts_un[:, None, 0] - uv[None, :, 0]) ** 2
                        + (frame.kpts_un[:, None, 1] - uv[None, :, 1]) ** 2
                    )
                    near = d2.min(axis=1) < self.cfg.create_dedup_px ** 2
                    free &= ~near

        depths = np.where(free, frame.depth, np.inf)
        order = np.argsort(depths)
        created = 0
        for slot in order:
            if not free[slot]:
                break
            d = frame.depth[slot]
            if d >= self.cfg.th_depth and created >= 100:
                break
            Xc = ray[slot] * d
            Xw = (R_wc @ Xc + t_wc).astype(np.float32)
            mp = self.map.create_point(Xw, frame.desc[slot], kf.kid,
                                       float(frame.angle[slot]),
                                       octave=int(frame.octave[slot]),
                                       dist_ref=float(np.linalg.norm(Xc)))
            self.map.add_observation(mp, kf.kid, int(slot), update_links=False)
            frame.mp_ids[slot] = mp
            kf.mp_ids[slot] = mp
            created += 1
        self.map.update_connections(kf.kid)
        self.ref_kf = kf.kid
        self.last_kf_frame_id = frame.fid

    # -- maps ------------------------------------------------------------------

    def _check_timestamp_jump(self, frame: Frame) -> bool:
        """An older-than-previous timestamp starts a new map; a gap > 1 s in
        inertial mode resets the active map (before VIBA2) or freezes it
        and starts a new one (after). Returns True when the frame was
        consumed by the switch."""
        if self.state in (State.NO_IMAGES, State.NOT_INITIALIZED) or \
                self.last_frame is None:
            return False
        if self.last_frame.timestamp > frame.timestamp:
            self.imu_queue.clear()
            self._switch_to_new_map(reset_current=False)
            return True
        if (self.imu_calib is not None
                and frame.timestamp > self.last_frame.timestamp + 1.0):
            keep = self.map.imu_initialized and self.map.imu_ba2
            self._switch_to_new_map(reset_current=not keep)
            return True
        return False

    def _switch_to_new_map(self, reset_current: bool):
        """CreateMapInAtlas / ResetActiveMap."""
        if reset_current:
            self.atlas.remove_map(self.map.map_id)
        self.map = self.atlas.create_new_map()
        self.state = State.NOT_INITIALIZED
        self.velocity = None
        self.ref_kf = None
        self._mono_init_frame = None
        self._frame_prior = None
        # the inertial chain does not cross maps
        self._pre_from_kf = None
        self._pre_cur = None
        self.last_kf_id = None
        self.stats["map_resets"] = self.stats.get("map_resets", 0) + 1

    def _handle_lost_map(self, frame: Frame):
        """LOST with no relocalization: small maps are reset, mature maps
        frozen and a new one started."""
        self._switch_to_new_map(reset_current=self.map.num_keyframes() < 10)

"""Tracking: the per-frame state machine, monocular and RGB-D, non-inertial.

Counterpart of ``xfeatslam_tpu/slam/tracking.py`` (the role of ORB-SLAM3's
Tracking.cc): the states NOT_INITIALIZED / OK / RECENTLY_LOST / LOST,
motion-model prediction, projection matching and the pose-only LM on the
device, local-map tracking and the keyframe policy, with the host doing
control flow and map bookkeeping in numpy.

Every steady-state frame runs extraction and both tracking stages as one
device call: on the card the frame step's CUDA graph
(``track_step.RgbdFrameStepGraph``), on the CPU the eager
``xfeat_rgbd_frame_step``; a monocular frame takes the same step without
depth. Its outputs come back in one transfer.

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

Not ported yet, each raising ``NotImplementedError`` where it would run:
stereo frames (ROADMAP item 14) and the inertial modes (item 15).
"""

from __future__ import annotations

import contextlib
import enum
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import camera as camera_ops
from ..ops import lie
from ..ops import image as image_ops
from ..ops import matching
from ..optim import local_ba, pnp, pose_opt, track_step, two_view
from ..optim.track_step import fetch
from .frame import DEPTH_EDGE_REL, Frame, FramePipeline
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
    th_high: float = matching.TH_HIGH
    th_low: float = matching.TH_LOW
    # reference-KF matching threshold: generous for float descriptors
    refkf_max_dist: float = matching.TH_LOW * 7
    # relocalization acceptance: inliers after the guided widening ladder
    reloc_min_inliers: int = 50


class Tracking:
    def __init__(self, pipeline: FramePipeline, slam_map: SlamMap,
                 cam: camera_ops.Pinhole, config: TrackerConfig, atlas,
                 timer=None, retrieval=None, sensor: str = "rgbd"):
        """sensor: "rgbd" or "mono". timer: an optional ``utils.timing.StageTimer`` that receives the
        spans ``track.snapshot`` (the host's inputs of the frame step) and
        ``track.frame_step`` (the step and its one host read). retrieval:
        the keyframe database that relocalization queries (loop closing's;
        None without it, and candidates come from a brute-force cosine over
        the keyframes' global descriptors)."""
        if sensor not in ("rgbd", "mono"):
            raise NotImplementedError(
                f"sensor {sensor!r}: stereo waits for ROADMAP item 14")
        self.sensor = sensor
        self.pipeline = pipeline
        self.map = slam_map
        self.timer = timer
        self.device = pipeline.extractor.device
        # the frame step's CUDA graph on the card; the eager step on the CPU
        self._graph = (track_step.RgbdFrameStepGraph(pipeline.extractor.model)
                       if self.device.type == "cuda" else None)
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
        if imu:
            raise NotImplementedError(
                "IMU samples: the inertial modes wait for ROADMAP item 15")
        frame = self._grab_rgbd_fused(gray, depth_raw, timestamp)
        if frame is None:
            frame = self.pipeline.build_rgbd(gray, depth_raw, timestamp)
        return self._track(frame)

    def grab_mono(self, gray, timestamp, imu=None):
        """A monocular frame: the frame step without depth first, as
        grab_rgbd."""
        if imu:
            raise NotImplementedError(
                "IMU samples: the inertial modes wait for ROADMAP item 15")
        frame = self._grab_rgbd_fused(gray, None, timestamp)
        if frame is None:
            frame = self.pipeline.build_mono(gray, timestamp)
        return self._track(frame)

    def _fused_grab_setup(self, timestamp):
        """Preconditions and speculative inputs of the whole-frame step: OK
        state, a monotonic timestamp; the motion-model pose prediction and
        the stage-1 / stage-2 snapshots voted from the LAST frame's
        bindings."""
        last = self.last_frame
        if (self.state != State.OK or self.only_tracking or last is None
                or last.R is None
                or timestamp < last.timestamp):  # would start a new map
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
            tensors, (ids, ids1, padded_ids, R0, t0) = self._step_inputs(
                gray, depth_raw, setup)
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

    def _step_inputs(self, gray, depth_raw, setup):
        """The frame step's tensor arguments, on the device."""
        (R0, t0, ids, ids1, safe1, valid1, pos, desc, valid2, padded_ids,
         safe2) = setup
        pts = self.map.points
        # the monocular step ignores its depth input
        depth_m = (np.zeros((1, 1), np.float32) if depth_raw is None
                   else self.pipeline.depth_meters(depth_raw))
        tensors = [
            image_ops.to_float_image(gray, self.device),
            self._t(depth_m),
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

    def _track(self, frame: Frame):
        if self._check_timestamp_jump(frame):
            self.last_frame = frame
            return self.state, None
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

        if frame.R is not None:
            self.trajectory.append(
                (frame.timestamp, frame.R.copy(), frame.t.copy(), self.state)
            )
            self._log_relative_pose(frame)
        self.last_frame = frame
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
            ratio=0.75)
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
        inl = self._pose_optimize(frame)
        # the guided widening ladder: short of 50 inliers, re-search the
        # candidate's neighbourhood by projection in a wide window and
        # re-optimize; a second narrow round when close
        if inl < 50:
            if self._reloc_widen(frame, m, kid, radius=10.0, dist_scale=2.0):
                inl = self._pose_optimize(frame)
            if 30 <= inl < 50:
                if self._reloc_widen(frame, m, kid, radius=3.0,
                                     dist_scale=1.28):
                    inl = self._pose_optimize(frame)
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
            kpt_free=self._t(frame.mp_ids < 0))
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
            self._mono_init_frame = frame
            return False
        res = fetch(matching.search_window(
            self._t(ref.kpts_un), self._t(ref.desc), self._t(ref.valid),
            self._t(frame.kpts_un), self._t(frame.desc),
            self._t(frame.valid), radius=100.0,
            max_dist=self.cfg.th_low * 6, ratio=0.9))
        idx = res.idx
        mask = matching.rotation_consistency_filter(
            ref.angle, frame.angle, np.clip(idx, 0, None), res.mask)
        if mask.sum() < 100:  # the reference asks for >= 100 matches
            self._mono_init_frame = frame
            return False

        uv1 = np.where(mask[:, None], ref.kpts_un, 0).astype(np.float32)
        uv2 = np.where(mask[:, None], frame.kpts_un[np.clip(idx, 0, None)],
                       0).astype(np.float32)
        gen = torch.Generator(device=self.device).manual_seed(frame.fid)
        valid = self._t(mask)
        tv = fetch(two_view.reconstruct_two_views(
            self._t(uv1), self._t(uv2), valid, self.cam.K.to(self.device),
            idx=two_view.draw_minimal_sets(valid, gen)))
        if not bool(tv.success):
            return False

        good = tv.good & mask
        X = tv.points
        # median-depth normalization (CreateInitialMapMonocular)
        med_depth = float(np.median(X[good][:, 2]))
        if med_depth <= 0:
            return False
        X = X / med_depth
        ref.R = np.eye(3, dtype=np.float32)
        ref.t = np.zeros(3, np.float32)
        frame.R = tv.R.astype(np.float32)
        frame.t = (tv.t / med_depth).astype(np.float32)

        kf1 = self._make_keyframe(ref)
        kf2 = self._make_keyframe(frame)
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

    def _predict_pose(self, frame: Frame):
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

    def _pose_optimize(self, frame: Frame) -> int:
        bound = frame.mp_ids >= 0
        ids = np.where(bound, frame.mp_ids, 0)
        Xw = self.map.points.pos[ids]
        alive = self.map.points.alive[ids]
        valid = bound & frame.valid & alive
        is_stereo = valid & (frame.ur > 0)
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
            scale_gate=scale_gate, band_gate=False, n_levels=self.cfg.n_levels,
            widen=widen_below > 0,
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
        """Gate and apply the two-stage result the whole-frame grab
        stashed on the frame (TrackWithMotionModel and TrackLocalMap in one
        call). Returns True on success, None to fall back to the split
        path, which re-derives everything."""
        pend = getattr(frame, "_fused_pending", None)
        if pend is None:
            return None
        frame._fused_pending = None
        return self._apply_fused_two_stage(frame, *pend)

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
        10 inliers. One match-and-pose step on the device."""
        if self.last_frame is None or self.last_frame.R is None:
            return False
        self._predict_pose(frame)
        last = self.last_frame
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
            ratio=0.7)
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
        self.next_kf_id += 1
        self.last_kf_id = kf.kid
        self.map.add_keyframe(kf)
        self.new_keyframes.append(kf.kid)
        self.stats["kfs"] += 1
        return kf

    def _need_new_keyframe(self, frame: Frame) -> bool:
        """NeedNewKeyFrame: reference ratio (0.9 for monocular maps),
        close-point pressure and the maximum interval."""
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
            # thRefRatio 0.9
            ratio = 0.9
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
        return (c1a or c1b or c1c) and c2

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
        """An older-than-previous timestamp starts a new map. Returns True
        when the frame was consumed by the switch."""
        if self.state in (State.NO_IMAGES, State.NOT_INITIALIZED) or \
                self.last_frame is None:
            return False
        if self.last_frame.timestamp > frame.timestamp:
            self._switch_to_new_map(reset_current=False)
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
        self.last_kf_id = None
        self.stats["map_resets"] = self.stats.get("map_resets", 0) + 1

    def _handle_lost_map(self, frame: Frame):
        """LOST with no relocalization: small maps are reset, mature maps
        frozen and a new one started."""
        self._switch_to_new_map(reset_current=self.map.num_keyframes() < 10)

"""System: the public session facade, monocular, stereo and RGB-D.

Counterpart of ``xfeatslam_tpu/slam/system.py`` (the role of ORB-SLAM3's
System.cc): build the pipeline (extractor, atlas, tracking, local
mapping, loop closing), accept frames, return poses, save trajectories
and atlas files. Local mapping runs as budgeted synchronous steps after
each tracked frame, as in the JAX package; loop closing checks every new
keyframe, and its global BA after a loop runs its later rounds one per
frame.

The device work runs on ``device``: CUDA unless the caller asks for the
CPU, and without a GPU the default raises. Localization mode, the
trajectory savers and the tracked-state getters are here. The feature
backend is XFeat or ORB (``backend="orb"`` or ``USE_ORB``). A STEREO
session takes rectified pairs (``track_stereo``; ``Settings.rectify``
rectifies a raw pinhole pair first) and runs the RGB-D tracker on their
stereo depth, as the JAX package's System does. The inertial sensors
(IMU_MONOCULAR, IMU_STEREO, IMU_RGBD; ``Settings.imu`` required) pass each
frame's IMU samples to ``track_monocular`` / ``track_stereo`` /
``track_rgbd(..., imu=...)``: tracking preintegrates them and, once local
mapping has initialized the IMU (rotating and rescaling the map, which the
System hands on to tracking), solves visual-inertial poses. A monocular
inertial map initializes with a free scale and refines it while its chain
is young; a map weld with an IMU-initialized map runs the welding inertial
BA (``LocalMapping.merge_inertial_ba``) in place of the global BA.
``viewer_dir`` and ``viewer_port`` follow the session with the live viewer
and its control panel (``utils/viewer.py``); ``export_map_html`` writes the
interactive 3D map (``utils/map3d.py``).
"""

from __future__ import annotations

import enum
import os
from typing import Optional

import numpy as np

from .. import resolve_device
from ..models.extractor import XFeatExtractor
from ..ops import matching
from ..utils import io as io_utils
from ..utils.timing import StageTimer
from .atlas import Atlas
from .frame import FramePipeline
from .local_mapping import LocalMapping
from .loop_closing import LoopClosing
from .retrieval import (Retrieval, aggregate_global_desc, fit_codebook,
                        global_desc_dim, use_codebook)
from .settings import Settings
from .tracking import State, TrackerConfig, Tracking


class Sensor(enum.Enum):
    """Sensor configurations (System.h)."""

    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4
    IMU_RGBD = 5


_INERTIAL = {Sensor.IMU_MONOCULAR, Sensor.IMU_STEREO, Sensor.IMU_RGBD}
_MONO_LIKE = {Sensor.MONOCULAR, Sensor.IMU_MONOCULAR}


class System:
    def __init__(self, settings: Settings, sensor: Sensor = Sensor.RGBD,
                 backend: Optional[str] = None,
                 enable_mapping: bool = True,
                 enable_loop_closing: bool = True,
                 viewer_dir: Optional[str] = None,
                 viewer_port: Optional[int] = None, device=None):
        """backend: "xfeat" or "orb" (the reference's USE_ORB switch); None
        reads the ``USE_ORB`` environment variable, as the JAX package does.
        enable_loop_closing (with mapping) builds LoopClosing, as in the
        JAX package. device: where the tensors live, CUDA unless given.
        An inertial sensor needs the settings' IMU section.

        viewer_dir: a ``LiveViewer`` follows the session there
        (live_frame.png, live_map.png and map3d.json swapped in atomically,
        session.gif at shutdown; the reference's bUseViewer). viewer_port:
        also serve the control panel on http://127.0.0.1:<port>/ (0 picks a
        free port, read back from ``viewer_server.port``): pause and
        step-by-step, follow camera, top or side view, localization mode,
        reset, stop. Requires viewer_dir."""
        if backend is None:
            backend = "orb" if os.environ.get("USE_ORB") else "xfeat"
        if backend not in ("xfeat", "orb"):
            raise ValueError(f"backend {backend!r}: 'xfeat' or 'orb'")
        if viewer_port is not None and viewer_dir is None:
            raise ValueError("viewer_port requires viewer_dir")
        # the inertial calibration, required by the IMU_* sensors
        self.imu_calib = settings.imu if sensor in _INERTIAL else None
        if sensor in _INERTIAL and self.imu_calib is None:
            raise ValueError(
                f"sensor {sensor.name} requires an IMU section in the config "
                "(IMU.NoiseGyro/NoiseAcc/GyroWalk/AccWalk + IMU.T_b_c1)")
        self.device = resolve_device(device)
        self.backend = backend
        self.timer = StageTimer()
        self._is_shutdown = False
        self._mapping_paused = False
        self._last_big_change_idx = 0
        self.settings = settings
        self.sensor = sensor
        self.viewer = self.viewer_controls = self.viewer_server = None
        if viewer_dir is not None:
            from ..utils.viewer import LiveViewer, ViewerControls, ViewerServer

            self.viewer = LiveViewer(viewer_dir)
            if viewer_port is not None:
                self.viewer_controls = ViewerControls()
                self.viewer_server = ViewerServer(
                    viewer_dir, self.viewer_controls, port=viewer_port)
        if backend == "orb":
            # the extractor's own pyramid defaults, as the JAX package's
            # System builds it
            from ..models.orb import ORBExtractor

            self.extractor = ORBExtractor(nfeatures=settings.n_features,
                                          device=self.device)
            profile, desc_dim = matching.ORB_PROFILE, 256
            n_levels = self.extractor.n_levels
            scale_factor = self.extractor.scale_factor
        else:
            self.extractor = XFeatExtractor(nfeatures=settings.n_features,
                                            device=self.device)
            # XFeat is single-scale
            profile, desc_dim, n_levels, scale_factor = (
                matching.XFEAT_PROFILE, 64, 1, 1.2)
        self.atlas = Atlas(desc_dim=desc_dim, scale_factor=scale_factor,
                           n_levels=n_levels)
        self.map = self.atlas.active
        self.pipeline = FramePipeline(
            self.extractor, settings.cam, bf=settings.bf,
            depth_factor=settings.depth_map_factor, timer=self.timer)
        cfg = TrackerConfig(fps=settings.fps, th_depth=settings.th_depth,
                            th_far_points=settings.th_far_points,
                            binary=profile.binary, th_high=profile.th_high,
                            th_low=profile.th_low, n_levels=n_levels,
                            scale_factor=scale_factor,
                            insert_kfs_when_lost=settings.insert_kfs_when_lost)
        self.loop_closing = None
        if enable_loop_closing and enable_mapping:
            # the scale is observable with depth or a stereo rig, not from
            # one camera
            self.loop_closing = LoopClosing(
                self.map, settings.cam, bf=settings.bf,
                fix_scale=sensor != Sensor.MONOCULAR,
                atlas=self.atlas, device=self.device)
            # the post-loop GBA runs budgeted: the robust stage at the loop
            # frame, the remaining rounds one per frame through tick()
            self.loop_closing.gba_budget_rounds = 3
        # relocalization queries loop closing's keyframe database; without
        # loop closing it has none
        self.tracking = Tracking(
            self.pipeline, self.map, settings.cam, cfg, atlas=self.atlas,
            timer=self.timer,
            retrieval=(self.loop_closing.retrieval
                       if self.loop_closing is not None else None),
            sensor="mono" if sensor in _MONO_LIKE else "rgbd",
            imu_calib=self.imu_calib)
        self.local_mapping = None
        if enable_mapping:
            self.local_mapping = LocalMapping(
                self.map, settings.cam, settings.bf, self.device,
                profile=profile, imu_calib=self.imu_calib,
                mono=sensor == Sensor.IMU_MONOCULAR,
                imu_init_time=settings.imu_init_time,
                viba1_time=settings.viba1_time,
                viba2_time=settings.viba2_time)
            if self.loop_closing is not None and self.imu_calib is not None:
                # MergeInertialBA: after an inertial map weld, the two
                # temporal windows around the weld are refined jointly with
                # the IMU chains. The hook fires mid-merge, before
                # _adopt_merged_map rebinds the maps: local mapping is
                # pointed at the welded map first
                def _welding_iba(kid, merge_kid):
                    self.local_mapping.map = self.loop_closing.map
                    self.local_mapping._ba_session = None
                    self.local_mapping.merge_inertial_ba(kid, merge_kid)

                self.loop_closing.welding_iba = _welding_iba

    def track_rgbd(self, gray: np.ndarray, depth_raw: np.ndarray,
                   timestamp: float, imu=None):
        """Returns (state, (R,t) world->camera or None). imu: the (acc (3,),
        gyro (3,), t) samples since the previous frame (System::TrackRGBD's
        vImuMeas)."""
        self._apply_viewer_controls()
        with self.timer.span("track"):
            state, pose = self.tracking.grab_rgbd(gray, depth_raw, timestamp,
                                                  imu=imu)
        with self.timer.span("backend"):
            self._run_backend()
        self._update_viewer(gray, state)
        return state, pose

    def track_stereo(self, gray_l: np.ndarray, gray_r: np.ndarray,
                     timestamp: float, imu=None):
        """A rectified stereo pair (System::TrackStereo). Returns (state,
        (R,t) world->camera or None)."""
        self._apply_viewer_controls()
        with self.timer.span("track"):
            state, pose = self.tracking.grab_stereo(gray_l, gray_r,
                                                    timestamp, imu=imu)
        with self.timer.span("backend"):
            self._run_backend()
        self._update_viewer(gray_l, state)
        return state, pose

    def track_monocular(self, gray: np.ndarray, timestamp: float, imu=None):
        """Returns (state, (R,t) world->camera or None)."""
        self._apply_viewer_controls()
        with self.timer.span("track"):
            state, pose = self.tracking.grab_mono(gray, timestamp, imu=imu)
        with self.timer.span("backend"):
            self._run_backend()
        self._update_viewer(gray, state)
        return state, pose

    def _apply_viewer_controls(self):
        """Honour the control panel before a frame: block while paused (a
        step releases one frame), then apply reset and localization
        mode."""
        c = self.viewer_controls
        if c is None or c.stopped:
            return
        c.gate()
        if c.consume_reset():
            self.reset()
        if c.localization != self.tracking.only_tracking:
            if c.localization:
                self.activate_localization_mode()
            else:
                self.deactivate_localization_mode()

    def _update_viewer(self, gray, state):
        if self.viewer is None or self.tracking.last_frame is None:
            return
        c = self.viewer_controls
        follow_center, view = None, "both"
        if c is not None:
            view = c.view
            lf = self.tracking.last_frame
            if c.follow and lf.R is not None:
                follow_center = -lf.R.T @ lf.t
        with self.timer.span("viewer"):
            self.viewer.update(gray, self.tracking.last_frame, self.map,
                               trajectory=self.tracking.trajectory,
                               state_text=f"{state.name} | "
                               f"{self.map.num_keyframes()} KFs | "
                               f"{self.map.num_points()} points",
                               follow_center=follow_center, view=view)

    def _sync_active_map(self):
        """Tracking may have switched to a new map (Atlas): re-point the
        backend at the active map."""
        if self.tracking.map is not self.map:
            self.map = self.tracking.map
            if self.local_mapping is not None:
                self.local_mapping.map = self.map
                self.local_mapping.recent_points.clear()
            if self.loop_closing is not None:
                # one retrieval index across the atlas: keep its entries
                self.loop_closing.map = self.map

    def _run_backend(self):
        self._sync_active_map()
        if self.local_mapping is None or self._mapping_paused:
            self.tracking.new_keyframes.clear()
            return
        ran = False
        while self.tracking.new_keyframes:
            kid = self.tracking.new_keyframes.pop(0)
            if kid not in self.map.keyframes:
                continue
            self.local_mapping.process_keyframe(kid)
            if self.loop_closing is not None:
                self.loop_closing.process_keyframe(kid)
            ran = True
        if not ran:
            # no KF this frame: advance one budgeted backend session by one
            # round (the background thread's time slice): local BA first,
            # else an in-flight post-loop GBA
            if self.local_mapping._ba_session is not None:
                self.local_mapping.tick()
                ran = True
            elif (self.loop_closing is not None
                  and self.loop_closing._gba_session is not None):
                self.loop_closing.tick()
                ran = True
        if ran:
            if (self.loop_closing is not None
                    and self.loop_closing.map is not self.map):
                self._adopt_merged_map()
            # an IMU initialization rotated and rescaled the whole map: move
            # the tracker's frame-local state the same way
            if self.local_mapping.pending_map_transform is not None:
                s, R_wg = self.local_mapping.pending_map_transform
                self.local_mapping.pending_map_transform = None
                self.tracking.apply_map_transform(s, R_wg)
            # the backend may have moved keyframes (local BA, loop
            # correction, GBA): re-base the tracker's last-frame pose on
            # its reference KF
            self.tracking.reanchor_last_frame()

    def _adopt_merged_map(self):
        """A map merge made another map the active one: point tracking and
        local mapping at it, and re-resolve the tracker's reference (the
        keyframe ids moved by the merge's offset)."""
        self.map = self.loop_closing.map
        self.tracking.map = self.map
        if self.local_mapping is not None:
            self.local_mapping.map = self.map
            self.local_mapping.recent_points.clear()
        self.tracking.ref_kf = max(self.map.keyframes)
        self.tracking.last_kf_id = self.tracking.ref_kf
        self.tracking.next_kf_id = max(self.map.keyframes) + 1
        self.tracking._rel_pose = None
        if self.tracking.last_frame is not None:
            lf = self.tracking.last_frame
            kf = self.map.keyframes[self.tracking.ref_kf]
            # the moved keyframe was made from the current frame: adopt
            # its welded pose
            lf.R = kf.R.copy()
            lf.t = kf.t.copy()
            lf.mp_ids = kf.mp_ids.copy()
            lf.inlier = lf.mp_ids >= 0
        self.tracking.velocity = None

    def change_dataset(self):
        """System::ChangeDataset: between back-to-back sequences in one
        run, a barely grown active map (< 12 keyframes) is discarded and
        restarted, a grown one frozen in the atlas and a new one started."""
        keep = self.map.num_keyframes() >= 12
        self.tracking._switch_to_new_map(reset_current=not keep)
        self._sync_active_map()

    def activate_localization_mode(self):
        """Tracking only (System::ActivateLocalizationMode): local mapping
        pauses, and the tracker inserts no keyframe and creates no map
        point."""
        self._mapping_paused = True
        self.tracking.only_tracking = True

    def deactivate_localization_mode(self):
        self._mapping_paused = False
        self.tracking.only_tracking = False
        self.tracking.vo_mode = False

    def reset(self):
        """System::Reset: clear everything, restart with a fresh map."""
        self.atlas.maps.clear()
        self.atlas.create_new_map()
        self.map = self.atlas.active
        self.tracking.map = self.map
        self.tracking.state = State.NO_IMAGES
        self.tracking.last_frame = None
        self.tracking.velocity = None
        self.tracking.ref_kf = None
        self.tracking.trajectory.clear()
        self.tracking.traj_rel.clear()
        self.tracking.new_keyframes.clear()
        self._sync_active_map()

    def get_tracking_state(self):
        """Current tracker state (System::GetTrackingState)."""
        return self.tracking.state

    def save_trajectory_tum(self, path: str):
        """Every frame re-based onto the current pose of its reference
        keyframe (T_frame = T_rel * T_refKF), so local-BA corrections reach
        the file (System::SaveTrajectoryTUM); so do the EuRoC and KITTI
        savers."""
        traj = self.tracking.resolved_trajectory()
        io_utils.save_trajectory_tum(
            path,
            [t for (t, _R, _t, _s) in traj],
            [(R, tr) for (_t, R, tr, _s) in traj],
        )

    def save_trajectory_euroc(self, path: str, map_id: int = None):
        """map_id restricts the file to the frames logged in one atlas map
        (SaveTrajectoryEuRoC(filename, pMap))."""
        traj = self.tracking.resolved_trajectory()
        if map_id is not None:
            keep = {e[0] for e in self.tracking.traj_rel if e[2] == map_id}
            traj = [t for t in traj if t[0] in keep]
        io_utils.save_trajectory_euroc(
            path, [t for (t, _R, _t, _s) in traj],
            [(R, tr) for (_t, R, tr, _s) in traj],
        )

    def save_trajectory_kitti(self, path: str):
        traj = self.tracking.resolved_trajectory()
        io_utils.save_trajectory_kitti(
            path, [(R, tr) for (_t, R, tr, _s) in traj])

    def save_keyframe_trajectory_tum(self, path: str, map_id: int = None):
        kfs = self._kfs_for_save(map_id)
        io_utils.save_trajectory_tum(
            path, [k.timestamp for k in kfs], [(k.R, k.t) for k in kfs]
        )

    def save_keyframe_trajectory_euroc(self, path: str, map_id: int = None):
        kfs = self._kfs_for_save(map_id)
        io_utils.save_trajectory_euroc(
            path, [k.timestamp for k in kfs], [(k.R, k.t) for k in kfs]
        )

    def _kfs_for_save(self, map_id=None):
        m = self.map if map_id is None else self.atlas.maps[map_id]
        return sorted(m.keyframes.values(), key=lambda k: k.timestamp)

    def export_map_html(self, path: str, max_points: int = 60000) -> str:
        """A standalone interactive 3D map file (WebGL orbit, pan and zoom
        over the points, keyframe frusta, covisibility graph and
        trajectory): the offline form of the map the viewer serves at
        /map3d. Returns ``path``."""
        from ..utils import map3d

        payload = map3d.map_payload(
            self.map, trajectory=self.tracking.trajectory,
            max_points=max_points,
            title=f"{self.map.num_keyframes()} KFs, "
                  f"{self.map.num_points()} points")
        return map3d.export_html(payload, path)

    def save_atlas(self, path: str):
        """Checkpoint the whole atlas (System::SaveAtlas), in the JAX
        package's file format."""
        from . import serialization

        serialization.save_atlas(self.atlas, path)

    def load_atlas(self, path: str):
        """Resume from a checkpoint (System::LoadAtlas). Tracking restarts
        LOST and must relocalize into the loaded map."""
        from . import serialization

        self.atlas = serialization.load_atlas(path)
        self.map = self.atlas.active
        self.tracking.atlas = self.atlas
        self.tracking.map = self.map
        self.tracking.state = State.LOST
        self.tracking.lost_since = 0.0
        self.tracking.velocity = None
        self.tracking.ref_kf = None
        self._sync_active_map()
        # one retrieval index over every loaded map, tagged by map id, so
        # relocalization into stored maps and merges work after a resume
        if self.loop_closing is not None:
            self.loop_closing.map = self.map
            self._reindex()
            # KF-removal eviction into the fresh atlas and maps
            self.atlas.kf_removed_hook = self.loop_closing._evict
            for m in self.atlas.all_maps():
                m.on_kf_removed = self.atlas._dispatch_kf_removed

    def _reindex(self):
        """A fresh retrieval index of every keyframe of the atlas, for loop
        closing and relocalization."""
        retr = Retrieval(dim=global_desc_dim(self.map.desc_dim))
        for m in self.atlas.all_maps():
            for kid in sorted(m.keyframes):
                retr.add(kid, m.keyframes[kid].global_desc, map_id=m.map_id)
        self.loop_closing.retrieval = retr
        self.tracking.retrieval = retr

    def refit_retrieval_codebook(self, max_descs: int = 100000):
        """Fit a data-derived (spherical k-means) VLAD codebook on the
        atlas's keyframe descriptors, re-aggregate every stored global
        descriptor and rebuild the retrieval index (the trained-vocabulary
        option)."""
        descs = []
        for m in self.atlas.all_maps():
            for kf in m.keyframes.values():
                descs.append(kf.desc[kf.valid])
        if not descs:
            return
        d = np.concatenate(descs)
        if len(d) > max_descs:
            sel = np.random.default_rng(0).choice(len(d), max_descs,
                                                  replace=False)
            d = d[sel]
        use_codebook(fit_codebook(d))
        for m in self.atlas.all_maps():
            for kf in m.keyframes.values():
                kf.global_desc = aggregate_global_desc(kf.desc, kf.valid)
        if self.loop_closing is not None:
            self._reindex()

    # -- tracked-state getters (System.h) ----------------------------------

    def get_tracked_map_points(self) -> np.ndarray:
        """Map-point ids of the last frame's keypoints, -1 where unbound
        (System::GetTrackedMapPoints, ids in place of MapPoint*)."""
        lf = self.tracking.last_frame
        if lf is None:
            return np.empty(0, np.int64)
        return lf.mp_ids.copy()

    def get_tracked_keypoints_un(self) -> np.ndarray:
        """The last frame's keypoints (K,2) (System::GetTrackedKeyPointsUn;
        the JAX package returns the frame's ``kpts``)."""
        lf = self.tracking.last_frame
        if lf is None:
            return np.empty((0, 2), np.float32)
        return np.asarray(lf.kpts).copy()

    def get_image_scale(self) -> float:
        """The input resize factor of the settings (System::GetImageScale);
        1 without a resize."""
        s = self.settings
        if getattr(s, "need_resize", False) and s.new_width:
            return float(s.new_width) / float(s.width)
        return 1.0

    def map_changed(self) -> bool:
        """True once after each big map change (System::MapChanged), from
        the maps' change counters summed over the atlas so the count stays
        monotone across map switches."""
        cur = sum(m.change_index for m in self.atlas.all_maps())
        if cur > self._last_big_change_idx:
            self._last_big_change_idx = cur
            return True
        return False

    def is_shutdown(self) -> bool:
        return self._is_shutdown

    def is_lost(self) -> bool:
        """The inertial loss flag (System::isLost): False until IMU
        initialization."""
        if not self.map.imu_initialized:
            return False
        return self.tracking.state == State.LOST

    def get_time_from_imu_init(self) -> float:
        """Keyframe seconds since the inertial map began; 0 before IMU
        initialization (System::GetTimeFromIMUInit)."""
        if not self.map.imu_initialized or not self.map.keyframes:
            return 0.0
        ts = [k.timestamp for k in self.map.keyframes.values()]
        dt = max(ts) - min(ts)
        return float(dt) if dt > 0 else 0.0

    def dump_timing(self, path: str):
        """ExecMean.txt-style per-stage stats (REGISTER_TIMES role)."""
        self.timer.dump(path)

    def save_debug_data(self, init_idx: int, out_dir: str = "."):
        """System::SaveDebugData: the record of the inertial
        initializations of the latest section (its init trajectory in EuRoC
        format, and per solve the scale, the gravity direction, the solver
        cost and the chain's keyframe count) into the
        init_{FrameTrajectory,Scale,GDir,CompCost,KF}_* files, with the JAX
        package's names and formats. Nothing is written before the first
        initialization."""
        lm = self.local_mapping
        if lm is None or not lm.init_debug:
            return
        sect = lm.init_debug[-1][0]
        self.save_trajectory_euroc(os.path.join(
            out_dir, f"init_FrameTrajectory_{sect}_{init_idx}.txt"))
        recs = [rec for rec in lm.init_debug if rec[0] == sect]
        for name, col in (("Scale", 1), ("CompCost", 3), ("KF", 4)):
            with open(os.path.join(out_dir, f"init_{name}_{sect}.txt"),
                      "a") as f:
                for rec in recs:
                    f.write(f"{rec[col]}\n")
        with open(os.path.join(out_dir, f"init_GDir_{sect}.txt"), "a") as f:
            for rec in recs:
                R = rec[2]
                for r in range(3):
                    f.write(",".join(f"{R[r, c]}" for c in range(3)) + "\n")

    def shutdown(self):
        self._is_shutdown = True
        if self.loop_closing is not None:
            self.loop_closing.flush()  # finish an in-flight budgeted GBA
        if self.viewer_server is not None:
            self.viewer_server.close()
        if self.viewer is not None:
            self.viewer.close()
        return {
            "keyframes": self.map.num_keyframes(),
            "map_points": self.map.num_points(),
            "maps": len(self.atlas.maps),
            "frames": len(self.tracking.trajectory),
            "loops_closed": (len(self.loop_closing.closed)
                             if self.loop_closing is not None else 0),
            **self.tracking.stats,
        }

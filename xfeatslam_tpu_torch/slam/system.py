"""System: the public session facade, RGB-D without loop closing.

Counterpart of ``xfeatslam_tpu/slam/system.py`` (the role of ORB-SLAM3's
System.cc): build the pipeline (extractor, atlas, tracking, local
mapping), accept frames, return poses, save trajectories. Local mapping
runs as budgeted synchronous steps after each tracked frame, as in the
JAX package.

The device work runs on ``device``: CUDA unless the caller asks for the
CPU, and without a GPU the default raises. Not ported yet, each raising
``NotImplementedError`` with its ROADMAP item: the monocular, stereo and
inertial sensors (items 12, 14, 15), the ORB backend (item 13), loop
closing (item 11) and the viewer (item 16).
"""

from __future__ import annotations

import enum
import os
from typing import Optional

import numpy as np

from .. import resolve_device
from ..models.extractor import XFeatExtractor
from ..utils import io as io_utils
from ..utils.timing import StageTimer
from .atlas import Atlas
from .frame import FramePipeline
from .local_mapping import LocalMapping
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


_UNPORTED_SENSORS = {
    Sensor.MONOCULAR: "monocular initialization waits for ROADMAP item 12",
    Sensor.STEREO: "stereo waits for ROADMAP item 14",
    Sensor.IMU_MONOCULAR: "the inertial modes wait for ROADMAP item 15",
    Sensor.IMU_STEREO: "the inertial modes wait for ROADMAP item 15",
    Sensor.IMU_RGBD: "the inertial modes wait for ROADMAP item 15",
}


class System:
    def __init__(self, settings: Settings, sensor: Sensor = Sensor.RGBD,
                 backend: Optional[str] = None,
                 enable_mapping: bool = True,
                 enable_loop_closing: bool = True,
                 viewer_dir: Optional[str] = None,
                 viewer_port: Optional[int] = None, device=None):
        """backend: "xfeat" (the default; "orb" is not ported).
        enable_loop_closing defaults to True as in the JAX package, where
        it builds LoopClosing; here it must be False until loop closing is
        ported. device: where the tensors live, CUDA unless given."""
        if sensor in _UNPORTED_SENSORS:
            raise NotImplementedError(
                f"sensor {sensor.name}: {_UNPORTED_SENSORS[sensor]}")
        if backend is None:
            backend = "orb" if os.environ.get("USE_ORB") else "xfeat"
        if backend != "xfeat":
            raise NotImplementedError(
                f"backend {backend!r}: the ORB backend waits for ROADMAP "
                "item 13")
        if enable_loop_closing and enable_mapping:
            raise NotImplementedError(
                "loop closing waits for ROADMAP item 11; pass "
                "enable_loop_closing=False")
        if viewer_dir is not None or viewer_port is not None:
            raise NotImplementedError("the viewer waits for ROADMAP item 16")
        self.device = resolve_device(device)
        self.backend = backend
        self.timer = StageTimer()
        self._is_shutdown = False
        self.settings = settings
        self.sensor = sensor
        self.extractor = XFeatExtractor(nfeatures=settings.n_features,
                                        device=self.device)
        # XFeat is single-scale
        self.atlas = Atlas(desc_dim=64, n_levels=1)
        self.map = self.atlas.active
        self.pipeline = FramePipeline(
            self.extractor, settings.cam, bf=settings.bf,
            depth_factor=settings.depth_map_factor,
        )
        cfg = TrackerConfig(fps=settings.fps, th_depth=settings.th_depth,
                            th_far_points=settings.th_far_points)
        self.tracking = Tracking(self.pipeline, self.map, settings.cam, cfg,
                                 atlas=self.atlas, timer=self.timer)
        self.local_mapping = None
        if enable_mapping:
            self.local_mapping = LocalMapping(self.map, settings.cam,
                                              settings.bf, self.device)

    def track_rgbd(self, gray: np.ndarray, depth_raw: np.ndarray,
                   timestamp: float, imu=None):
        """Returns (state, (R,t) world->camera or None)."""
        with self.timer.span("track"):
            state, pose = self.tracking.grab_rgbd(gray, depth_raw, timestamp,
                                                  imu=imu)
        with self.timer.span("backend"):
            self._run_backend()
        return state, pose

    def track_stereo(self, gray_l, gray_r, timestamp, imu=None):
        raise NotImplementedError(_UNPORTED_SENSORS[Sensor.STEREO])

    def track_monocular(self, gray, timestamp, imu=None):
        raise NotImplementedError(_UNPORTED_SENSORS[Sensor.MONOCULAR])

    def _sync_active_map(self):
        """Tracking may have switched to a new map (Atlas): re-point the
        backend at the active map."""
        if self.tracking.map is not self.map:
            self.map = self.tracking.map
            if self.local_mapping is not None:
                self.local_mapping.map = self.map
                self.local_mapping.recent_points.clear()

    def _run_backend(self):
        self._sync_active_map()
        if self.local_mapping is None:
            self.tracking.new_keyframes.clear()
            return
        ran = False
        while self.tracking.new_keyframes:
            kid = self.tracking.new_keyframes.pop(0)
            if kid not in self.map.keyframes:
                continue
            self.local_mapping.process_keyframe(kid)
            ran = True
        if not ran and self.local_mapping._ba_session is not None:
            # no KF this frame: advance the budgeted local BA by one round
            # (the background thread's time slice)
            self.local_mapping.tick()
            ran = True
        if ran:
            # the backend may have moved keyframes (local BA): re-base the
            # tracker's last-frame pose on its reference KF
            self.tracking.reanchor_last_frame()

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
        the file (System::SaveTrajectoryTUM)."""
        traj = self.tracking.resolved_trajectory()
        io_utils.save_trajectory_tum(
            path,
            [t for (t, _R, _t, _s) in traj],
            [(R, tr) for (_t, R, tr, _s) in traj],
        )

    def save_keyframe_trajectory_tum(self, path: str, map_id: int = None):
        m = self.map if map_id is None else self.atlas.maps[map_id]
        kfs = sorted(m.keyframes.values(), key=lambda k: k.timestamp)
        io_utils.save_trajectory_tum(
            path, [k.timestamp for k in kfs], [(k.R, k.t) for k in kfs]
        )

    def dump_timing(self, path: str):
        """ExecMean.txt-style per-stage stats (REGISTER_TIMES role)."""
        self.timer.dump(path)

    def shutdown(self):
        self._is_shutdown = True
        return {
            "keyframes": self.map.num_keyframes(),
            "map_points": self.map.num_points(),
            "maps": len(self.atlas.maps),
            "frames": len(self.tracking.trajectory),
            "loops_closed": 0,
            **self.tracking.stats,
        }

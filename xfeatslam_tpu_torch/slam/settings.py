"""Typed settings of the SLAM system.

The fields of ``xfeatslam_tpu/slam/settings.py``'s ``Settings`` that the
RGB-D system reads, with a pinhole camera, as callers build it in code.
Not ported yet, each raising ``NotImplementedError``: reading the
reference's OpenCV-YAML files (``from_yaml``, which needs ``yaml``), the
KannalaBrandt8 camera, the stereo rig and its rectification (ROADMAP item
14) and the IMU section (item 15).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..ops.camera import Pinhole


@dataclass
class Settings:
    camera_type: str = "PinHole"
    cam: Optional[Pinhole] = None  # camera 1
    fps: float = 30.0
    bf: float = 40.0  # baseline x fx, for the virtual right coordinate
    th_depth: float = 3.0  # meters (Stereo.ThDepth * baseline)
    depth_map_factor: float = 5000.0
    n_features: int = 1000
    # depth beyond this never becomes a map point (System.thFarPoints)
    th_far_points: Optional[float] = None
    # inertial calibration: the inertial modes are not ported (item 15)
    imu: object = None

    def __post_init__(self):
        if self.camera_type not in ("PinHole", "Rectified"):
            raise NotImplementedError(
                f"camera model {self.camera_type}: only pinhole cameras are "
                "ported (KannalaBrandt8 waits for ROADMAP item 14)")
        if self.cam is not None and not isinstance(self.cam, Pinhole):
            raise NotImplementedError(
                f"camera {type(self.cam).__name__}: only the port's Pinhole "
                "is supported (KannalaBrandt8 waits for ROADMAP item 14)")
        if self.imu is not None:
            raise NotImplementedError(
                "an IMU section: the inertial modes wait for ROADMAP item 15")

    @staticmethod
    def from_yaml(path: str, sensor: str = None) -> "Settings":
        raise NotImplementedError(
            "Settings.from_yaml: reading OpenCV-YAML configs needs a parser "
            "without yaml/cv2 and waits (ROADMAP item 10); build Settings in "
            "code")

    def rectify(self, img_l, img_r):
        raise NotImplementedError(
            "stereo rectification waits for ROADMAP item 14")

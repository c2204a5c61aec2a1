"""Typed settings of the SLAM system.

The fields of ``xfeatslam_tpu/slam/settings.py``'s ``Settings`` that the
monocular and RGB-D systems read, with a pinhole camera: built in code, or
read from the reference's OpenCV-YAML files by ``from_yaml`` (through
``utils/opencv_yaml``, without ``yaml`` or ``cv2``). Not ported yet, each
raising ``NotImplementedError``: the KannalaBrandt8 camera, the stereo rig
and its rectification (ROADMAP item 14) and the IMU section (item 15).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..ops.camera import Pinhole
from ..utils import opencv_yaml


class SettingsError(ValueError):
    """A required parameter is missing or malformed (the reference prints
    '<name> required parameter does not exist, aborting...' and exits)."""


@dataclass
class Settings:
    camera_type: str = "PinHole"
    cam: Optional[Pinhole] = None  # camera 1
    fps: float = 30.0
    bf: float = 40.0  # baseline x fx, for the virtual right coordinate
    th_depth: float = 3.0  # meters (Stereo.ThDepth * baseline)
    depth_map_factor: float = 5000.0
    n_features: int = 1000
    # the ORB extractor's pyramid and FAST thresholds, read from the file
    # as the JAX package does; System builds ORBExtractor(nfeatures=...)
    # alone, as the JAX package's System does
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
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
    def from_yaml(path: str, sensor=None) -> "Settings":
        """Read a pinhole config, as the JAX package's ``from_yaml`` does
        (its camera 1, image-size, RGB-D, extractor and system sections).
        sensor: None (lenient) or MONOCULAR / RGBD (enum or string), which
        turns on the reference's required-parameter errors for that
        sensor's sections. A KannalaBrandt8 camera or a stereo sensor
        raises naming item 14, an IMU section or inertial sensor item 15."""
        d = opencv_yaml.load(path)
        if hasattr(sensor, "name"):
            sensor = sensor.name
        strict = sensor is not None
        rgbd = sensor in ("RGBD", "IMU_RGBD")
        if sensor in ("STEREO", "IMU_STEREO"):
            raise NotImplementedError(
                "stereo settings wait for ROADMAP item 14")

        def get(*names, default=None, required=False):
            for n in names:
                if d.get(n) is not None:
                    return d[n]
            if required and strict:
                raise SettingsError(
                    f"{names[0]} required parameter does not exist")
            return default

        # camera 1 (readCamera1, Settings.cc:184-275)
        cam_type = get("Camera.type", "Camera1.type", default="PinHole")
        if cam_type == "KannalaBrandt8":
            raise NotImplementedError(
                "the KannalaBrandt8 camera waits for ROADMAP item 14")
        if cam_type not in ("PinHole", "Rectified"):
            raise SettingsError(f"Error: camera model {cam_type} not known")
        fx = float(get("Camera1.fx", "Camera.fx", required=True,
                       default=500.0))
        fy = float(get("Camera1.fy", "Camera.fy", required=True,
                       default=500.0))
        cx = float(get("Camera1.cx", "Camera.cx", required=True,
                       default=320.0))
        cy = float(get("Camera1.cy", "Camera.cy", required=True,
                       default=240.0))
        dist = []
        if cam_type == "PinHole" and get("Camera1.k1", "Camera.k1") is not None:
            dist = [float(get("Camera1.k1", "Camera.k1", default=0.0))] + [
                float(get(f"Camera1.{k}", f"Camera.{k}", required=True,
                          default=0.0)) for k in ("k2", "p1", "p2")]
            k3 = get("Camera1.k3", "Camera.k3")
            if k3 is not None:
                dist.append(float(k3))
        params = [fx, fy, cx, cy] + dist

        # image size and resize (readImageInfo, Settings.cc:356-413): the
        # calibration scales with the new size
        width = int(get("Camera.width", "Camera1.width", required=True,
                        default=640))
        height = int(get("Camera.height", "Camera1.height", required=True,
                         default=480))
        new_h, new_w = get("Camera.newHeight"), get("Camera.newWidth")
        if new_w is not None:
            params[0] *= int(new_w) / width
            params[2] *= int(new_w) / width
        if new_h is not None:
            params[1] *= int(new_h) / height
            params[3] *= int(new_h) / height
        s = Settings(camera_type=cam_type, cam=Pinhole.from_list(params))
        s.fps = float(get("Camera.fps", required=True, default=30.0))
        get("Camera.RGB", required=True)

        # IMU (readIMU, Settings.cc:414-433)
        if get("IMU.NoiseGyro") is not None or sensor in (
                "IMU_MONOCULAR", "IMU_RGBD"):
            raise NotImplementedError(
                "an IMU section: the inertial modes wait for ROADMAP item 15")

        # RGB-D (readRGBD, Settings.cc:434-442)
        if rgbd or get("RGBD.DepthMapFactor", "DepthMapFactor") is not None:
            s.depth_map_factor = float(get("RGBD.DepthMapFactor",
                                           "DepthMapFactor", required=rgbd,
                                           default=5000.0))
            th_depth_factor = float(get("Stereo.ThDepth", "ThDepth",
                                        required=rgbd, default=40.0))
            baseline = float(get("Stereo.b", required=rgbd, default=0.08))
            s.bf = baseline * float(s.cam.fx)
            s.th_depth = s.bf / float(s.cam.fx) * th_depth_factor
        elif get("Camera.bf") is not None:
            s.bf = float(get("Camera.bf"))
            s.th_depth = s.bf / fx * float(get("Stereo.ThDepth", "ThDepth",
                                               default=40.0))

        # extractor (readORB, Settings.cc:443-452)
        s.n_features = int(get("ORBextractor.nFeatures",
                               "Extractor.nFeatures", required=True,
                               default=1000))
        s.scale_factor = float(get("ORBextractor.scaleFactor", required=True,
                                   default=1.2))
        s.n_levels = int(get("ORBextractor.nLevels", required=True,
                             default=8))
        s.ini_th_fast = int(get("ORBextractor.iniThFAST", required=True,
                                default=20))
        s.min_th_fast = int(get("ORBextractor.minThFAST", required=True,
                                default=7))

        tfp = get("System.thFarPoints")
        s.th_far_points = float(tfp) if tfp is not None else None
        return s

    def rectify(self, img_l, img_r):
        raise NotImplementedError(
            "stereo rectification waits for ROADMAP item 14")

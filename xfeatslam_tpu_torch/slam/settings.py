"""Typed settings of the SLAM system.

Counterpart of ``xfeatslam_tpu/slam/settings.py``: built in code, or read
from the reference's OpenCV-YAML files by ``from_yaml`` (through
``utils/opencv_yaml``, without ``yaml`` or ``cv2``). Pinhole and
KannalaBrandt8 cameras; the stereo rig (camera 2, ``Stereo.T_c1_c2`` or
``Stereo.b``, the fisheye lapping columns); an unrectified pinhole rig's
rectification maps by ``precompute_rectification`` and ``rectify``
(``utils/rectification``, numpy in place of ``cv2``); the IMU section
(``ops/imu.ImuCalib``, the IMU rate and the initialization schedule) of
the three inertial sensors, IMU_MONOCULAR, IMU_STEREO and IMU_RGBD; and
the Viewer, LoadAndSave and ``Camera.RGB`` keys, which are kept and not
acted on, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.camera import KannalaBrandt8, Pinhole
from ..ops.imu import ImuCalib
from ..utils import opencv_yaml
from ..utils import rectification

_INERTIAL = ("IMU_MONOCULAR", "IMU_STEREO", "IMU_RGBD")


class SettingsError(ValueError):
    """A required parameter is missing or malformed (the reference prints
    '<name> required parameter does not exist, aborting...' and exits)."""


def _as_matrix(v, rows=4, cols=4) -> np.ndarray:
    """An opencv-matrix node ({rows, cols, dt, data}) or a plain list, as
    float32."""
    if isinstance(v, dict):
        return np.asarray(v["data"], np.float32).reshape(
            int(v.get("rows", rows)), int(v.get("cols", cols)))
    return np.asarray(v, np.float32).reshape(rows, cols)


def _K64(cam) -> np.ndarray:
    """The camera's intrinsic matrix from its float32 intrinsics, as the
    JAX package hands ``cam.K`` to OpenCV."""
    fx, fy, cx, cy = (float(np.float32(v)) for v in cam[:4])
    return np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])


@dataclass
class ViewerSettings:
    """The Viewer section (Settings.cc:453-471), with the JAX package's
    defaults."""

    keyframe_size: float = 0.05
    keyframe_line_width: float = 1.0
    graph_line_width: float = 0.9
    point_size: float = 2.0
    camera_size: float = 0.08
    camera_line_width: float = 3.0
    viewpoint_x: float = 0.0
    viewpoint_y: float = -0.7
    viewpoint_z: float = -1.8
    viewpoint_f: float = 500.0
    image_view_scale: float = 1.0


# ViewerSettings' fields and their keys in a config file
_VIEWER_KEYS = (
    ("keyframe_size", "Viewer.KeyFrameSize"),
    ("keyframe_line_width", "Viewer.KeyFrameLineWidth"),
    ("graph_line_width", "Viewer.GraphLineWidth"),
    ("point_size", "Viewer.PointSize"),
    ("camera_size", "Viewer.CameraSize"),
    ("camera_line_width", "Viewer.CameraLineWidth"),
    ("viewpoint_x", "Viewer.ViewpointX"),
    ("viewpoint_y", "Viewer.ViewpointY"),
    ("viewpoint_z", "Viewer.ViewpointZ"),
    ("viewpoint_f", "Viewer.ViewpointF"),
    ("image_view_scale", "Viewer.imageViewScale"),
)


@dataclass
class Settings:
    camera_type: str = "PinHole"
    cam: object = None  # camera 1, Pinhole or KannalaBrandt8 (rectified)
    cam2: object = None  # camera 2 of a stereo rig
    dist1: Optional[List[float]] = None  # pinhole distortion (4 or 5)
    dist2: Optional[List[float]] = None
    lapping1: Optional[Tuple[int, int]] = None  # KB8 overlapping columns
    lapping2: Optional[Tuple[int, int]] = None
    T_c1_c2: Optional[np.ndarray] = None  # (4,4) float32 stereo extrinsic
    width: int = 640
    height: int = 480
    new_width: Optional[int] = None  # Camera.newWidth resize target
    new_height: Optional[int] = None
    need_resize: bool = False
    need_rectify: bool = False
    # the rectification maps (M1l, M2l, M1r, M2r), set by
    # precompute_rectification for an unrectified pinhole rig
    rect_maps: Optional[Tuple] = None
    fps: float = 30.0
    baseline: float = 0.08
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
    # Camera.RGB: the colour order of the input images (1: RGB, 0: BGR)
    rgb: bool = True
    # depth beyond this never becomes a map point (System.thFarPoints)
    th_far_points: Optional[float] = None
    # inertial calibration (readIMU); None for vision-only configs
    imu: Optional[ImuCalib] = None
    imu_frequency: float = 200.0
    insert_kfs_when_lost: bool = True
    # the IMU initialization schedule: first init, VIBA1, VIBA2 (seconds of
    # keyframe chain)
    imu_init_time: float = 1.0
    viba1_time: float = 5.0
    viba2_time: float = 15.0
    viewer: ViewerSettings = field(default_factory=ViewerSettings)
    # LoadAndSave: System.LoadAtlasFromFile / System.SaveAtlasToFile
    load_atlas_from: Optional[str] = None
    save_atlas_to: Optional[str] = None
    raw: Dict = field(default_factory=dict)

    def __post_init__(self):
        if self.camera_type not in ("PinHole", "Rectified", "KannalaBrandt8"):
            raise SettingsError(
                f"Error: camera model {self.camera_type} not known")
        for c in (self.cam, self.cam2):
            if c is not None and not isinstance(c, (Pinhole, KannalaBrandt8)):
                raise TypeError(f"camera {type(c).__module__}."
                                f"{type(c).__name__}: the port's Pinhole or "
                                "KannalaBrandt8 is needed")
        if self.imu is not None and not isinstance(self.imu, ImuCalib):
            raise TypeError(f"imu {type(self.imu).__module__}."
                            f"{type(self.imu).__name__}: the port's ImuCalib "
                            "is needed")

    @staticmethod
    def from_yaml(path: str, sensor=None) -> "Settings":
        """Read a config, as the JAX package's ``from_yaml`` does (camera
        1, camera 2 and the stereo section, image size and resize, RGB-D,
        extractor and system sections; an unrectified pinhole stereo rig's
        rectification maps). sensor: None (lenient) or one of MONOCULAR /
        STEREO / RGBD / IMU_MONOCULAR / IMU_STEREO / IMU_RGBD (enum or
        string), which turns on the reference's required-parameter errors
        for that sensor's sections."""
        d = opencv_yaml.load(path)
        if hasattr(sensor, "name"):
            sensor = sensor.name
        strict = sensor is not None
        stereo = sensor in ("STEREO", "IMU_STEREO")
        rgbd = sensor in ("RGBD", "IMU_RGBD")
        inertial = sensor in _INERTIAL

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
        fx = float(get("Camera1.fx", "Camera.fx", required=True,
                       default=500.0))
        fy = float(get("Camera1.fy", "Camera.fy", required=True,
                       default=500.0))
        cx = float(get("Camera1.cx", "Camera.cx", required=True,
                       default=320.0))
        cy = float(get("Camera1.cy", "Camera.cy", required=True,
                       default=240.0))
        s = Settings(camera_type=cam_type, raw=d)
        if cam_type in ("PinHole", "Rectified"):
            if cam_type == "PinHole" and get("Camera1.k1",
                                             "Camera.k1") is not None:
                s.dist1 = [float(get("Camera1.k1", "Camera.k1",
                                     default=0.0))] + [
                    float(get(f"Camera1.{k}", f"Camera.{k}", required=True,
                              default=0.0)) for k in ("k2", "p1", "p2")]
                k3 = get("Camera1.k3", "Camera.k3")
                if k3 is not None:
                    s.dist1.append(float(k3))
            s.cam = Pinhole.from_list([fx, fy, cx, cy] + (s.dist1 or []))
        else:
            ks = [float(get(f"Camera1.k{i}", f"Camera.k{i}", required=True,
                            default=0.0)) for i in (1, 2, 3, 4)]
            s.cam = KannalaBrandt8.from_list([fx, fy, cx, cy] + ks)
            if stereo:
                s.lapping1 = (
                    int(get("Camera1.overlappingBegin", required=True,
                            default=0)),
                    int(get("Camera1.overlappingEnd", required=True,
                            default=0)))

        # camera 2 and the rig (readCamera2, Settings.cc:276-354)
        if stereo:
            s.need_rectify = cam_type == "PinHole"
            if cam_type in ("PinHole", "KannalaBrandt8"):
                fx2 = float(get("Camera2.fx", required=True, default=fx))
                fy2 = float(get("Camera2.fy", required=True, default=fy))
                cx2 = float(get("Camera2.cx", required=True, default=cx))
                cy2 = float(get("Camera2.cy", required=True, default=cy))
                if cam_type == "PinHole":
                    if get("Camera2.k1") is not None:
                        s.dist2 = [float(get("Camera2.k1", default=0.0))] + [
                            float(get(f"Camera2.{k}", required=True,
                                      default=0.0))
                            for k in ("k2", "p1", "p2")]
                        k3 = get("Camera2.k3")
                        if k3 is not None:
                            s.dist2.append(float(k3))
                    s.cam2 = Pinhole.from_list([fx2, fy2, cx2, cy2]
                                               + (s.dist2 or []))
                else:
                    # camera 2 reads Camera1.k* (Settings.cc:332-335), an
                    # upstream quirk the JAX package keeps
                    ks2 = [float(get(f"Camera1.k{i}", default=0.0))
                           for i in (1, 2, 3, 4)]
                    s.cam2 = KannalaBrandt8.from_list([fx2, fy2, cx2, cy2]
                                                      + ks2)
                    s.lapping2 = (
                        int(get("Camera2.overlappingBegin", required=True,
                                default=0)),
                        int(get("Camera2.overlappingEnd", required=True,
                                default=0)))
            if cam_type == "Rectified":
                s.baseline = float(get("Stereo.b", required=True,
                                       default=0.08))
            else:
                T = get("Stereo.T_c1_c2", required=True)
                if T is not None:
                    s.T_c1_c2 = _as_matrix(T)
                    s.baseline = float(np.linalg.norm(s.T_c1_c2[:3, 3]))
            s.bf = s.baseline * fx
            s.th_depth = s.bf / fx * float(get("Stereo.ThDepth",
                                               required=True, default=40.0))

        # image size and resize (readImageInfo, Settings.cc:356-413): the
        # calibration scales with the new size unless the rig is rectified
        s.width = int(get("Camera.width", "Camera1.width", required=True,
                          default=640))
        s.height = int(get("Camera.height", "Camera1.height", required=True,
                           default=480))
        sx = sy = 1.0
        if get("Camera.newHeight") is not None:
            s.new_height = int(get("Camera.newHeight"))
            s.need_resize = True
            sy = s.new_height / s.height
        if get("Camera.newWidth") is not None:
            s.new_width = int(get("Camera.newWidth"))
            s.need_resize = True
            sx = s.new_width / s.width
        if s.need_resize and not s.need_rectify:
            def scaled(cam):
                p = cam.params_list()
                p[0] *= sx
                p[2] *= sx
                p[1] *= sy
                p[3] *= sy
                return type(cam).from_list(p)

            s.cam = scaled(s.cam)
            if s.cam2 is not None:
                s.cam2 = scaled(s.cam2)
            if s.lapping1 is not None:
                s.lapping1 = (int(s.lapping1[0] * sx), int(s.lapping1[1] * sx))
            if s.lapping2 is not None:
                s.lapping2 = (int(s.lapping2[0] * sx), int(s.lapping2[1] * sx))
        s.fps = float(get("Camera.fps", required=True, default=30.0))
        s.rgb = bool(get("Camera.RGB", required=True, default=1))

        # IMU (readIMU, Settings.cc:414-433)
        if get("IMU.NoiseGyro") is not None or inertial:
            T = get("IMU.T_b_c1", "Tbc", required=inertial)
            T = np.eye(4, dtype=np.float32) if T is None else _as_matrix(T)
            s.imu = ImuCalib(
                noise_gyro=float(get("IMU.NoiseGyro", required=inertial,
                                     default=1.7e-4)),
                noise_acc=float(get("IMU.NoiseAcc", required=inertial,
                                    default=2e-3)),
                walk_gyro=float(get("IMU.GyroWalk", required=inertial,
                                    default=1.9e-5)),
                walk_acc=float(get("IMU.AccWalk", required=inertial,
                                   default=3e-3)),
                R_bc=np.ascontiguousarray(T[:3, :3]),
                t_bc=np.ascontiguousarray(T[:3, 3]),
            )
            s.imu_frequency = float(get("IMU.Frequency", required=inertial,
                                        default=200.0))
            s.insert_kfs_when_lost = bool(get("IMU.InsertKFsWhenLost",
                                              default=1))

        # RGB-D (readRGBD, Settings.cc:434-442)
        if rgbd or get("RGBD.DepthMapFactor", "DepthMapFactor") is not None:
            s.depth_map_factor = float(get("RGBD.DepthMapFactor",
                                           "DepthMapFactor", required=rgbd,
                                           default=5000.0))
            th_depth_factor = float(get("Stereo.ThDepth", "ThDepth",
                                        required=rgbd, default=40.0))
            s.baseline = float(get("Stereo.b", required=rgbd, default=0.08))
            s.bf = s.baseline * float(s.cam.fx)
            s.th_depth = s.bf / float(s.cam.fx) * th_depth_factor
        elif not stereo and get("Camera.bf") is not None:
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

        # viewer (readViewer, Settings.cc:453-471)
        for attr, key in _VIEWER_KEYS:
            val = get(key)
            if val is not None:
                setattr(s.viewer, attr, float(val))

        # load/save and the rest (Settings.cc:472-483)
        s.load_atlas_from = get("System.LoadAtlasFromFile")
        s.save_atlas_to = get("System.SaveAtlasToFile")
        tfp = get("System.thFarPoints")
        s.th_far_points = float(tfp) if tfp is not None else None
        if s.need_rectify:
            s.precompute_rectification()
        return s

    def precompute_rectification(self):
        """precomputeRectificationMaps (Settings.cc:485-541): Bouguet's
        rectification of the pinhole rig and both cameras' undistort and
        rectify maps (``utils/rectification``, as cv2's stereoRectify with
        zero disparity and alpha -1 and initUndistortRectifyMap); camera
        1's calibration and bf become the rectified projection's."""
        if self.cam2 is None or self.T_c1_c2 is None:
            return
        size = (self.new_width or self.width, self.new_height or self.height)
        K1, K2 = _K64(self.cam), _K64(self.cam2)
        # T_c1_c2 is camera 1 <- camera 2; the rectification takes 2 <- 1
        T21 = np.linalg.inv(self.T_c1_c2.astype(np.float64))
        R1, R2, P1, P2 = rectification.stereo_rectify(
            K1, self.dist1, K2, self.dist2, size, T21[:3, :3], T21[:3, 3])
        self.rect_maps = (
            *rectification.init_undistort_rectify_map(
                K1, self.dist1, R1, P1[:3, :3], size),
            *rectification.init_undistort_rectify_map(
                K2, self.dist2, R2, P2[:3, :3], size))
        self.cam = Pinhole.from_list([P1[0, 0], P1[1, 1], P1[0, 2], P1[1, 2]])
        self.bf = self.baseline * float(P1[0, 0])
        # the IMU extrinsic follows the rectifying rotation
        if self.imu is not None:
            R_bc = self.imu.R_bc @ np.asarray(R1, np.float32).T
            self.imu = self.imu._replace(R_bc=R_bc.astype(np.float32))

    def rectify(self, img_l: np.ndarray, img_r: np.ndarray):
        """The precomputed rectification maps applied to a uint8 stereo
        pair (System.cc's TrackStereo path), as cv2.remap with bilinear
        interpolation and a constant 0 border computes it."""
        if self.rect_maps is None:
            return img_l, img_r
        M1l, M2l, M1r, M2r = self.rect_maps
        return (rectification.remap_linear(img_l, M1l, M2l),
                rectification.remap_linear(img_r, M1r, M2r))

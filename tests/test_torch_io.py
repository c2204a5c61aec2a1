"""The port's readers without ``cv2`` or ``yaml`` against the JAX package's
and against ``cv2`` itself.

- ``utils/png``: every sample equal to ``cv2.imread`` (IMREAD_UNCHANGED and
  IMREAD_GRAYSCALE) on ``tools/render_tum_dataset.py``'s fixture, on
  images ``cv2`` writes with each scanline filter and with the image data
  split over many IDAT chunks, and on images PIL writes; interlaced and
  palette images refused.
- ``utils/io``: the TUM association (a file, and rgb.txt/depth.txt matched
  by time) and the KITTI, EuRoC and TUM-VI monocular layouts give the JAX
  package's sequences, and a TUM frame reads as JAX's reader reads it.
- ``utils/opencv_yaml``: key for key (values and types) the dict JAX's
  ``_load_opencv_yaml`` builds with pyyaml, on all nine shipped configs.
- ``Settings.from_yaml``: field for field JAX's on the pinhole configs, in
  lenient and per-sensor strict mode, with its required-parameter error;
  the IMU section as JAX reads it (or JAX's error, read as IMU_RGBD); the
  monocular and stereo inertial sensors raise naming ROADMAP item 15b.
"""

import glob
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from PIL import Image  # noqa: E402

from xfeatslam_tpu.slam import settings as jset  # noqa: E402
from xfeatslam_tpu.utils import io as jio  # noqa: E402
from xfeatslam_tpu_torch.slam import settings as tset  # noqa: E402
from xfeatslam_tpu_torch.utils import io as tio  # noqa: E402
from xfeatslam_tpu_torch.utils import opencv_yaml, png  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "examples", "configs",
                                        "*.yaml")))
# the pinhole configs without an IMU section: the ones the port reads
PINHOLE = ["euroc_mono", "kitti00-02", "kitti03", "kitti04-12", "tum1_rgbd",
           "tum2_rgbd", "tum3_rgbd"]
FILTERS = ["NONE", "SUB", "UP", "AVG", "PAETH"]


def _images(seed=0):
    """(name, samples as cv2 writes them) of each kind the decoder reads:
    8-bit gray, BGR and BGRA, 16-bit gray."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:37, 0:53]
    base = 128 + 60 * np.sin(xx / 5.0) * np.cos(yy / 4.0)
    gray = (base + rng.normal(0, 20, base.shape)).clip(0, 255).astype(
        np.uint8)
    bgr = np.stack([gray, 255 - gray, np.roll(gray, 3, 1)], -1)
    bgr[:4] = gray[:4, :, None]  # rows where r == g == b
    bgra = np.concatenate([bgr, rng.integers(0, 256, (37, 53, 1), np.uint8)],
                          -1)
    d16 = (1000 + 900 * base + rng.integers(0, 300, base.shape)).astype(
        np.uint16)
    return {"gray": gray, "bgr": bgr, "bgra": bgra, "depth16": d16}


def _check_against_cv2(path):
    raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = png.read(path)
    if raw.ndim == 3:  # cv2 gives BGR(A), the decoder the file's RGB(A)
        raw = raw[..., [2, 1, 0, 3][:raw.shape[2]]]
    assert got.dtype == raw.dtype
    np.testing.assert_array_equal(got, raw)
    np.testing.assert_array_equal(png.read_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.fixture(scope="module")
def tum_fixture(tmp_path_factory):
    """``tools/render_tum_dataset.py``'s 4-frame TUM directory (written by
    cv2) with ``tools/tum_associate.py``'s association file."""
    import render_tum_dataset
    import tum_associate

    root = str(tmp_path_factory.mktemp("tum"))
    render_tum_dataset.render_tum_dataset(root, n_frames=4)
    tum_associate.main([root])
    return root


def test_decoder_matches_cv2_on_the_tum_fixture(tum_fixture):
    paths = sorted(glob.glob(os.path.join(tum_fixture, "rgb", "*.png"))
                   + glob.glob(os.path.join(tum_fixture, "depth", "*.png")))
    assert len(paths) == 8
    for p in paths:
        _check_against_cv2(p)


@pytest.mark.parametrize("kind", ["gray", "bgr", "bgra", "depth16"])
@pytest.mark.parametrize("filt", FILTERS)
def test_decoder_matches_cv2_per_filter(kind, filt, tmp_path):
    path = str(tmp_path / f"{kind}.png")
    assert cv2.imwrite(path, _images()[kind], [
        cv2.IMWRITE_PNG_FILTER, getattr(cv2, f"IMWRITE_PNG_FILTER_{filt}")])
    _check_against_cv2(path)


@pytest.mark.parametrize("kind", ["gray", "bgr", "depth16"])
def test_decoder_reads_many_idat_chunks(kind, tmp_path):
    path = str(tmp_path / f"{kind}.png")
    assert cv2.imwrite(path, _images(1)[kind],
                       [cv2.IMWRITE_PNG_ZLIBBUFFER_SIZE, 64])
    with open(path, "rb") as f:
        assert f.read().count(b"IDAT") > 10
    _check_against_cv2(path)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_decoder_reads_pil_files(mode, tmp_path):
    img = _images(2)["bgra"][..., :{"L": 1, "RGB": 3, "RGBA": 4}[mode]]
    path = str(tmp_path / "pil.png")
    Image.fromarray(img[..., 0] if mode == "L" else img, mode).save(
        path, optimize=True)
    np.testing.assert_array_equal(png.read(path),
                                  img[..., 0] if mode == "L" else img)
    _check_against_cv2(path)


def test_decoder_refuses_palette_and_interlace(tmp_path):
    path = str(tmp_path / "p.png")
    Image.fromarray(_images()["gray"]).convert("P").save(path)
    with pytest.raises(ValueError, match="palette"):
        png.read(path)
    cv2.imwrite(path, _images()["gray"])
    data = bytearray(open(path, "rb").read())
    ihdr = data.index(b"IHDR")
    data[ihdr + 16] = 1  # the interlace method byte
    with pytest.raises(ValueError, match="interlaced"):
        png.decode(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a")


def _same_sequence(a, b):
    assert a.timestamps == b.timestamps
    assert a.rgb_paths == b.rgb_paths
    assert a.depth_paths == b.depth_paths


def test_tum_association_matches_jax(tum_fixture):
    assoc = os.path.join(tum_fixture, "association.txt")
    ts, js = (tio.load_tum_association(tum_fixture, assoc),
              jio.load_tum_association(tum_fixture, assoc))
    _same_sequence(ts, js)
    assert len(ts) == 4
    _same_sequence(tio.associate_tum(tum_fixture),
                   jio.associate_tum(tum_fixture))
    for i in range(len(ts)):
        (gt, dt, tt), (gj, dj, tj) = ts.read(i), js.read(i)
        np.testing.assert_array_equal(gt, gj)
        np.testing.assert_array_equal(dt, dj)
        assert gt.dtype == gj.dtype and dt.dtype == dj.dtype and tt == tj
    # the monocular example's reader of rgb.txt
    t_mono, p_mono = tio.load_tum_mono(tum_fixture)
    assert len(t_mono) == 4 and all(os.path.exists(p) for p in p_mono)


def test_monocular_layouts_match_jax(tmp_path):
    kitti = tmp_path / "kitti"
    (kitti / "image_0").mkdir(parents=True)
    for i in range(3):
        (kitti / "image_0" / f"{i:06d}.png").write_bytes(b"")
    (kitti / "times.txt").write_text("0.0\n0.1\n0.2\n0.3\n")
    assert tio.load_kitti_mono(str(kitti)) == jio.load_kitti_mono(str(kitti))
    euroc = tmp_path / "euroc"
    data = euroc / "mav0" / "cam0" / "data"
    data.mkdir(parents=True)
    stamps = ["1403636579763555584", "1403636579813555456",
              "1403636579863555584"]
    for s in stamps:
        (data / f"{s}.png").write_bytes(b"")
    times = tmp_path / "times.txt"
    times.write_text("# t\n" + "\n".join(stamps[:2]) + "\n")
    for t_fn, j_fn in ((tio.load_euroc_mono, jio.load_euroc_mono),
                       (tio.load_tum_vi_mono, jio.load_tum_vi_mono)):
        assert t_fn(str(euroc)) == j_fn(str(euroc))
        assert t_fn(str(euroc), str(times)) == j_fn(str(euroc), str(times))


def _same_tree(a, b):
    assert type(a) is type(b), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_yaml_reader_matches_jax(path):
    assert len(CONFIGS) == 9
    _same_tree(opencv_yaml.load(path), jset._load_opencv_yaml(path))


def test_yaml_reader_scalars_and_lists():
    d = opencv_yaml.parse(
        '%YAML:1.0\n---\na: 1\nb: 1.5e-3\nc: 1e-3\nd: "x # y" # note\n'
        "e: true\nf: ~\ng: [1, 2.0,\n   3]\nh: !!opencv-matrix\n  rows: 1\n"
        "  cols: 2\n  dt: f\n  data: [ 0.5,\n     -1. ]\ni:\n")
    assert d == {"a": 1, "b": 1.5e-3, "c": "1e-3", "d": "x # y", "e": True,
                 "f": None, "g": [1, 2.0, 3],
                 "h": {"rows": 1, "cols": 2, "dt": "f", "data": [0.5, -1.0]},
                 "i": None}
    with pytest.raises(ValueError, match="unclosed"):
        opencv_yaml.parse("a: [1, 2\n")


def _config(name):
    return os.path.join(REPO, "examples", "configs", f"{name}.yaml")


@pytest.mark.parametrize("name", PINHOLE)
def test_settings_from_yaml_match_jax(name):
    sensors = [None, "RGBD" if name.startswith("tum") else "MONOCULAR"]
    for sensor in sensors:
        ts = tset.Settings.from_yaml(_config(name), sensor)
        js = jset.Settings.from_yaml(_config(name), sensor)
        assert ts.camera_type == js.camera_type
        np.testing.assert_allclose(ts.cam.params_list(),
                                   [float(v) for v in js.cam], rtol=1e-6)
        for f in ("fps", "bf", "th_depth", "depth_map_factor"):
            np.testing.assert_allclose(getattr(ts, f), getattr(js, f),
                                       rtol=1e-6, err_msg=f)
        assert ts.n_features == js.n_features
        assert ts.th_far_points == js.th_far_points
        assert ts.imu is js.imu is None


def test_settings_from_yaml_required_parameters(tmp_path):
    text = open(_config("tum1_rgbd")).read()
    path = tmp_path / "no_fx.yaml"
    path.write_text("\n".join(ln for ln in text.splitlines()
                              if not ln.startswith("Camera1.fx")))
    for mod in (tset, jset):
        # lenient: a default; strict: the reference's abort
        assert mod.Settings.from_yaml(str(path)).cam is not None
        with pytest.raises(mod.SettingsError, match="Camera1.fx required"):
            mod.Settings.from_yaml(str(path), "RGBD")
    path = tmp_path / "no_factor.yaml"
    path.write_text("\n".join(ln for ln in text.splitlines()
                              if not ln.startswith("RGBD.DepthMapFactor")))
    for mod in (tset, jset):
        with pytest.raises(mod.SettingsError, match="DepthMapFactor"):
            mod.Settings.from_yaml(str(path), "RGBD")


EUROC_STEREO_INERTIAL = """%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: 458.654
Camera1.fy: 457.296
Camera1.cx: 367.215
Camera1.cy: 248.375
Camera1.k1: -0.28340811
Camera1.k2: 0.07395907
Camera1.p1: 0.00019359
Camera1.p2: 1.76187114e-05
Camera2.fx: 457.587
Camera2.fy: 456.134
Camera2.cx: 379.999
Camera2.cy: 255.238
Camera2.k1: -0.28368365
Camera2.k2: 0.07451284
Camera2.p1: -0.00010473
Camera2.p2: -3.55590700e-05
Stereo.ThDepth: 60.0
Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [0.999997256477797, -0.002317135723275, -0.000343393120620,
         0.110074137800478, 0.002312067192432, 0.999898048507103,
         -0.014090668452683, -0.000156612054392, 0.000376008102320,
         0.014089835846691, 0.999900662638081, 0.000889382785432,
         0.0, 0.0, 0.0, 1.0]
Camera.width: 752
Camera.height: 480
Camera.fps: 20
Camera.RGB: 1
IMU.T_b_c1: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]
IMU.NoiseGyro: 1.7e-4
IMU.NoiseAcc: 2.0e-3
IMU.GyroWalk: 1.9e-5
IMU.AccWalk: 3.0e-3
IMU.Frequency: 200.0
IMU.InsertKFsWhenLost: 0
ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


@pytest.mark.parametrize("name,sensor", [
    # the monocular-inertial config, strict: key for key as JAX
    ("euroc_mono_inertial", "IMU_MONOCULAR"),
    # EuRoC's unrectified stereo rig with its IMU: rectified by both
    # packages, the IMU extrinsic rotated with camera 1
    ("euroc_stereo_inertial", "IMU_STEREO"),
])
def test_settings_from_yaml_inertial_sections(name, sensor, tmp_path):
    """The monocular and stereo inertial sensors read as the JAX package
    reads them: cameras, stereo rig, IMU calibration and schedule."""
    if name == "euroc_stereo_inertial":
        pytest.importorskip("cv2")  # the JAX package rectifies with cv2
        path = tmp_path / f"{name}.yaml"
        path.write_text(EUROC_STEREO_INERTIAL)
        path = str(path)
    else:
        path = _config(name)
    ts = tset.Settings.from_yaml(path, sensor)
    js = jset.Settings.from_yaml(path, sensor)
    np.testing.assert_allclose(ts.cam.params_list(),
                               [float(v) for v in js.cam], rtol=1e-6)
    for f in ("fps", "bf", "th_depth", "imu_frequency", "imu_init_time",
              "viba1_time", "viba2_time"):
        np.testing.assert_allclose(getattr(ts, f), getattr(js, f),
                                   rtol=1e-6, err_msg=f)
    for f in ("n_features", "insert_kfs_when_lost", "camera_type"):
        assert getattr(ts, f) == getattr(js, f), f
    for f in ("noise_gyro", "noise_acc", "walk_gyro", "walk_acc"):
        assert getattr(ts.imu, f) == getattr(js.imu, f), f
    np.testing.assert_array_equal(ts.imu.t_bc, js.imu.t_bc)
    np.testing.assert_allclose(ts.imu.R_bc, js.imu.R_bc, atol=1e-6)
    assert ts.imu.R_bc.dtype == np.float32
    if sensor == "IMU_STEREO":
        assert ts.rect_maps is not None and js.rect_maps is not None
        # the extrinsic follows the rectifying rotation
        assert not np.allclose(ts.imu.R_bc, tset.Settings.from_yaml(
            path).imu.R_bc, atol=1e-5)
    else:
        assert ts.cam2 is js.cam2 is None


@pytest.mark.parametrize("name,sensor", [
    # the IMU section, read leniently: key for key as JAX
    ("euroc_mono_inertial", None),
    # no RGB-D section: JAX's SettingsError
    ("euroc_mono_inertial", "IMU_RGBD"),
    # no IMU section: JAX's SettingsError
    ("tum1_rgbd", "IMU_RGBD"),
])
def test_settings_from_yaml_imu_section(name, sensor):
    """The IMU section (calibration, extrinsic, rate, InsertKFsWhenLost) as
    JAX reads it, or JAX's required-parameter error."""
    try:
        js = jset.Settings.from_yaml(_config(name), sensor)
    except jset.SettingsError as e:
        with pytest.raises(tset.SettingsError) as got:
            tset.Settings.from_yaml(_config(name), sensor)
        assert str(got.value) == str(e)
        return
    ts = tset.Settings.from_yaml(_config(name), sensor)
    for f in ("noise_gyro", "noise_acc", "walk_gyro", "walk_acc"):
        assert getattr(ts.imu, f) == getattr(js.imu, f), f
    for f in ("R_bc", "t_bc"):
        np.testing.assert_array_equal(getattr(ts.imu, f),
                                      getattr(js.imu, f), err_msg=f)
        assert getattr(ts.imu, f).dtype == np.float32
    for f in ("imu_frequency", "insert_kfs_when_lost", "imu_init_time",
              "viba1_time", "viba2_time", "fps", "n_features"):
        assert getattr(ts, f) == getattr(js, f), f
    np.testing.assert_allclose(ts.cam.params_list(),
                               [float(v) for v in js.cam], rtol=1e-6)

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
  the fisheye and IMU configs raise naming their ROADMAP items.
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


@pytest.mark.parametrize("name,sensor,item", [
    ("tum_vi_mono", None, "14"),
    ("euroc_mono_inertial", None, "15"),
    ("euroc_mono", "IMU_MONOCULAR", "15"),
    ("euroc_mono", "STEREO", "14"),
])
def test_settings_from_yaml_unported_sections_raise(name, sensor, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        tset.Settings.from_yaml(_config(name), sensor)

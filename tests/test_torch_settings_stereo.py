"""The port's stereo and fisheye settings (``xfeatslam_tpu_torch/slam/
settings.py``) and its rectification without OpenCV
(``xfeatslam_tpu_torch/utils/rectification.py``) against the JAX
package's ``Settings``, which calls ``cv2`` (the installed 5.0).

Bars: the EuRoC-style unrectified pinhole rig of
``tests/test_settings.py::TestStereoRectification`` (and a rotated rig):
the rectification maps within 1e-3 px of cv2's, the rectified fx, fy, cx,
cy and bf within 1e-6 relative, ``rectify`` on a seeded uint8 pair equal
to cv2.remap sample for sample; ``examples/configs/tum_vi_mono.yaml`` and
a KannalaBrandt8 stereo file with lapping columns parsed to the same
cameras (float32 values), lapping, baseline, bf and th_depth; and the
port's settings path never imports cv2."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from xfeatslam_tpu.slam import settings as jset  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402
from xfeatslam_tpu_torch.slam import settings as tset  # noqa: E402
from xfeatslam_tpu_torch.utils import rectification  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EUROC = """%YAML:1.0
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
Stereo.ThDepth: 35.0
Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [{data}]
Camera.width: 752
Camera.height: 480
Camera.fps: 20
Camera.RGB: 1
ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""

KB_STEREO = """%YAML:1.0
File.version: "1.0"
Camera.type: "KannalaBrandt8"
Camera1.fx: 190.978477
Camera1.fy: 190.973307
Camera1.cx: 254.931706
Camera1.cy: 256.897442
Camera1.k1: 0.003482389402
Camera1.k2: 0.000715034845
Camera1.k3: -0.002053236141
Camera1.k4: 0.000202936736
Camera2.fx: 190.442369
Camera2.fy: 190.434438
Camera2.cx: 252.597254
Camera2.cy: 254.917230
Camera2.k1: 0.003400301114
Camera2.k2: 0.000765898202
Camera2.k3: -0.002020265558
Camera2.k4: 0.000198432990
Camera1.overlappingBegin: 0
Camera1.overlappingEnd: 511
Camera2.overlappingBegin: 0
Camera2.overlappingEnd: 511
Stereo.ThDepth: 40.0
Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [0.999997, -0.002027, 0.001165, 0.101073,
         0.002028, 0.999997, -0.001120, -0.001963,
         -0.001163, 0.001122, 0.999999, -0.000734,
         0.0, 0.0, 0.0, 1.0]
Camera.width: 512
Camera.height: 512
Camera.newWidth: 256
Camera.newHeight: 256
Camera.fps: 20
Camera.RGB: 1
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def _rig(rotated: bool):
    T = np.eye(4)
    T[0, 3] = 0.11
    if rotated:
        T[:3, :3] = rectification.rodrigues(np.array([0.01, -0.02, 0.005]))
        T[:3, 3] = [0.11, 0.003, -0.002]
    return ", ".join(f"{v:.6f}" for v in T.reshape(-1))


@pytest.fixture(scope="module", params=["along_x", "rotated"])
def euroc(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("stereo") / "euroc.yaml"
    path.write_text(EUROC.replace(
        "{data}", _rig(request.param == "rotated")))
    return (jset.Settings.from_yaml(str(path), sensor="STEREO"),
            tset.Settings.from_yaml(str(path), sensor="STEREO"))


def test_rectification_maps_and_calibration_match_cv2(euroc):
    j, t = euroc
    assert t.need_rectify and j.need_rectify
    assert t.baseline == pytest.approx(j.baseline, rel=1e-6)
    for a, b in zip(t.rect_maps, j.rect_maps):
        assert a.dtype == np.float32 and a.shape == b.shape == (480, 752)
        assert np.abs(a - b).max() <= 1e-3
    assert isinstance(t.cam, tc.Pinhole)
    for f in ("fx", "fy", "cx", "cy"):
        assert getattr(t.cam, f) == pytest.approx(float(getattr(j.cam, f)),
                                                  rel=1e-6)
    assert t.bf == pytest.approx(j.bf, rel=1e-6)
    assert t.th_depth == pytest.approx(j.th_depth, rel=1e-6)
    assert t.cam2 is not None and t.dist2 == j.dist2


def test_rectify_equals_cv2_remap(euroc):
    j, t = euroc
    rng = np.random.default_rng(0)
    left = rng.integers(0, 256, (480, 752), np.uint8)
    right = rng.integers(0, 256, (480, 752), np.uint8)
    for a, b in zip(t.rectify(left, right), j.rectify(left, right)):
        assert a.dtype == np.uint8 and a.shape == (480, 752)
        np.testing.assert_array_equal(a, b)


def test_remap_linear_equals_cv2_on_odd_maps():
    """Fractions on exact halves, coordinates off the image on every side,
    a map smaller than the image."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (37, 53), np.uint8)
    for scale in (64, None):
        shape = (41, 29)
        if scale:
            mx = rng.integers(-3 * scale, 56 * scale, shape) / scale
            my = rng.integers(-3 * scale, 40 * scale, shape) / scale
        else:
            mx = rng.uniform(-3, 56, shape)
            my = rng.uniform(-3, 40, shape)
        mx, my = mx.astype(np.float32), my.astype(np.float32)
        np.testing.assert_array_equal(
            rectification.remap_linear(img, mx, my),
            cv2.remap(img, mx, my, cv2.INTER_LINEAR))


def test_tum_vi_mono_parses_to_the_same_kb8():
    path = os.path.join(REPO, "examples", "configs", "tum_vi_mono.yaml")
    j = jset.Settings.from_yaml(path, sensor="MONOCULAR")
    t = tset.Settings.from_yaml(path, sensor="MONOCULAR")
    assert isinstance(t.cam, tc.KannalaBrandt8)
    np.testing.assert_array_equal(np.float32(t.cam.params_list()),
                                  np.float32(j.cam.params_list()))
    assert (t.width, t.height, t.n_features) == (j.width, j.height,
                                                 j.n_features)
    assert t.cam2 is None and t.lapping1 is None and not t.need_rectify


def test_kb8_stereo_with_lapping(tmp_path):
    path = tmp_path / "kb_stereo.yaml"
    path.write_text(KB_STEREO)
    j = jset.Settings.from_yaml(str(path), sensor="STEREO")
    t = tset.Settings.from_yaml(str(path), sensor="STEREO")
    assert isinstance(t.cam, tc.KannalaBrandt8)
    assert isinstance(t.cam2, tc.KannalaBrandt8)
    for a, b in ((t.cam, j.cam), (t.cam2, j.cam2)):
        np.testing.assert_allclose(np.float32(a.params_list()),
                                   np.float32(b.params_list()), rtol=1e-6)
    # camera 2 reads Camera1.k* (the reference's quirk), and the resize
    # halves the calibration and the lapping columns
    assert t.cam2.k0 == t.cam.k0 and t.cam.fx == pytest.approx(95.4892385)
    assert t.lapping1 == j.lapping1 == (0, 255)
    assert t.lapping2 == j.lapping2 == (0, 255)
    np.testing.assert_array_equal(t.T_c1_c2, j.T_c1_c2)
    assert t.T_c1_c2.dtype == np.float32
    for f in ("baseline", "bf", "th_depth"):
        assert getattr(t, f) == pytest.approx(getattr(j, f), rel=1e-6), f
    assert not t.need_rectify and t.rect_maps is None
    img = np.zeros((4, 4), np.uint8)
    assert t.rectify(img, img)[0] is img


def test_settings_path_imports_no_cv2(tmp_path):
    """The rectification and the settings reader run without cv2, which
    the port does not depend on."""
    path = tmp_path / "euroc.yaml"
    path.write_text(EUROC.replace("{data}", _rig(True)))
    code = (
        "import sys\n"
        "from xfeatslam_tpu_torch.slam.settings import Settings\n"
        "import numpy as np\n"
        f"s = Settings.from_yaml({str(path)!r}, sensor='STEREO')\n"
        "img = np.zeros((480, 752), np.uint8)\n"
        "s.rectify(img, img)\n"
        "assert 'cv2' not in sys.modules, 'cv2 imported'\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr

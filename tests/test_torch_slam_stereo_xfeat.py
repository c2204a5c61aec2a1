"""The port's XFeat stereo System (``System(Sensor.STEREO)``, every
steady-state pair through ``track_step.xfeat_stereo_frame_step``) against
the JAX package's on the rendered stereo rig of
``tests/test_torch_slam_stereo.py`` (384x288, 6 frames), with that file's
bars: the same states, keyframe and tracking counts, frames 1-5 through
the stereo step, every frame within 8 cm of the truth, within 0.01 mm of
the JAX System (measured 2.3e-3 mm), the keyframes' stereo observations
through atlas files loaded equal by both packages. A file of its own to
keep each near a minute on one worker."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_slam_stereo import check_stereo_system, seq  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_xfeat_stereo_system_matches_jax(seq, tmp_path):  # noqa: F811
    check_stereo_system(seq, "xfeat", 1e-5, tmp_path)

"""The port's System through a KannalaBrandt8 (fisheye) camera against the
JAX System on the same rendered fisheye frames.

The JAX System takes a KB8 camera (``examples/mono_tum_vi.py`` builds one
from ``tum_vi_mono.yaml``): its frames keep the raw keypoints
(``kpts_un = kpts``), its whole-frame step is skipped for a camera that
is not pinhole, and its optimizers project through the camera's fx, fy,
cx, cy alone. The port follows it. The frames are
``utils/synthetic.RoomScene`` rendered at 384x288 along
``make_sequence``'s orbit through the rays of a KB8 camera with the
TUM-VI distortion. Bars: RGB-D, XFeat, 8 frames: identical states,
keyframe counts and tracking counts, every camera centre within 1 mm of
the JAX System's (the bar of ``tests/test_torch_slam_system.py``);
monocular: the port initializes and tracks every frame after it (its
RANSAC draws are its own, as in ``tests/test_torch_slam_mono.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.ops import camera as jc  # noqa: E402
from xfeatslam_tpu.slam import settings as jset  # noqa: E402
from xfeatslam_tpu.slam import system as jsys  # noqa: E402
from xfeatslam_tpu.utils import synthetic as jsyn  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402
from xfeatslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from xfeatslam_tpu_torch.slam import settings as tset  # noqa: E402
from xfeatslam_tpu_torch.slam import system as tsys  # noqa: E402

HW = (288, 384)
# TUM-VI's KB8 distortion (examples/configs/tum_vi_mono.yaml) on the
# 384x288 image
KB8 = [230.0, 230.0, 191.5, 143.5, 0.0034823894, 0.0007150348,
       -0.0020532361, 0.00020293673]
SETTINGS = dict(camera_type="KannalaBrandt8", bf=24.0, th_depth=3.0,
                depth_map_factor=1.0, n_features=500, fps=30.0)


def _render(n_frames):
    H, W = HW
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    uv = np.stack([u, v], -1).reshape(-1, 2)
    rays = np.asarray(jc.kb8_unproject(jc.KannalaBrandt8.from_list(KB8),
                                       jnp.asarray(uv))).reshape(H, W, 3)
    rays = rays / rays[..., 2:3]
    scene = jsyn.RoomScene(seed=0)
    poses = jsyn.orbit_trajectory(n_frames, period=120,
                                  forward_per_frame=0.005)
    frames = [scene.render(None, R, t, HW, rays_c=rays) for R, t in poses]
    return frames, np.array([-R.T @ t for R, t in poses])


def _run(system, frames, rgbd):
    states, centres = [], []
    for i, (gray, depth) in enumerate(frames):
        if rgbd:
            state, pose = system.track_rgbd(gray, depth, i / 30.0)
        else:
            state, pose = system.track_monocular(gray, i / 30.0)
        states.append(state.name)
        centres.append(None if pose is None else -pose[0].T @ pose[1])
    return states, centres


def test_kb8_rgbd_system_matches_jax():
    frames, _ = _render(8)
    js = jsys.System(jset.Settings(cam=jc.KannalaBrandt8.from_list(KB8),
                                   **SETTINGS),
                     jsys.Sensor.RGBD, backend="xfeat",
                     enable_loop_closing=False)
    ts = tsys.System(tset.Settings(cam=tc.KannalaBrandt8.from_list(KB8),
                                   **SETTINGS),
                     tsys.Sensor.RGBD, enable_loop_closing=False,
                     device="cpu")
    sj, cj = _run(js, frames, True)
    ck.reset_launch_counts()
    st, ct = _run(ts, frames, True)
    assert st == sj == ["OK"] * len(frames)
    assert ts.map.num_keyframes() == js.map.num_keyframes() >= 2
    assert ts.tracking.stats == js.tracking.stats
    # no whole-frame step for a camera that is not pinhole
    assert "fused_grab" not in ts.tracking.stats
    np.testing.assert_allclose(np.array(ct), np.array(cj), atol=1e-3)
    assert set(ck.launch_counts().values()) == {0}


def test_kb8_monocular_system_tracks():
    frames, _ = _render(14)
    ts = tsys.System(tset.Settings(cam=tc.KannalaBrandt8.from_list(KB8),
                                   **SETTINGS),
                     tsys.Sensor.MONOCULAR, enable_loop_closing=False,
                     device="cpu")
    states, centres = _run(ts, frames, False)
    first = states.index("OK")
    assert first <= 8, states
    assert states[first:] == ["OK"] * (len(frames) - first)
    assert ts.map.num_keyframes() >= 2
    assert all(np.isfinite(c).all() for c in centres[first:])

"""The PyTorch port's monocular-inertial SLAM,
``System(Sensor.IMU_MONOCULAR)`` with the ORB backend, held to
``tests/test_inertial_slam.py::TestImuMonocular``'s bars (not to a JAX
run).

Tier-1 runs it at 288x384 (the intrinsics scaled by 0.6) with 500
features on TestImuMonocular's sequence, biases, noise and Settings. Of
the shapes tried offline, that is the smallest at which the JAX package's
own System meets the bars: from frame 43 on (scale error 0.0056, ATE max
2.0 mm, gravity 0.041); at 240x320 it initializes only at frame 58 with a
scale error of 0.0795 (the bar is 0.08). The monocular IMU gate is 10
keyframes and 2 s of chain. The port's System starts its map from other
RANSAC draws than JAX's, and its chain, which keyframe culling thins,
reaches 10 keyframes later: it initializes at frame 50 (scale error
0.0015, ATE max 2.2 mm, gravity 0.044) and meets the bars on every frame
from there to 60. The test runs 53 frames, so the initialization may move
up to 3 frames later before the bars fail (each frame after it costs
~10 s on one CPU thread). The 60-frame 640x480 mirror
is ``slow``; it also runs on the card in ``chip_smoke.py``'s
``inertial_mono_stereo_phase``. A short XFeat run checks the other
backend's inertial chain."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xfeatslam_tpu_torch.slam.system import Sensor, System  # noqa: E402
from xfeatslam_tpu_torch.utils import synthetic  # noqa: E402

from test_torch_slam_imu_rgbd import (BA_INJ, BG_INJ,  # noqa: E402
                                      imu_settings, kf_centers_vs_gt,
                                      umeyama)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_vi_mono(n_frames, hw=(480, 640), n_features=1000, backend="orb",
                device="cpu"):
    """TestImuMonocular's run on the port: the rendered VI sequence, each
    frame with its IMU samples, through ``track_monocular``."""
    sc = hw[1] / 640.0
    K = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]],
                 np.float32) * np.array([[sc], [sc], [1]], np.float32)
    seq = synthetic.make_vi_sequence(
        n_frames=n_frames, fps=10.0, imu_rate=200.0, hw=hw, K=K, seed=0,
        bg=BG_INJ, ba=BA_INJ, noise_gyro=2e-4, noise_acc=2e-3)
    system = System(imu_settings(K, n_features), Sensor.IMU_MONOCULAR,
                    backend=backend, enable_loop_closing=False, device=device)
    for i in range(n_frames):
        system.track_monocular(seq["images"][i], seq["timestamps"][i],
                               imu=seq["imu"][i])
    return seq, system


def check_scale_becomes_metric(seq, system):
    """Monocular scale is unobservable visually; after the IMU
    initialization the map is metric."""
    assert system.map.imu_initialized
    est, gt, _ = kf_centers_vs_gt(system, seq)
    assert len(est) >= 6
    s, R, t = umeyama(est, gt, with_scale=True)
    assert abs(s - 1.0) < 0.08, s
    ate = np.linalg.norm((est @ R.T) * s + t - gt, axis=1)
    assert ate.max() < 0.08, ate


def check_gravity_aligned(seq, system):
    kf = sorted(system.map.keyframes.values(), key=lambda k: k.timestamp)[-1]
    Rg, _tg = seq["poses"][int(round(kf.timestamp * 10.0))]
    g_m = (kf.R.T @ Rg) @ seq["g_w"]
    assert np.linalg.norm(g_m - np.array([0, 0, -9.81])) < 0.5, g_m


CHECKS = {"scale_becomes_metric": check_scale_becomes_metric,
          "gravity_aligned": check_gravity_aligned}


@pytest.fixture(scope="module")
def small_run():
    return run_vi_mono(53, hw=(288, 384), n_features=500)


@pytest.mark.parametrize("bar", list(CHECKS))
def test_imu_mono_bars(small_run, bar):
    CHECKS[bar](*small_run)


def test_imu_mono_state(small_run):
    """The monocular inertial bookkeeping: monocular tracking and schedule,
    an IMU chain from the first keyframe whose edges span their keyframes'
    times, the initialization's record (each record a solve; none
    rejected), the transform handed on to tracking. No two-view attempt
    failed before the map started, so the reference frame was the one
    before the second: the initial pair's IMU edge is that frame's last
    segment, as JAX hands it on."""
    _seq, system = small_run
    assert system.tracking.sensor == "mono"
    assert system.tracking.stats.get("two_view_fail", 0) == 0
    lm = system.local_mapping
    assert lm.mono and (lm.imu_init_time, lm.imu_min_kfs) == (2.0, 10)
    kfs = sorted(system.map.keyframes.values(), key=lambda k: k.kid)
    assert kfs[0].prev_kf == -1 and kfs[0].pre_kf is None
    for kf in kfs[1:]:
        prev = system.map.keyframes[kf.prev_kf]
        assert kf.pre_kf is not None
        np.testing.assert_allclose(float(kf.pre_kf.dt),
                                   kf.timestamp - prev.timestamp, atol=1e-5)
        assert kf.vel is not None and np.isfinite(kf.vel).all()
    assert lm.init_debug  # the first initialization's record
    assert all(np.isfinite(rec[1]) and 1e-2 < rec[1] < 1e2
               for rec in lm.init_debug)
    assert lm.pending_map_transform is None
    assert not system.is_lost() and system.get_time_from_imu_init() > 2.0


def test_imu_mono_xfeat_chain():
    """The XFeat backend's IMU_MONOCULAR System: the map starts from two
    consecutive frames and its first keyframe pair carries the IMU edge
    between them (the frames before the map start: preintegrated, then
    dropped)."""
    seq, system = run_vi_mono(6, hw=(288, 384), n_features=500,
                              backend="xfeat")
    states = [s for (_t, _R, _tr, s) in system.tracking.trajectory]
    assert states and all(st.name == "OK" for st in states)
    kfs = sorted(system.map.keyframes.values(), key=lambda k: k.kid)
    assert len(kfs) >= 2
    kf1, kf2 = kfs[:2]
    assert (kf1.prev_kf, kf1.pre_kf, kf2.prev_kf) == (-1, None, kf1.kid)
    assert system.tracking.stats.get("two_view_fail", 0) == 0
    assert kf2.timestamp - kf1.timestamp == pytest.approx(0.1, abs=1e-6)
    np.testing.assert_allclose(float(kf2.pre_kf.dt),
                               kf2.timestamp - kf1.timestamp, atol=1e-5)
    assert all(s[0] > seq["timestamps"][5] for s in system.tracking.imu_queue)


@pytest.fixture(scope="module")
def full_run():
    return run_vi_mono(60)


@pytest.mark.slow
@pytest.mark.parametrize("bar", list(CHECKS))
def test_imu_mono_bars_60_frames(full_run, bar):
    """TestImuMonocular's own run: 60 frames at 640x480, 1000 features."""
    CHECKS[bar](*full_run)

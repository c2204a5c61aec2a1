"""The PyTorch port's stereo-inertial SLAM, ``System(Sensor.IMU_STEREO)``
with the ORB backend, held to ``tests/test_inertial_slam.py::
TestImuStereo``'s bars (not to a JAX run): its rendered rig (the right view
0.08 m along camera +x, ``bf = 0.08 * fx``), its sequence, biases, noise
and Settings.

Tier-1 runs it at 240x320 (the intrinsics scaled by 0.5) with 500
features over 23 pairs. Of the shapes tried offline, that is the smallest
at which the JAX package's own System meets the bars: it initializes the
IMU at pair 23 (1.0 s and 6 keyframes) with a scale error of 0.0046, ATE
max 2.4 mm and gravity 0.043, as at 288x384 (pair 23-24). The port's
System initializes at the same pair: scale error 0.0042, ATE max 2.4 mm,
gravity 0.044. The 50-pair 640x480 mirror is ``slow``; it also runs on the
card in ``chip_smoke.py``'s ``inertial_mono_stereo_phase``. A short XFeat
run checks the other backend: stereo-inertial frames skip the fused
stereo step and take ``build_stereo`` and the split path. Its keyframe
decisions are held pair for pair to the JAX package's XFeat IMU_STEREO
System on the same 14 pairs at 288x384: both make a keyframe on each of
the first 12 pairs (the close-point rule: fewer than 100 tracked points
nearer than ``th_depth``, 3 m, and more than 70 untracked ones), then
none on the last two."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xfeatslam_tpu.slam import system as jsys  # noqa: E402
from xfeatslam_tpu_torch.slam.system import Sensor, System  # noqa: E402
from xfeatslam_tpu_torch.utils import synthetic  # noqa: E402

from test_inertial_slam import make_imu_settings  # noqa: E402

from test_torch_slam_imu_rgbd import (BA_INJ, BG_INJ,  # noqa: E402
                                      imu_settings, kf_centers_vs_gt,
                                      umeyama)

BASELINE = 0.08


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def vi_stereo_pairs(n_frames, hw):
    """TestImuStereo's inputs: the VI sequence at ``hw`` (the intrinsics
    scaled to its width) and each right view rendered BASELINE along camera
    +x."""
    sc = hw[1] / 640.0
    K = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]],
                 np.float32) * np.array([[sc], [sc], [1]], np.float32)
    seq = synthetic.make_vi_sequence(
        n_frames=n_frames, fps=10.0, imu_rate=200.0, hw=hw, K=K, seed=0,
        bg=BG_INJ, ba=BA_INJ, noise_gyro=2e-4, noise_acc=2e-3)
    scene = synthetic.RoomScene(seed=0)
    rights = []
    for i in range(n_frames):
        R, t = seq["poses"][i]
        t_r = (t - np.array([BASELINE, 0, 0], np.float32)).astype(np.float32)
        rights.append(scene.render(K, R, t_r, hw)[0])
    return K, seq, rights


def track_pairs(system, seq, rights):
    """Track every pair with its IMU samples; after each, the keyframes it
    made and whether the IMU is initialized."""
    steps = []
    for i in range(len(rights)):
        n_kfs = system.tracking.stats["kfs"]
        system.track_stereo(seq["images"][i], rights[i], seq["timestamps"][i],
                            imu=seq["imu"][i])
        steps.append((system.tracking.stats["kfs"] - n_kfs,
                      system.map.imu_initialized))
    return steps


def run_vi_stereo(n_frames, hw=(480, 640), n_features=1000, backend="orb",
                  device="cpu"):
    """TestImuStereo's run on the port, tracked pair by pair with the IMU
    samples."""
    K, seq, rights = vi_stereo_pairs(n_frames, hw)
    settings = imu_settings(K, n_features)
    settings.bf = BASELINE * float(K[0, 0])
    system = System(settings, Sensor.IMU_STEREO, backend=backend,
                    enable_loop_closing=False, device=device)
    track_pairs(system, seq, rights)
    return seq, system


def check_initializes_and_metric(seq, system):
    assert system.map.imu_initialized
    est, gt, _ = kf_centers_vs_gt(system, seq)
    assert len(est) >= 6
    s, R, t = umeyama(est, gt, with_scale=True)
    assert abs(s - 1.0) < 0.03, s  # stereo is metric; the IMU keeps it so
    ate = np.linalg.norm((est @ R.T) * s + t - gt, axis=1)
    assert ate.max() < 0.06, ate


def check_gravity_aligned(seq, system):
    kf = sorted(system.map.keyframes.values(), key=lambda k: k.timestamp)[-1]
    Rg, _tg = seq["poses"][int(round(kf.timestamp * 10.0))]
    g_m = (kf.R.T @ Rg) @ seq["g_w"]
    assert np.linalg.norm(g_m - np.array([0, 0, -9.81])) < 0.4, g_m


CHECKS = {"initializes_and_metric": check_initializes_and_metric,
          "gravity_aligned": check_gravity_aligned}


@pytest.fixture(scope="module")
def small_run():
    return run_vi_stereo(23, hw=(240, 320), n_features=500)


@pytest.mark.parametrize("bar", list(CHECKS))
def test_imu_stereo_bars(small_run, bar):
    CHECKS[bar](*small_run)


def test_imu_stereo_state(small_run):
    """Stereo frames carry depth: the RGB-D tracker and schedule (not the
    monocular one), stereo observations in the keyframes, an IMU chain from
    the first keyframe with its preintegrations, every pair OK."""
    _seq, system = small_run
    assert system.tracking.sensor == "rgbd"
    lm = system.local_mapping
    assert not lm.mono and (lm.imu_init_time, lm.imu_min_kfs) == (1.0, 6)
    kfs = sorted(system.map.keyframes.values(), key=lambda k: k.kid)
    assert kfs[0].prev_kf == -1
    for kf in kfs:
        assert (kf.ur > 0).sum() > 100
    for kf in kfs[1:]:
        assert kf.prev_kf in system.map.keyframes
        assert kf.pre_kf is not None and float(kf.pre_kf.dt) > 0
        assert kf.vel is not None and np.isfinite(kf.vel).all()
    states = [s for (_t, _R, _tr, s) in system.tracking.trajectory]
    assert all(st.name == "OK" for st in states[1:])
    assert lm.pending_map_transform is None


XFEAT_PAIRS = 14


@pytest.fixture(scope="module")
def xfeat_runs():
    """Both packages' XFeat IMU_STEREO Systems on the same 14 pairs at
    288x384, 500 features: each System and its steps (``track_pairs``)."""
    K, seq, rights = vi_stereo_pairs(XFEAT_PAIRS, (288, 384))
    settings = imu_settings(K, 500)
    settings.bf = BASELINE * float(K[0, 0])
    port = System(settings, Sensor.IMU_STEREO, backend="xfeat",
                  enable_loop_closing=False, device="cpu")
    jsettings = make_imu_settings(K)
    jsettings.bf, jsettings.n_features = settings.bf, 500
    jax = jsys.System(jsettings, jsys.Sensor.IMU_STEREO, backend="xfeat",
                      enable_loop_closing=False)
    return {"port": (port, track_pairs(port, seq, rights)),
            "jax": (jax, track_pairs(jax, seq, rights))}


def test_imu_stereo_xfeat_split_path(xfeat_runs):
    """The XFeat backend's IMU_STEREO System: every pair OK, no pair
    through the fused stereo step (the IMU needs the split path), and the
    IMU chain on the keyframes."""
    system, _steps = xfeat_runs["port"]
    tr = system.tracking
    states = [s for (_t, _R, _tr, s) in tr.trajectory]
    assert (len(states) == XFEAT_PAIRS
            and all(st.name == "OK" for st in states))
    assert tr.stats.get("fused_grab", 0) == 0
    kfs = sorted(system.map.keyframes.values(), key=lambda k: k.kid)
    assert len(kfs) >= 2 and kfs[0].prev_kf == -1
    for kf in kfs[1:]:
        assert kf.prev_kf in system.map.keyframes
        assert kf.pre_kf is not None and float(kf.pre_kf.dt) > 0


def test_imu_stereo_xfeat_keyframes_as_jax(xfeat_runs):
    """The port's keyframe decisions on stereo-inertial XFeat pairs equal
    the JAX package's, pair for pair, as do the tracking states, the
    tracker's counters and the pair at which the IMU initializes."""
    (ps, p_steps), (js, j_steps) = xfeat_runs["port"], xfeat_runs["jax"]
    assert p_steps == j_steps
    made = [m for (m, _init) in p_steps]
    assert 0 < sum(made) < XFEAT_PAIRS  # the rules also decline keyframes
    assert p_steps[-1][1]  # initialized within the run
    assert ([s.name for (*_, s) in ps.tracking.trajectory]
            == [s.name for (*_, s) in js.tracking.trajectory])
    assert ps.tracking.stats == js.tracking.stats


@pytest.fixture(scope="module")
def full_run():
    return run_vi_stereo(50)


@pytest.mark.slow
@pytest.mark.parametrize("bar", list(CHECKS))
def test_imu_stereo_bars_50_pairs(full_run, bar):
    """TestImuStereo's own run: 50 pairs at 640x480, 1000 features."""
    CHECKS[bar](*full_run)

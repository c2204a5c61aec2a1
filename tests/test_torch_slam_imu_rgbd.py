"""The PyTorch port's visual-inertial RGB-D SLAM, ``System(Sensor.IMU_RGBD)``
with the ORB backend, held to ``tests/test_inertial_slam.py::TestImuRgbd``'s
bars (not to a JAX run).

Tier-1 runs it at a size the CPU affords: ``make_vi_sequence`` at 288x384
(the intrinsics scaled by 0.6), 500 features, 30 frames (3 s) and the IMU
schedule init 1.0 s / VIBA1 2.0 s / VIBA2 2.5 s. That is the shortest
sequence and schedule of those tried, offline, at which the JAX package's
System meets every TestImuRgbd bar: at 288x384 with 500 features, 25, 27
and 28 frames with VIBA1 at 1.5-1.8 s never run VIBA1 and 20 frames never
initialize; with 1000 features every run from 30 to 45 frames (and 30 or
35 at 240x320) keeps five keyframes, and 50 frames pass. The 60-frame
640x480 mirror of all five TestImuRgbd tests is ``slow``; it also runs on
the card in ``chip_smoke.py``'s ``inertial_phase``. The same 30-frame run
also carries TestInertialSerialization's atlas round trip, the
preintegration records read and written across the two packages, and
TestSaveDebugData."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xfeatslam_tpu_torch.ops.camera import Pinhole  # noqa: E402
from xfeatslam_tpu_torch.ops.imu import ImuCalib  # noqa: E402
from xfeatslam_tpu_torch.slam.settings import Settings  # noqa: E402
from xfeatslam_tpu_torch.slam.system import Sensor, System  # noqa: E402
from xfeatslam_tpu_torch.utils import synthetic  # noqa: E402

# TestImuRgbd's injected biases
BG_INJ = np.array([0.004, -0.003, 0.002], np.float32)
BA_INJ = np.array([0.03, -0.02, 0.04], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def umeyama(src, dst, with_scale=False):
    """Least-squares similarity aligning src -> dst: (s, R, t)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    X, Y = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(Y.T @ X / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = (float((D * np.diagonal(S)).sum() / ((X * X).sum() / len(src)))
         if with_scale else 1.0)
    return s, R, mu_d - s * R @ mu_s


def imu_settings(K, n_features=1000, schedule=(1.0, 2.5, 3.5)):
    """TestImuRgbd's Settings (its IMU noise, bf 40, metric depth, 10 fps)."""
    calib = ImuCalib(noise_gyro=2e-4, noise_acc=2e-3, walk_gyro=1e-6,
                     walk_acc=1e-5, R_bc=np.eye(3, dtype=np.float32),
                     t_bc=np.zeros(3, np.float32))
    return Settings(cam=Pinhole.from_list([K[0, 0], K[1, 1], K[0, 2],
                                           K[1, 2]]),
                    bf=40.0, th_depth=3.0, depth_map_factor=1.0, imu=calib,
                    fps=10.0, n_features=n_features,
                    imu_init_time=schedule[0], viba1_time=schedule[1],
                    viba2_time=schedule[2])


def run_vi(n_frames, hw=(480, 640), n_features=1000,
           schedule=(1.0, 2.5, 3.5), device="cpu", backend="orb"):
    """TestImuRgbd's run on the port: the rendered VI sequence with its
    injected biases and noise, tracked frame by frame with the IMU samples."""
    sc = hw[1] / 640.0
    K = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]],
                 np.float32) * np.array([[sc], [sc], [1]], np.float32)
    seq = synthetic.make_vi_sequence(
        n_frames=n_frames, fps=10.0, imu_rate=200.0, hw=hw, K=K, seed=0,
        bg=BG_INJ, ba=BA_INJ, noise_gyro=2e-4, noise_acc=2e-3)
    system = System(imu_settings(K, n_features, schedule), Sensor.IMU_RGBD,
                    backend=backend, enable_loop_closing=False, device=device)
    for i in range(n_frames):
        system.track_rgbd(seq["images"][i], seq["depths"][i],
                          seq["timestamps"][i], imu=seq["imu"][i])
    return seq, system


def kf_centers_vs_gt(system, seq):
    kfs = sorted(system.map.keyframes.values(), key=lambda k: k.timestamp)
    est, gt = [], []
    for kf in kfs:
        Rg, tg = seq["poses"][int(round(kf.timestamp * 10.0))]
        est.append(kf.center())
        gt.append(-Rg.T @ tg)
    return np.asarray(est), np.asarray(gt), kfs


def check_schedule(system):
    m = system.map
    assert m.imu_initialized and m.imu_ba1 and m.imu_ba2


def check_gravity(seq, system):
    """The map's gravity is (0,0,-9.81) although the true gravity is tilted
    ~10 degrees off the first camera's -z."""
    kf = sorted(system.map.keyframes.values(), key=lambda k: k.timestamp)[-1]
    Rg, _tg = seq["poses"][int(round(kf.timestamp * 10.0))]
    g_m = (kf.R.T @ Rg) @ seq["g_w"]
    assert np.linalg.norm(g_m - np.array([0, 0, -9.81])) < 0.35, g_m


def check_ate_and_scale(seq, system):
    est, gt, _ = kf_centers_vs_gt(system, seq)
    assert len(est) >= 6
    s, R, t = umeyama(est, gt, with_scale=True)
    assert abs(s - 1.0) < 0.03, s
    ate = np.linalg.norm((est @ R.T) * s + t - gt, axis=1)
    assert ate.max() < 0.05, ate


def check_velocities_and_biases(seq, system):
    est, gt, kfs = kf_centers_vs_gt(system, seq)
    _s, R_mw, _t = umeyama(est, gt)
    for kf in kfs[-3:]:
        assert kf.vel is not None
        idx = int(round(kf.timestamp * 10.0))
        assert np.linalg.norm(R_mw @ kf.vel - seq["v_w"][idx]) < 0.08
    assert np.linalg.norm(system.map.imu_bg - BG_INJ) < 2e-3
    assert np.linalg.norm(system.map.imu_ba - BA_INJ) < 4e-2


def check_tracking_ok(system):
    states = [s for (_t, _R, _tr, s) in system.tracking.trajectory]
    assert all(st.name == "OK" for st in states[1:]), [st.name
                                                        for st in states]


CHECKS = {
    "schedule": lambda seq, system: check_schedule(system),
    "gravity": check_gravity,
    "ate_and_scale": check_ate_and_scale,
    "velocities_and_biases": check_velocities_and_biases,
    "tracking_ok": lambda seq, system: check_tracking_ok(system),
}


@pytest.fixture(scope="module")
def small_run():
    return run_vi(30, hw=(288, 384), n_features=500,
                  schedule=(1.0, 2.0, 2.5))


@pytest.mark.parametrize("bar", list(CHECKS))
def test_imu_rgbd_bars(small_run, bar):
    CHECKS[bar](*small_run)


def test_imu_rgbd_state(small_run):
    """The run's inertial bookkeeping: a temporal keyframe chain with
    preintegrations, keyframe velocities and biases after initialization,
    the inertial solvers' host-side results in the map's frame."""
    _seq, system = small_run
    kfs = sorted(system.map.keyframes.values(), key=lambda k: k.kid)
    assert kfs[0].prev_kf == -1
    for kf in kfs[1:]:
        assert kf.prev_kf in system.map.keyframes
        assert kf.pre_kf is not None and float(kf.pre_kf.dt) > 0
        assert kf.vel is not None and np.isfinite(kf.vel).all()
    lm = system.local_mapping
    assert lm.init_sect == 3 and len(lm.init_debug) == 3
    assert lm.pending_map_transform is None  # handed on to tracking
    assert system.is_lost() is False
    assert system.get_time_from_imu_init() > 2.0
    # the tracked frames' IMU queue is drained up to the last frame
    assert all(s[0] > system.tracking.last_frame.timestamp
               for s in system.tracking.imu_queue)


def test_imu_rgbd_requires_an_imu_section():
    settings = imu_settings(np.eye(3, dtype=np.float32) * 100)
    settings.imu = None
    with pytest.raises(ValueError, match="requires an IMU section"):
        System(settings, Sensor.IMU_RGBD, device="cpu")


def test_imu_rgbd_defaults_to_cuda():
    """Without ``device`` the System runs on CUDA; on a host without a GPU
    it raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    K = np.array([[310.0, 0, 191.0], [0, 310.0, 153.0], [0, 0, 1]],
                 np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        System(imu_settings(K), Sensor.IMU_RGBD, backend="orb",
               enable_loop_closing=False)


def test_inertial_atlas_round_trip(small_run, tmp_path):
    """TestInertialSerialization's checks on the 30-frame run: the atlas
    carries the map's IMU flags and biases and every keyframe's velocity,
    biases, chain link and preintegration."""
    from xfeatslam_tpu_torch.slam import serialization

    _seq, system = small_run
    assert system.map.imu_initialized
    path = str(tmp_path / "atlas_imu.zip")
    system.save_atlas(path)
    m1, m2 = system.map, serialization.load_atlas(path).active
    assert m2.imu_initialized == m1.imu_initialized
    assert m2.imu_ba1 == m1.imu_ba1 and m2.imu_ba2 == m1.imu_ba2
    np.testing.assert_allclose(m2.imu_bg, m1.imu_bg, atol=1e-7)
    np.testing.assert_allclose(m2.imu_ba, m1.imu_ba, atol=1e-7)
    n_pre = 0
    for kid, kf in m1.keyframes.items():
        kf2 = m2.keyframes[kid]
        assert kf2.prev_kf == kf.prev_kf
        np.testing.assert_array_equal(kf2.bg, kf.bg)
        np.testing.assert_array_equal(kf2.ba, kf.ba)
        if kf.vel is not None:
            np.testing.assert_allclose(kf2.vel, kf.vel, atol=1e-6)
        assert (kf2.pre_kf is None) == (kf.pre_kf is None)
        if kf.pre_kf is not None:
            n_pre += 1
            np.testing.assert_allclose(np.asarray(kf2.pre_kf.dP),
                                       np.asarray(kf.pre_kf.dP), atol=1e-6)
            np.testing.assert_allclose(np.asarray(kf2.pre_kf.cov),
                                       np.asarray(kf.pre_kf.cov), rtol=1e-5,
                                       atol=1e-8)
            for a, b in zip(kf2.pre_kf, kf.pre_kf):
                np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    assert n_pre == len(m1.keyframes) - 1


def test_preintegration_records_across_packages(small_run, tmp_path):
    """The run's atlas written by the port is read by the JAX package, which
    writes it again; the port reads that file back: every preintegration
    equal, and each flat record equal to the JAX package's own flattening
    of the same preintegration."""
    from xfeatslam_tpu.slam import serialization as jser
    from xfeatslam_tpu_torch.slam import serialization as tser

    _seq, system = small_run
    path1, path2 = str(tmp_path / "port.zip"), str(tmp_path / "jax.zip")
    system.save_atlas(path1)
    jatlas = jser.load_atlas(path1)
    jser.save_atlas(jatlas, path2)
    back = tser.load_atlas(path2).active
    for kid, kf in system.map.keyframes.items():
        jkf = jatlas.active.keyframes[kid]
        assert (jkf.prev_kf, back.keyframes[kid].prev_kf) == (kf.prev_kf,) * 2
        if kf.pre_kf is None:
            assert jkf.pre_kf is None and back.keyframes[kid].pre_kf is None
            continue
        np.testing.assert_array_equal(tser.flatten_pre(kf.pre_kf),
                                      jser._flatten_pre(kf.pre_kf))
        for a, b, c in zip(kf.pre_kf, jkf.pre_kf, back.keyframes[kid].pre_kf):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a,
                                                                    np.float32))
            np.testing.assert_array_equal(c, np.asarray(b))
    assert tser.PRE_RECORD_SIZE == 292
    with pytest.raises(ValueError, match="292"):
        tser.unflatten_pre(np.zeros(291, np.float32))


def test_save_debug_data(small_run, tmp_path):
    """TestSaveDebugData on the port: nothing before an initialization;
    the JAX test's record in its files; and the run's own records written
    byte for byte as the JAX package's ``save_debug_data`` writes them."""
    import types

    from xfeatslam_tpu.slam import system as jsys

    _seq, system = small_run
    lm = system.local_mapping
    saved = (lm.init_sect, lm.init_debug)
    (tmp_path / "none").mkdir()
    lm.init_debug = []
    system.save_debug_data(0, str(tmp_path / "none"))
    assert not list((tmp_path / "none").iterdir())
    lm.init_sect = 1
    lm.init_debug = [(1, 1.03, np.eye(3, dtype=np.float32), 12.5, 10)]
    try:
        out = tmp_path / "one"
        out.mkdir()
        system.save_debug_data(0, str(out))
        names = {p.name for p in out.iterdir()}
        assert names == {"init_FrameTrajectory_1_0.txt", "init_Scale_1.txt",
                         "init_GDir_1.txt", "init_CompCost_1.txt",
                         "init_KF_1.txt"}
        assert (out / "init_Scale_1.txt").read_text() == "1.03\n"
        gdir = (out / "init_GDir_1.txt").read_text().splitlines()
        assert len(gdir) == 3 and gdir[0].split(",")[0] == "1.0"
    finally:
        lm.init_sect, lm.init_debug = saved
    assert lm.init_debug
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
    system.save_debug_data(2, str(tmp_path / "port"))
    jsys.System.save_debug_data(
        types.SimpleNamespace(local_mapping=lm,
                              save_trajectory_euroc=system.save_trajectory_euroc),
        2, str(tmp_path / "jax"))
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(files) == 5
    for name in files:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


@pytest.fixture(scope="module")
def full_run():
    return run_vi(60)


@pytest.mark.slow
@pytest.mark.parametrize("bar", list(CHECKS))
def test_imu_rgbd_bars_60_frames(full_run, bar):
    """TestImuRgbd's own run: 60 frames at 640x480, 1000 features."""
    CHECKS[bar](*full_run)

"""The port's ORB RGB-D SLAM (``System(backend="orb")``) against the JAX
System with ``backend="orb"`` on the same rendered frames, the ORB atlas
files across the two packages, relocalization and localization mode with
ORB features, the ``USE_ORB`` switch and the example's ``--backend
orb``.

The sequence is ``utils/synthetic.make_sequence`` at 384x288 with the TUM1
intrinsics scaled by 0.6 and 1000 features, loop closing off. Bars: both
Systems OK on every frame and within the JAX package's 14-frame ORB bars
against the truth (max < 1 cm, median < 5 mm, >= 1 keyframe), the same
keyframe and tracking counts, and the port within 0.05 mm of the JAX
System on every frame (measured 0.0142 mm: the pyramid levels are resized
with JAX's weights and order, ~1 ulp from ``jax.image.resize``). The 640x480 runs of ``tests/test_slam_integration.py``'s
ORB tests (14 frames, 40 frames) through both Systems are ``slow``."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# both packages resolve the BRIEF pattern when imported
os.environ["XFEATSLAM_BRIEF_PATTERN"] = "gaussian"

from xfeatslam_tpu.models import orb as jorb  # noqa: E402
from xfeatslam_tpu.ops import camera as jc  # noqa: E402
from xfeatslam_tpu.slam import serialization as jser  # noqa: E402
from xfeatslam_tpu.slam import settings as jset  # noqa: E402
from xfeatslam_tpu.slam import system as jsys  # noqa: E402
from xfeatslam_tpu.utils import synthetic as jsyn  # noqa: E402
from xfeatslam_tpu_torch.examples import rgbd_tum  # noqa: E402
from xfeatslam_tpu_torch.models import orb as torb  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402
from xfeatslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from xfeatslam_tpu_torch.ops.imu import ImuCalib  # noqa: E402
from xfeatslam_tpu_torch.slam import serialization as tser  # noqa: E402
from xfeatslam_tpu_torch.slam import settings as tset  # noqa: E402
from xfeatslam_tpu_torch.slam import system as tsys  # noqa: E402
from xfeatslam_tpu_torch.utils import io as tio  # noqa: E402

from test_torch_serialization import assert_same_atlas  # noqa: E402

N_FRAMES, HW, SCALE, N_FEATURES = 8, (288, 384), 0.6, 1000
KMAT = np.array([[517.3 * SCALE, 0, 318.6 * SCALE],
                 [0, 516.5 * SCALE, 255.3 * SCALE], [0, 0, 1]], np.float32)
CAMP = [float(KMAT[0, 0]), float(KMAT[1, 1]), float(KMAT[0, 2]),
        float(KMAT[1, 2])]
SETTINGS = dict(bf=40.0 * SCALE, th_depth=3.0, depth_map_factor=1.0,
                n_features=N_FEATURES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(system, seq, n):
    states, centres = [], []
    for i in range(n):
        state, pose = system.track_rgbd(seq["images"][i], seq["depths"][i],
                                        seq["timestamps"][i])
        states.append(state.name)
        centres.append(-pose[0].T @ pose[1])
    return states, np.array(centres)


@pytest.fixture(scope="module")
def runs():
    """Both ORB Systems over the same frames, each run once."""
    seq = jsyn.make_sequence(n_frames=N_FRAMES, hw=HW, K=KMAT)
    js = jsys.System(jset.Settings(cam=jc.Pinhole.from_list(CAMP), **SETTINGS),
                     jsys.Sensor.RGBD, backend="orb",
                     enable_loop_closing=False)
    ts = tsys.System(tset.Settings(cam=tc.Pinhole.from_list(CAMP), **SETTINGS),
                     tsys.Sensor.RGBD, backend="orb",
                     enable_loop_closing=False, device="cpu")
    ck.reset_launch_counts()
    return {"jax": _run(js, seq, N_FRAMES), "port": _run(ts, seq, N_FRAMES),
            "launches": ck.launch_counts(), "jax_sys": js, "port_sys": ts,
            "truth": np.array([-R.T @ t for (R, t) in seq["poses"]])}


def test_patterns_agree():
    np.testing.assert_array_equal(torb._PATTERN, jorb._PATTERN)


def test_orb_system_matches_jax(runs):
    (sj, cj), (st, ct) = runs["jax"], runs["port"]
    assert st == sj == ["OK"] * N_FRAMES
    js, ts = runs["jax_sys"], runs["port_sys"]
    assert isinstance(ts.extractor, torb.ORBExtractor)
    assert ts.map.desc_dim == 256 and ts.map.n_levels == 8
    assert ts.map.num_keyframes() == js.map.num_keyframes() >= 1
    assert ts.tracking.stats == js.tracking.stats
    # every frame after the first through both tracking stages at once
    assert ts.tracking.stats["motion_ok"] == N_FRAMES - 1
    truth = runs["truth"]
    for c in (cj, ct):
        err = np.linalg.norm(c - truth, axis=1)
        assert err.max() < 0.01 and np.median(err) < 0.005, err
    assert np.linalg.norm(ct - cj, axis=1).max() < 5e-5
    # ORB frames carry orientations and octaves into the map
    kf = ts.map.keyframes[0]
    assert kf.desc.shape[1] == 256 and kf.octave.max() > 0
    assert np.abs(kf.angle[kf.valid]).max() > 0
    # CPU tensors never launch a kernel
    assert set(runs["launches"].values()) == {0}


def test_orb_atlas_across_packages(runs, tmp_path):
    """The ORB atlas (desc_dim 256, 8 levels) saved by either package loads
    in the other, equal; the port's own reload keeps the keypoint octaves
    and the points' scale bands, which the JAX format does not hold."""
    js, ts = runs["jax_sys"], runs["port_sys"]
    pj, pt = str(tmp_path / "jax.osa"), str(tmp_path / "port.osa")
    js.save_atlas(pj)
    ts.save_atlas(pt)
    for path in (pj, pt):
        a, b = jser.load_atlas(path), tser.load_atlas(path)
        assert a.desc_dim == b.desc_dim == 256
        assert_same_atlas(a, b)
        for m in b.maps.values():
            assert (m.desc_dim, m.n_levels, m.scale_factor) == (256, 8, 1.2)
        assert (b.n_levels, b.scale_factor) == (8, 1.2)
    own = tser.load_atlas(pt)
    m0, m1 = ts.map, own.maps[ts.map.map_id]
    n = m0.points.n
    for k, kf in m0.keyframes.items():
        np.testing.assert_array_equal(m1.keyframes[k].octave, kf.octave)
    for f in ("octave", "dmin", "dmax"):
        np.testing.assert_array_equal(getattr(m1.points, f)[:n],
                                      getattr(m0.points, f)[:n])


def test_orb_relocalization_and_localization_mode(runs):
    """Drives the port's ORB System further (after the tests that read it
    as the frames left it): a lost tracker given frames 0 and 3 again
    relocalizes each within 1 cm through the binary matchers, PnP and the
    widening ladder, with the map unchanged; then localization mode tracks
    frames 4-7 within 1 cm without growing the map."""
    from xfeatslam_tpu_torch.slam.tracking import State

    ts = runs["port_sys"]
    seq = jsyn.make_sequence(n_frames=N_FRAMES, hw=HW, K=KMAT)
    n_kf, n_pts = ts.map.num_keyframes(), ts.map.num_points()
    t = seq["timestamps"][-1]
    for f in (0, 3):
        ts.tracking.state = State.LOST
        t += 0.1
        state, pose = ts.track_rgbd(seq["images"][f], seq["depths"][f], t)
        err = np.linalg.norm(-pose[0].T @ pose[1] - runs["truth"][f])
        assert state.name == "OK" and err < 0.01, (f, state, err)
        assert (ts.map.num_keyframes(), ts.map.num_points()) == (n_kf, n_pts)
    ts.activate_localization_mode()
    for f in range(4, N_FRAMES):
        t += 1 / 30
        state, pose = ts.track_rgbd(seq["images"][f], seq["depths"][f], t)
        err = np.linalg.norm(-pose[0].T @ pose[1] - runs["truth"][f])
        assert state.name == "OK" and err < 0.01, (f, state, err)
    assert (ts.map.num_keyframes(), ts.map.num_points()) == (n_kf, n_pts)
    ts.deactivate_localization_mode()


def test_use_orb_selects_orb(monkeypatch):
    settings = tset.Settings(cam=tc.Pinhole.from_list(CAMP), **SETTINGS)
    monkeypatch.setenv("USE_ORB", "1")
    s = tsys.System(settings, tsys.Sensor.RGBD, enable_loop_closing=False,
                    device="cpu")
    assert s.backend == "orb" and isinstance(s.extractor, torb.ORBExtractor)
    assert s.tracking.cfg.binary and s.local_mapping.profile.binary
    assert s.tracking.cfg.refkf_max_dist == s.tracking.cfg.th_high == 100.0
    assert s.local_mapping.tri_max_dist == 50.0
    assert s.atlas.desc_dim == 256
    monkeypatch.delenv("USE_ORB")
    s = tsys.System(settings, tsys.Sensor.RGBD, enable_loop_closing=False,
                    device="cpu")
    assert s.backend == "xfeat" and not s.tracking.cfg.binary
    assert s.local_mapping.tri_max_dist == 600.0
    with pytest.raises(ValueError, match="backend"):
        tsys.System(settings, tsys.Sensor.RGBD, backend="sift", device="cpu")
    settings.imu = ImuCalib(R_bc=np.eye(3, dtype=np.float32),
                            t_bc=np.zeros(3, np.float32))
    # an ORB IMU_STEREO System: stereo frames carry depth (the RGB-D
    # tracker and schedule) and the IMU reaches tracking and local mapping
    s = tsys.System(settings, tsys.Sensor.IMU_STEREO, backend="orb",
                    device="cpu")
    assert s.backend == "orb" and s.tracking.cfg.binary
    assert s.tracking.sensor == "rgbd" and not s.local_mapping.mono
    assert s.tracking.imu_calib is s.local_mapping.imu_calib is settings.imu
    assert s.loop_closing.fix_scale and s.loop_closing.welding_iba is not None
    # an ORB IMU_RGBD System: the ORB profile, the IMU on both threads, the
    # inertial split tracking path (no two-stage step in inertial mode)
    s = tsys.System(settings, tsys.Sensor.IMU_RGBD, backend="orb",
                    enable_loop_closing=False, device="cpu")
    assert s.backend == "orb" and s.tracking.cfg.binary
    assert s.tracking.imu_calib is settings.imu
    assert s.local_mapping.imu_calib is settings.imu
    assert s.tracking._track_graph is None and s.tracking._pre_graph is None


def test_orb_extractor_defaults_to_cuda():
    """Without ``device`` the extractor runs on CUDA; on a host without a
    GPU it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert torb.ORBExtractor(nfeatures=10).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torb.ORBExtractor(nfeatures=10)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsys.System(tset.Settings(cam=tc.Pinhole.from_list(CAMP)),
                        tsys.Sensor.RGBD, backend="orb")


def test_settings_keep_the_orb_keys(tmp_path):
    cfg = tmp_path / "orb.yaml"
    cfg.write_text("\n".join([
        "%YAML:1.0", 'Camera.type: "PinHole"', "Camera1.fx: 500.0",
        "Camera1.fy: 500.0", "Camera1.cx: 320.0", "Camera1.cy: 240.0",
        "Camera.width: 640", "Camera.height: 480", "Camera.fps: 30",
        "Camera.RGB: 1", "ORBextractor.nFeatures: 1200",
        "ORBextractor.scaleFactor: 1.25", "ORBextractor.nLevels: 6",
        "ORBextractor.iniThFAST: 18", "ORBextractor.minThFAST: 5", ""]))
    t = tset.Settings.from_yaml(str(cfg))
    j = jset.Settings.from_yaml(str(cfg))
    for f in ("n_features", "scale_factor", "n_levels", "ini_th_fast",
              "min_th_fast"):
        assert getattr(t, f) == getattr(j, f), f
    assert (t.n_levels, t.scale_factor, t.ini_th_fast) == (6, 1.25, 18)


def test_example_backend_orb(tmp_path):
    out = str(tmp_path / "out")
    rc = rgbd_tum.main(["--synthetic", "4", "--size", "288x384",
                        "--device", "cpu", "--backend", "orb", "--no-loop",
                        "--out", out])
    assert rc == 0
    t, poses = tio.load_trajectory_tum(os.path.join(out,
                                                    "CameraTrajectory.txt"))
    assert len(t) == 4 and np.isfinite(poses).all()


def _full_size(n_frames):
    """tests/test_slam_integration.py's ORB run at 640x480 in both
    packages, frame by frame."""
    seq = jsyn.make_sequence(n_frames=n_frames)
    K = seq["K"]
    camp = [float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])]
    kw = dict(bf=40.0, th_depth=3.0, depth_map_factor=1.0)
    js = jsys.System(jset.Settings(cam=jc.Pinhole.from_list(camp), **kw),
                     jsys.Sensor.RGBD, backend="orb",
                     enable_loop_closing=False)
    ts = tsys.System(tset.Settings(cam=tc.Pinhole.from_list(camp), **kw),
                     tsys.Sensor.RGBD, backend="orb",
                     enable_loop_closing=False, device="cpu")
    truth = np.array([-R.T @ t for (R, t) in seq["poses"]])
    (sj, cj), (st, ct) = _run(js, seq, n_frames), _run(ts, seq, n_frames)
    ej = np.linalg.norm(cj - truth, axis=1)
    et = np.linalg.norm(ct - truth, axis=1)
    gap = np.linalg.norm(ct - cj, axis=1)
    print(f"\n{n_frames} frames at 640x480: JAX max {ej.max() * 1e3:.3f} mm "
          f"median {np.median(ej) * 1e3:.3f}, {js.map.num_keyframes()} "
          f"keyframes; port max {et.max() * 1e3:.3f} mm median "
          f"{np.median(et) * 1e3:.3f}, {ts.map.num_keyframes()} keyframes; "
          f"port-JAX gap per frame (mm) {np.round(gap * 1e3, 3).tolist()}")
    return (sj, ej, js), (st, et, ts), gap


@pytest.mark.slow
def test_fourteen_frames_at_jax_bars():
    (sj, ej, js), (st, et, ts), gap = _full_size(14)
    for states, err, system in ((sj, ej, js), (st, et, ts)):
        assert states == ["OK"] * 14
        assert err.max() < 0.01 and np.median(err) < 0.005
        assert system.map.num_keyframes() >= 1
    assert gap.max() < 0.005


@pytest.mark.slow
def test_forty_frames_at_jax_bars():
    (sj, ej, js), (st, et, ts), gap = _full_size(40)
    for states, err, system in ((sj, ej, js), (st, et, ts)):
        assert states == ["OK"] * 40
        assert err.max() < 0.03
        assert system.map.num_keyframes() >= 3
    assert gap.max() < 0.005

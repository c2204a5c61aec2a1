"""The PyTorch port's RGB-D SLAM System against the JAX System on the same
rendered frames, its example twin, and its guards.

The sequence is ``utils/synthetic.make_sequence`` at 384x288 with the TUM1
intrinsics scaled by 0.6 and 500 features (at 320x256 the first frame
holds 295 valid keypoints, below the initialization gate of 300). Both
Systems run without loop closing. Bars: identical states, keyframe counts
and steady-state frame-step counts, each camera centre within 1 mm of the
JAX System's and both within 1 cm of the truth."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager CPU ops are thousands of small tensors; with the
    test workers sharing the cores, torch's intra-op threads only contend
    (one thread runs these modules many times faster under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

from xfeatslam_tpu.ops import camera as jc  # noqa: E402
from xfeatslam_tpu.slam import settings as jset  # noqa: E402
from xfeatslam_tpu.slam import system as jsys  # noqa: E402
from xfeatslam_tpu.utils import synthetic as jsyn  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402
from xfeatslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from xfeatslam_tpu_torch.optim import track_step  # noqa: E402
from xfeatslam_tpu_torch.slam import settings as tset  # noqa: E402
from xfeatslam_tpu_torch.slam import system as tsys  # noqa: E402
from xfeatslam_tpu_torch.examples import rgbd_tum  # noqa: E402
from xfeatslam_tpu_torch.utils import io as tio  # noqa: E402

from test_torch_xfeat import NPZ  # noqa: E402

N_FRAMES, HW, SCALE, N_FEATURES = 10, (288, 384), 0.6, 500
KMAT = np.array([[517.3 * SCALE, 0, 318.6 * SCALE],
                 [0, 516.5 * SCALE, 255.3 * SCALE], [0, 0, 1]], np.float32)
CAMP = [float(KMAT[0, 0]), float(KMAT[1, 1]), float(KMAT[0, 2]),
        float(KMAT[1, 2])]
SETTINGS = dict(bf=40.0 * SCALE, th_depth=3.0, depth_map_factor=1.0,
                n_features=N_FEATURES)


def _run(system, seq):
    states, centres = [], []
    for i in range(N_FRAMES):
        state, pose = system.track_rgbd(seq["images"][i], seq["depths"][i],
                                        seq["timestamps"][i])
        states.append(state.name)
        centres.append(-pose[0].T @ pose[1])
    return states, np.array(centres)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both Systems over the same frames, each run once; their saved
    trajectories."""
    seq = jsyn.make_sequence(n_frames=N_FRAMES, hw=HW, K=KMAT)
    out = tmp_path_factory.mktemp("traj")
    js = jsys.System(jset.Settings(cam=jc.Pinhole.from_list(CAMP), **SETTINGS),
                     jsys.Sensor.RGBD, backend="xfeat",
                     enable_loop_closing=False)
    ts = tsys.System(tset.Settings(cam=tc.Pinhole.from_list(CAMP), **SETTINGS),
                     tsys.Sensor.RGBD, enable_loop_closing=False,
                     device="cpu")
    ck.reset_launch_counts()
    res = {"jax": _run(js, seq), "port": _run(ts, seq),
           "launches": ck.launch_counts(), "jax_sys": js, "port_sys": ts,
           "truth": np.array([-R.T @ t for (R, t) in seq["poses"]])}
    for name, s in (("jax", js), ("port", ts)):
        s.save_trajectory_tum(str(out / f"{name}_cam.txt"))
        s.save_keyframe_trajectory_tum(str(out / f"{name}_kf.txt"))
    res["out"] = out
    return res


def test_system_matches_jax(runs):
    (sj, cj), (st, ct) = runs["jax"], runs["port"]
    assert st == sj == ["OK"] * N_FRAMES
    js, ts = runs["jax_sys"], runs["port_sys"]
    assert ts.map.num_keyframes() == js.map.num_keyframes() >= 3
    assert ts.tracking.stats == js.tracking.stats
    assert ts.tracking.stats["fused_grab"] == N_FRAMES - 1
    np.testing.assert_allclose(ct, cj, atol=1e-3)
    truth = runs["truth"]
    assert np.linalg.norm(cj - truth, axis=1).max() < 0.01
    assert np.linalg.norm(ct - truth, axis=1).max() < 0.01
    # the map grew alike (a near-tie may move a point or two)
    assert abs(ts.map.num_points() - js.map.num_points()) <= 5
    # CPU tensors never launch a kernel
    assert set(runs["launches"].values()) == {0}


def test_saved_trajectories_match_jax(runs):
    out = runs["out"]
    for kind, n in (("cam", N_FRAMES),
                    ("kf", runs["jax_sys"].map.num_keyframes())):
        tj, pj = tio.load_trajectory_tum(str(out / f"jax_{kind}.txt"))
        tt, pt = tio.load_trajectory_tum(str(out / f"port_{kind}.txt"))
        assert pt.shape == pj.shape == (n, 7)
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_allclose(pt[:, :3], pj[:, :3], atol=1e-3)
        # quaternions (the sign is fixed by the conversion)
        np.testing.assert_allclose(pt[:, 3:], pj[:, 3:], atol=1e-3)
    # the first frame is the map's origin
    _, rows = tio.load_trajectory_tum(str(out / "port_cam.txt"))
    np.testing.assert_allclose(rows[0], [0, 0, 0, 0, 0, 0, 1], atol=1e-6)


def test_timer_spans(runs):
    s = runs["port_sys"]
    summary = s.timer.summary()
    assert summary["track"]["count"] == summary["backend"]["count"] == N_FRAMES
    assert summary["track.frame_step"]["count"] == N_FRAMES - 1
    path = runs["out"] / "timing.txt"
    s.dump_timing(str(path))
    assert "track:" in path.read_text()
    assert s.shutdown()["frames"] == N_FRAMES


def test_example_twin_writes_tum_files(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("XFEATSLAM_WEIGHTS", NPZ)
    rc = rgbd_tum.main(["--synthetic", "3", "--out", str(tmp_path),
                        "--device", "cpu", "--size", "288x384",
                        "--features", str(N_FEATURES)])
    assert rc == 0
    ts, rows = tio.load_trajectory_tum(str(tmp_path / "CameraTrajectory.txt"))
    assert rows.shape == (3, 7) and np.all(np.diff(ts) > 0)
    _, kf_rows = tio.load_trajectory_tum(
        str(tmp_path / "KeyFrameTrajectory.txt"))
    assert len(kf_rows) >= 1
    assert "ATE RMSE vs ground truth" in capsys.readouterr().out


def _settings():
    return tset.Settings(cam=tc.Pinhole.from_list(CAMP), **SETTINGS)


@pytest.mark.parametrize("kwargs,item", [
    (dict(sensor=tsys.Sensor.MONOCULAR), "12"),
    (dict(sensor=tsys.Sensor.STEREO), "14"),
    (dict(sensor=tsys.Sensor.IMU_MONOCULAR), "15"),
    (dict(sensor=tsys.Sensor.IMU_STEREO), "15"),
    (dict(sensor=tsys.Sensor.IMU_RGBD), "15"),
    (dict(backend="orb"), "13"),
    (dict(enable_loop_closing=True), "11"),
    (dict(viewer_dir="/nonexistent"), "16"),
])
def test_unported_configurations_raise(kwargs, item):
    kw = dict(enable_loop_closing=False, device="cpu")
    kw.update(kwargs)
    sensor = kw.pop("sensor", tsys.Sensor.RGBD)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        tsys.System(_settings(), sensor, **kw)


def test_unported_paths_raise(runs):
    with pytest.raises(NotImplementedError, match="item 11"):
        runs["port_sys"].tracking._relocalization(None)
    with pytest.raises(NotImplementedError, match="item 10"):
        tset.Settings.from_yaml("examples/configs/tum1_rgbd.yaml")
    with pytest.raises(NotImplementedError, match="item 14"):
        tset.Settings(camera_type="KannalaBrandt8")
    with pytest.raises(NotImplementedError, match="item 14"):
        _settings().rectify(None, None)
    with pytest.raises(NotImplementedError, match="item 15"):
        runs["port_sys"].tracking.grab_rgbd(
            np.zeros(HW, np.uint8), np.zeros(HW, np.float32), 99.0,
            imu=[(np.zeros(3), np.zeros(3), 98.9)])
    with pytest.raises(NotImplementedError, match="item 10"):
        rgbd_tum.main(["settings.yaml", "seq", "assoc.txt"])


def test_frame_step_graph_needs_cuda():
    from xfeatslam_tpu_torch.models import weights as tw

    with pytest.raises(ValueError, match="CUDA"):
        track_step.RgbdFrameStepGraph(tw.load_npz(NPZ, device="cpu"))


def test_fetch_returns_numpy_trees():
    r = track_step.TrackStepResult(*(torch.arange(3) for _ in range(7)))
    out = track_step.fetch(({"a": torch.ones(2)}, [r, torch.zeros(1)], 5))
    assert isinstance(out[0]["a"], np.ndarray)
    assert isinstance(out[1][0], track_step.TrackStepResult)
    assert isinstance(out[1][0].slot_mp, np.ndarray)
    assert out[2] == 5

"""The PyTorch port's RGB-D SLAM System against the JAX System on the same
rendered frames, its example twin, and its guards.

The sequence is ``utils/synthetic.make_sequence`` at 384x288 with the TUM1
intrinsics scaled by 0.6 and 500 features (at 320x256 the first frame
holds 295 valid keypoints, below the initialization gate of 300). Both
Systems run without loop closing. Bars: identical states, keyframe counts
and steady-state frame-step counts, each camera centre within 1 mm of the
JAX System's and both within 1 cm of the truth.

The tests after ``test_fetch_returns_numpy_trees`` drive the module's two
Systems further (relocalization, localization mode, a dataset change), in
file order; the ones before them read the Systems as the 10 frames left
them."""

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
from xfeatslam_tpu.ops import imu as jimu  # noqa: E402
from xfeatslam_tpu.slam import serialization as jser  # noqa: E402
from xfeatslam_tpu.slam import settings as jset  # noqa: E402
from xfeatslam_tpu.slam import system as jsys  # noqa: E402
from xfeatslam_tpu.utils import synthetic as jsyn  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402
from xfeatslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from xfeatslam_tpu_torch.ops import imu as timu  # noqa: E402
from xfeatslam_tpu_torch.ops.imu import ImuCalib  # noqa: E402
from xfeatslam_tpu_torch.optim import track_step  # noqa: E402
from xfeatslam_tpu_torch.slam import map as tmap  # noqa: E402
from xfeatslam_tpu_torch.slam import serialization as tser  # noqa: E402
from xfeatslam_tpu_torch.slam import settings as tset  # noqa: E402
from xfeatslam_tpu_torch.slam import system as tsys  # noqa: E402
from xfeatslam_tpu_torch.examples import mono_tum_vi  # noqa: E402
from xfeatslam_tpu_torch.examples import rgbd_tum  # noqa: E402
from xfeatslam_tpu_torch.utils import io as tio  # noqa: E402
from xfeatslam_tpu_torch.utils import synthetic as tsyn  # noqa: E402

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
           "seq": seq,
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
    (dict(viewer_port=0), "16"),
])
def test_unported_configurations_raise(kwargs, item):
    """Item 16's viewer is ported (tests/test_torch_viewer.py); what still
    raises is the configuration the JAX System refuses too: a control
    panel without a viewer directory."""
    kw = dict(enable_loop_closing=False, device="cpu")
    kw.update(kwargs)
    sensor = kw.pop("sensor", tsys.Sensor.RGBD)
    with pytest.raises(ValueError, match="viewer_port requires viewer_dir"):
        tsys.System(_settings(), sensor, **kw)
    with pytest.raises(ValueError, match="viewer_port requires viewer_dir"):
        jsys.System(jset.Settings(cam=jc.Pinhole.from_list(CAMP), **SETTINGS),
                    jsys.Sensor.RGBD, enable_loop_closing=False, backend="orb",
                    **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(sensor="MONOCULAR", imu_samples=True),
    dict(sensor="STEREO", imu_samples=True),
    dict(sensor="IMU_MONOCULAR"),
    dict(sensor="IMU_STEREO"),
    dict(backend="orb", sensor="STEREO", imu_samples=True),
], ids=["mono_samples", "stereo_samples", "imu_mono", "imu_stereo",
        "orb_stereo_samples"])
def test_inertial_configurations_as_jax(kwargs):
    """Each sensor and backend builds and takes a first (blank) frame with
    IMU samples as the JAX package's System does: the tracker kind, the
    local-mapping schedule (a monocular inertial map waits for 2 s and 10
    keyframes) and the welding-BA hook with an IMU; a sensor without an
    IMU queues the samples and never reads them, an inertial one drops the
    samples up to its first frame and keeps the later ones."""
    kw = dict(kwargs)
    sensor = kw.pop("sensor")
    imu_samples = kw.pop("imu_samples", False)
    backend = kw.pop("backend", "xfeat")
    settings = _settings()
    jsettings = jset.Settings(cam=jc.Pinhole.from_list(CAMP), **SETTINGS)
    settings.imu = ImuCalib(R_bc=np.eye(3, dtype=np.float32),
                            t_bc=np.zeros(3, np.float32))
    jsettings.imu = jimu.ImuCalib(R_bc=np.eye(3, dtype=np.float32),
                                  t_bc=np.zeros(3, np.float32))
    samples = [(np.zeros(3), np.zeros(3), 0.0),
               (np.zeros(3), np.zeros(3), 0.05)]
    img = np.zeros(HW, np.uint8)
    out = {}
    for mod, s, extra in ((tsys, settings, dict(device="cpu")),
                          (jsys, jsettings, {})):
        system = mod.System(s, mod.Sensor[sensor], backend=backend, **extra)
        if "STEREO" in sensor:
            state, pose = system.track_stereo(img, img, 0.0, imu=samples)
        else:
            state, pose = system.track_monocular(img, 0.0, imu=samples)
        lm = system.local_mapping
        out[mod] = dict(
            state=state.name, pose=pose, sensor=system.tracking.sensor,
            calib=system.tracking.imu_calib is not None,
            queue=[q[0] for q in system.tracking.imu_queue],
            schedule=(lm.mono, lm.imu_init_time, lm.imu_min_kfs),
            hook=system.loop_closing.welding_iba is not None,
            fix_scale=system.loop_closing.fix_scale)
    assert out[tsys] == out[jsys]
    inertial = sensor.startswith("IMU")
    assert out[tsys]["calib"] == out[tsys]["hook"] == inertial
    assert out[tsys]["queue"] == ([0.05] if inertial else [0.0, 0.05])


def test_imu_rgbd_system_wired_as_jax():
    """System(IMU_RGBD) builds as the JAX package's: the IMU calibration is
    required, tracking and local mapping get it with the settings' IMU
    schedule, loop closing fixes the scale; both packages raise the same
    error without an IMU section."""
    settings = _settings()
    jsettings = jset.Settings(cam=jc.Pinhole.from_list(CAMP), **SETTINGS)
    for s, sys_mod in ((settings, tsys), (jsettings, jsys)):
        kw = dict(device="cpu") if sys_mod is tsys else {}
        with pytest.raises(ValueError, match="requires an IMU section"):
            sys_mod.System(s, sys_mod.Sensor.IMU_RGBD, **kw)
    settings.imu = ImuCalib(R_bc=np.eye(3, dtype=np.float32),
                            t_bc=np.zeros(3, np.float32))
    jsettings.imu = jimu.ImuCalib(R_bc=np.eye(3, dtype=np.float32),
                                  t_bc=np.zeros(3, np.float32))
    for s in (settings, jsettings):
        s.imu_init_time, s.viba1_time, s.viba2_time = 1.0, 2.0, 2.5
    ts = tsys.System(settings, tsys.Sensor.IMU_RGBD, device="cpu")
    js = jsys.System(jsettings, jsys.Sensor.IMU_RGBD)
    assert ts.imu_calib is settings.imu
    assert ts.tracking.imu_calib is settings.imu
    assert ts.tracking.sensor == js.tracking.sensor == "rgbd"
    for name in ("imu_init_time", "viba1_time", "viba2_time", "imu_min_kfs",
                 "mono"):
        assert (getattr(ts.local_mapping, name)
                == getattr(js.local_mapping, name)), name
    assert ts.local_mapping.imu_calib is settings.imu
    assert ts.loop_closing.fix_scale == js.loop_closing.fix_scale is True
    assert (ts.tracking.cfg.insert_kfs_when_lost
            == js.tracking.cfg.insert_kfs_when_lost)
    assert not ts.is_lost() and ts.get_time_from_imu_init() == 0.0


def test_unported_paths_raise(runs, tmp_path):
    ts = runs["port_sys"]
    # a keyframe's inertial preintegration goes into the atlas files and
    # comes back equal, in the JAX package's loader too
    m = tmap.SlamMap()
    rng = np.random.default_rng(1)
    pre = timu.Preintegrated(*(rng.standard_normal(shape).astype(np.float32)
                               for shape in tser._PRE_SHAPES))
    m.add_keyframe(tmap.KeyFrame(
        kid=0, frame_id=0, timestamp=0.0,
        kpts_un=np.zeros((4, 2), np.float32),
        desc=np.zeros((4, 64), np.float32), valid=np.ones(4, bool),
        ur=np.full(4, -1.0, np.float32), depth=np.zeros(4, np.float32),
        R=np.eye(3, dtype=np.float32), t=np.zeros(3, np.float32),
        pre_kf=pre, prev_kf=-1))
    tser.save_map(m, str(tmp_path / "m.npz"))
    for loaded in (tser.load_map(str(tmp_path / "m.npz")),
                   jser.load_map(str(tmp_path / "m.npz"))):
        for a, b in zip(loaded.keyframes[0].pre_kf, pre):
            np.testing.assert_array_equal(a, b)
    # the map export (item 16) is ported: a standalone page, data inline
    html = open(ts.export_map_html(str(tmp_path / "map.html"))).read()
    assert "__EMBEDDED__" not in html and '"n_kf": ' in html
    # the readers and the fisheye settings are ported (tracking through a
    # fisheye camera: tests/test_torch_slam_fisheye.py)
    fisheye = tset.Settings.from_yaml("examples/configs/tum_vi_mono.yaml")
    assert fisheye.camera_type == "KannalaBrandt8"
    assert tset.Settings(camera_type="KannalaBrandt8").cam is None
    img = np.zeros(HW, np.uint8)
    assert _settings().rectify(img, img)[0] is img
    # IMU samples given to an RGB-D tracker without an IMU are queued and
    # never read, as the JAX package's tracker does
    samples = [(np.ones(3), np.zeros(3), 98.9), (np.zeros(3), np.ones(3),
                                                  99.0)]
    tq = runs["port_sys"].tracking
    jq = runs["jax_sys"].tracking
    for tr in (tq, jq):
        n = len(tr.imu_queue)
        tr._queue_imu(samples)
        got = tr.imu_queue[n:]
        del tr.imu_queue[n:]
        assert [s[0] for s in got] == [98.9, 99.0]
        assert all(s[1].dtype == np.float32 for s in got)
    assert tq.imu_calib is None and jq.imu_calib is None
    with pytest.raises(FileNotFoundError):
        mono_tum_vi.main(["examples/configs/tum_vi_mono.yaml", "seq"])


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


def test_getters_match_jax(runs):
    js, ts = runs["jax_sys"], runs["port_sys"]
    mj, mt = js.get_tracked_map_points(), ts.get_tracked_map_points()
    assert mt.shape == mj.shape and mt.dtype == mj.dtype
    assert abs(int((mt >= 0).sum()) - int((mj >= 0).sum())) <= 5
    kj, kt = js.get_tracked_keypoints_un(), ts.get_tracked_keypoints_un()
    assert kt.shape == kj.shape
    np.testing.assert_array_equal(kt, ts.tracking.last_frame.kpts)
    for s in (js, ts):
        assert s.get_image_scale() == 1.0
        assert s.is_lost() is False
        assert s.get_time_from_imu_init() == 0.0
        # True once per change of the maps' counters, then False
        assert s.map_changed() is True
        assert s.map_changed() is False
    js.shutdown()
    assert ts.is_shutdown() is js.is_shutdown() is True


def test_euroc_and_kitti_files_match_jax(runs, tmp_path, monkeypatch):
    js, ts = runs["jax_sys"], runs["port_sys"]
    savers = (("cam.csv", "save_trajectory_euroc"),
              ("kf.csv", "save_keyframe_trajectory_euroc"),
              ("cam.kitti", "save_trajectory_kitti"))

    def save(system, tag):
        for name, fn in savers:
            getattr(system, fn)(str(tmp_path / f"{tag}_{name}"))

    save(js, "jax")
    save(ts, "port")
    for name, _ in savers:
        a = np.loadtxt(tmp_path / f"jax_{name}",
                       delimiter="," if name.endswith("csv") else None)
        b = np.loadtxt(tmp_path / f"port_{name}",
                       delimiter="," if name.endswith("csv") else None)
        assert a.shape == b.shape
        if name.endswith("csv"):
            np.testing.assert_array_equal(b[:, 0], a[:, 0])  # t in ns
            a, b = a[:, 1:], b[:, 1:]
        np.testing.assert_allclose(b, a, atol=1e-3)
    # the same poses make the same bytes
    monkeypatch.setattr(ts.tracking, "resolved_trajectory",
                        js.tracking.resolved_trajectory)
    monkeypatch.setattr(ts, "_kfs_for_save", js._kfs_for_save)
    save(ts, "same")
    for name, _ in savers:
        assert ((tmp_path / f"same_{name}").read_bytes()
                == (tmp_path / f"jax_{name}").read_bytes())


def _truth_err(pose, seq, i):
    Rg, tg = seq["poses"][i]
    return float(np.linalg.norm(-pose[0].T @ pose[1] + Rg.T @ tg))


def _relocalize_both(runs, seq, i, t, state_name):
    """Both Systems in ``state_name`` take frame ``i`` at time ``t``."""
    out = []
    for s, states in ((runs["jax_sys"], jsys.State),
                      (runs["port_sys"], tsys.State)):
        s.tracking.state = states[state_name]
        s.tracking.lost_since = t - 0.1
        state, pose = s.track_rgbd(seq["images"][i], seq["depths"][i], t)
        out.append((state.name, pose))
    return out


def test_relocalization_from_lost(runs):
    seq10 = runs["seq"]
    (sj, pj), (st, pt) = _relocalize_both(runs, seq10, 4, 20.0, "LOST")
    assert st == sj == "OK"
    assert _truth_err(pj, seq10, 4) < 0.01 and _truth_err(pt, seq10, 4) < 0.01
    np.testing.assert_allclose(-pt[0].T @ pt[1], -pj[0].T @ pj[1], atol=2e-3)


def test_relocalization_from_recently_lost(runs, monkeypatch):
    """RECENTLY_LOST with the motion model and the reference keyframe both
    failing: the frame relocalizes (it used to raise)."""
    seq10 = runs["seq"]
    for s in (runs["jax_sys"], runs["port_sys"]):
        monkeypatch.setattr(s.tracking, "_track_with_motion_model",
                            lambda frame: False)
        monkeypatch.setattr(s.tracking, "_track_reference_keyframe",
                            lambda frame: False)
    before = [s.tracking.stats.get("reloc_ok", 0)
              for s in (runs["jax_sys"], runs["port_sys"])]
    (sj, pj), (st, pt) = _relocalize_both(runs, seq10, 7, 21.0,
                                          "RECENTLY_LOST")
    assert st == sj == "OK"
    assert _truth_err(pj, seq10, 7) < 0.01 and _truth_err(pt, seq10, 7) < 0.01
    np.testing.assert_allclose(-pt[0].T @ pt[1], -pj[0].T @ pj[1], atol=2e-3)
    after = [s.tracking.stats.get("reloc_ok", 0)
             for s in (runs["jax_sys"], runs["port_sys"])]
    assert after == [b + 1 for b in before]


def test_localization_mode_pauses_mapping(runs):
    """TestLocalizationMode.test_mapping_paused at 384x288, both
    Systems."""
    seq10 = runs["seq"]
    for s in (runs["jax_sys"], runs["port_sys"]):
        s.activate_localization_mode()
        kfs, mps = s.map.num_keyframes(), s.map.num_points()
        for i in range(4):
            s.track_rgbd(seq10["images"][i], seq10["depths"][i],
                         100.0 + i / 30.0)
        assert s.map.num_points() == mps and s.map.num_keyframes() == kfs
        s.deactivate_localization_mode()
        assert s.tracking.only_tracking is False


def test_localization_mode_blocks_forced_keyframes(runs, monkeypatch):
    """TestLocalizationMode.test_blocks_kf_insertion_when_policy_fires:
    with the keyframe policy forced, localization mode inserts nothing;
    with it off again the same policy inserts."""
    seq10 = runs["seq"]
    res = []
    for s in (runs["jax_sys"], runs["port_sys"]):
        monkeypatch.setattr(s.tracking, "_need_new_keyframe",
                            lambda frame: True)
        s.activate_localization_mode()
        kfs, mps = s.map.num_keyframes(), s.map.num_points()
        made = s.tracking.stats["kfs"]
        states = []
        for i in range(3):
            state, _ = s.track_rgbd(seq10["images"][i], seq10["depths"][i],
                                    200.0 + i / 30.0)
            states.append(state.name)
        assert states[-1] == "OK"
        assert s.map.num_keyframes() == kfs and s.map.num_points() == mps
        assert s.tracking.stats["kfs"] == made
        s.deactivate_localization_mode()
        for i in range(3, 5):
            s.track_rgbd(seq10["images"][i], seq10["depths"][i],
                         200.0 + i / 30.0)
        # created (local mapping may cull such a redundant keyframe)
        assert s.tracking.stats["kfs"] > made
        res.append(states)
    assert res[0] == res[1]


def test_localization_mode_vo_fallback_off_map(runs):
    """TestLocalizationMode.test_vo_fallback_off_map on the port at 384x288:
    from frame 9's pose the camera yaws 4.5 degrees a frame toward the
    side wall until the mapped region is out of view. Tracking must ride
    on the last frame's depth points (``vo_mode``), never go LOST, stay
    within 15 cm of the start and leave the map untouched."""
    seq10 = runs["seq"]
    s = runs["port_sys"]
    scene = tsyn.RoomScene(seed=0)
    R9, t9 = seq10["poses"][N_FRAMES - 1]
    C9 = -R9.T @ t9
    s.track_rgbd(seq10["images"][N_FRAMES - 1],
                 seq10["depths"][N_FRAMES - 1], 300.0)
    s.activate_localization_mode()
    kfs, mps = s.map.num_keyframes(), s.map.num_points()
    vo_seen, states = False, []
    for j in range(1, 17):
        yaw = np.deg2rad(4.5 * j)
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_wc = R9.T @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]],
                               np.float32)
        R_cw = R_wc.T.astype(np.float32)
        img, dep = scene.render(KMAT, R_cw, (-R_cw @ C9).astype(np.float32),
                                HW)
        state, pose = s.track_rgbd(img, dep, 300.0 + j / 30.0)
        states.append(state.name)
        vo_seen = vo_seen or s.tracking.vo_mode
        if pose is not None:
            assert np.linalg.norm(-pose[0].T @ pose[1] - C9) < 0.15, j
    assert "LOST" not in states and states[-1] == "OK", states
    assert vo_seen
    assert s.map.num_keyframes() == kfs and s.map.num_points() == mps
    s.deactivate_localization_mode()
    assert s.tracking.vo_mode is False


def test_change_dataset_matches_jax(runs, monkeypatch):
    """TestChangeDataset at 384x288 on both Systems: a map of fewer than
    12 keyframes is discarded, tracking re-initializes in a fresh map, and
    a grown map is frozen in the atlas."""
    seq10 = runs["seq"]
    for s in (runs["jax_sys"], runs["port_sys"]):
        old = s.map.map_id
        assert s.map.num_keyframes() < 12
        s.change_dataset()
        assert old not in s.atlas.maps
        assert s.tracking.state.name == "NOT_INITIALIZED"
        assert s.map is s.atlas.active and s.local_mapping.map is s.map
        state, _ = s.track_rgbd(seq10["images"][0], seq10["depths"][0],
                                400.0)
        assert state.name == "OK" and s.map.num_keyframes() >= 1
        grown = s.map.map_id
        monkeypatch.setattr(s.map, "num_keyframes", lambda: 20)
        s.change_dataset()
        assert grown in s.atlas.maps and s.map.map_id != grown
    assert (sorted(runs["jax_sys"].atlas.maps)
            == sorted(runs["port_sys"].atlas.maps))


def _trace_40(system, seq):
    """States, camera-centre errors, keyframe counts and the valid
    keypoints (rounded to 0.01 px) per frame."""
    states, centres, kfs, kpts = [], [], [], []
    for i in range(len(seq["images"])):
        state, pose = system.track_rgbd(seq["images"][i], seq["depths"][i],
                                        seq["timestamps"][i])
        states.append(state.name)
        centres.append(-pose[0].T @ pose[1])
        kfs.append(system.map.num_keyframes())
        f = system.tracking.last_frame
        kpts.append({tuple(p) for p in np.round(f.kpts[f.valid], 2)})
    truth = np.array([-R.T @ t for (R, t) in seq["poses"]])
    return states, np.array(centres), np.linalg.norm(
        np.array(centres) - truth, axis=1), kfs, kpts


def _nms_windows(js, ts, gray, pixels):
    """Each package's full-resolution heatmap in the 5x5 NMS window of
    each pixel (x, y): the centre value and the largest other value."""
    from xfeatslam_tpu.models import xfeat as jxf
    from xfeatslam_tpu.ops import detect as jd
    from xfeatslam_tpu.ops import image as jimg
    from xfeatslam_tpu_torch.ops import detect as td
    from xfeatslam_tpu_torch.ops import image as timg

    _, lj, _ = jxf.forward(js.extractor.params, jimg.to_float_image(gray))
    with torch.no_grad():
        _, lt, _ = ts.extractor.model(timg.to_float_image(gray, "cpu"))
    maps = {"JAX": np.asarray(jd.keypoint_heatmap(lj))[0, ..., 0],
            "port": td.keypoint_heatmap(lt).numpy()[0, ..., 0]}
    out = []
    for x, y in pixels:
        for name, p in maps.items():
            w = p[y - 2:y + 3, x - 2:x + 3].copy()
            c = float(w[2, 2])
            w[2, 2] = -np.inf
            out.append(f"{name} ({x},{y}): centre {c:.9f}, largest other "
                       f"{float(w.max()):.9f}")
    return out


@pytest.mark.slow
def test_forty_frames_at_640x480_against_jax():
    """Both Systems on the JAX package's 40-frame sequence at 640x480,
    K=1000 (test_slam_integration.py's configuration), frame by frame:
    states, camera-centre errors and keyframe counts, the first frame
    whose two camera centres differ by more than 1 mm, and the first frame
    whose keypoints differ, with each package's heatmap in the 5x5 NMS
    window of the keypoints one of them lacks. Then relocalizes every
    frame against each System's final map, and the port's first 8 frames
    under 10 RANSAC seeds. Prints the tables; holds both to the 40-frame
    bars (every frame OK, < 3 cm max, < 1 cm median) and frame 0 (the
    origin keyframe's view) to relocalizing within 1 cm in both. Run it
    with ``pytest -m slow -s -k forty``."""
    seq = jsyn.make_sequence(n_frames=40)
    Km = seq["K"]
    camp = [float(Km[0, 0]), float(Km[1, 1]), float(Km[0, 2]),
            float(Km[1, 2])]
    kw = dict(bf=40.0, th_depth=3.0, depth_map_factor=1.0)
    js = jsys.System(jset.Settings(cam=jc.Pinhole.from_list(camp), **kw),
                     jsys.Sensor.RGBD, backend="xfeat",
                     enable_loop_closing=False)
    ts = tsys.System(tset.Settings(cam=tc.Pinhole.from_list(camp), **kw),
                     tsys.Sensor.RGBD, enable_loop_closing=False,
                     device="cpu")
    sj, cj, ej, kj, pj = _trace_40(js, seq)
    st, ct, et, kt, pt = _trace_40(ts, seq)
    gap = np.linalg.norm(ct - cj, axis=1)
    print("\nframe | JAX state, err mm, KFs | port state, err mm, KFs | "
          "centre gap mm")
    for i in range(len(sj)):
        print(f"{i:2d} | {sj[i]} {ej[i] * 1e3:.3f} {kj[i]} | {st[i]} "
              f"{et[i] * 1e3:.3f} {kt[i]} | {gap[i] * 1e3:.3f}")
    first = np.nonzero(gap > 1e-3)[0]
    print(f"JAX max {ej.max() * 1e3:.3f} mm median {np.median(ej) * 1e3:.3f}"
          f" mm, {js.map.num_keyframes()} KFs, {js.map.num_points()} points;"
          f" port max {et.max() * 1e3:.3f} mm median "
          f"{np.median(et) * 1e3:.3f} mm, {ts.map.num_keyframes()} KFs, "
          f"{ts.map.num_points()} points; first frame > 1 mm apart: "
          f"{int(first[0]) if len(first) else None}; stats JAX "
          f"{js.tracking.stats} port {ts.tracking.stats}")
    differ = [i for i in range(len(pj)) if pj[i] != pt[i]]
    if differ:
        i = differ[0]
        only_j, only_t = sorted(pj[i] - pt[i]), sorted(pt[i] - pj[i])
        print(f"first frame whose keypoints differ: {i}, only JAX {only_j},"
              f" only port {only_t}; 5x5 NMS windows:")
        pixels = [(int(round(x)), int(round(y))) for x, y in only_j + only_t]
        for line in _nms_windows(js, ts, seq["images"][i], pixels):
            print("  " + line)
    for states, errs in ((sj, ej), (st, et)):
        assert states == ["OK"] * len(states)
        assert errs.max() < 0.03 and np.median(errs) < 0.01
    # relocalization against each System's final map: every frame rebuilt
    # and relocalized (the JAX draws come from PRNGKey(frame id), the
    # port's from a generator seeded by it), then the port's first frames
    # under 10 seeds
    truth = [-R.T @ t for (R, t) in seq["poses"]]

    def reloc(system, i, fid=None):
        f = system.tracking.pipeline.build_rgbd(seq["images"][i],
                                                seq["depths"][i], 50.0)
        if fid is not None:
            f.fid = fid
        if not system.tracking._relocalization(f):
            return None
        return round(float(np.linalg.norm(-f.R.T @ f.t - truth[i])) * 1e3, 3)

    found = {}
    for name, system in (("JAX", js), ("port", ts)):
        found[name] = {i: e for i in range(len(seq["images"]))
                       if (e := reloc(system, i)) is not None}
        print(f"relocalization scan, {name}: {len(found[name])} of "
              f"{len(seq['images'])} frames relocalized, camera-centre "
              f"error mm by frame: {found[name]}")
    for i in range(8):
        errs = [reloc(ts, i, fid) for fid in range(100, 110)]
        ok = [e for e in errs if e is not None]
        print(f"port, frame {i} under 10 seeds: {len(ok)} relocalized, "
              f"{sum(e < 10 for e in ok)} within 1 cm, errors mm {ok}")
    assert found["JAX"][0] < 10 and found["port"][0] < 10


SCAN_TRACKED = 10


def _port_map_from(jmap, pmap):
    """Make the port's map ``pmap`` a copy of the JAX map ``jmap`` in place
    (the two map modules are the same numpy code), so that the trackers
    holding ``pmap`` see the JAX map."""
    import copy
    import dataclasses

    from xfeatslam_tpu_torch.slam import map as tmap

    d = {k: copy.deepcopy(v) for k, v in vars(jmap).items()
         if k != "on_kf_removed"}
    d["keyframes"] = {
        kid: tmap.KeyFrame(**{f.name: copy.deepcopy(getattr(kf, f.name))
                              for f in dataclasses.fields(tmap.KeyFrame)})
        for kid, kf in jmap.keyframes.items()}
    points = tmap.MapPointStore.__new__(tmap.MapPointStore)
    vars(points).update(copy.deepcopy(vars(jmap.points)))
    d["points"] = points
    vars(pmap).update(d)


@pytest.mark.slow
def test_relocalization_scan_on_jax_draws(monkeypatch):
    """The port's ``_relocalization`` against the JAX package's on the same
    inputs, frame by frame: the JAX System tracks the first SCAN_TRACKED
    frames of the 640x480 sequence, the port's tracker gets a copy of that
    map, and every one of the 40 frames is built by the JAX pipeline and
    relocalized by both trackers under the same frame id, the port fed the
    JAX draws (``PRNGKey(frame id)``, as ``xfeatslam_tpu/optim/pnp.py``
    draws them). Only the code differs, so the same frames must succeed,
    with the same camera centre. Run it with ``pytest -m slow -s -k
    jax_draws``."""
    import copy
    import dataclasses

    import jax

    from test_torch_pnp import jax_draws
    from xfeatslam_tpu_torch.optim import pnp as tpnp
    from xfeatslam_tpu_torch.slam import frame as tframe

    monkeypatch.setattr(tpnp, "draw_minimal_sets", lambda valid, iters,
                        generator: torch.from_numpy(jax_draws(
                            jax.random.PRNGKey(generator.initial_seed()),
                            valid.numpy())).reshape(iters, 6))
    seq = jsyn.make_sequence(n_frames=40)
    Km = seq["K"]
    camp = [float(Km[0, 0]), float(Km[1, 1]), float(Km[0, 2]),
            float(Km[1, 2])]
    kw = dict(bf=40.0, th_depth=3.0, depth_map_factor=1.0)
    js = jsys.System(jset.Settings(cam=jc.Pinhole.from_list(camp), **kw),
                     jsys.Sensor.RGBD, backend="xfeat",
                     enable_loop_closing=False)
    ts = tsys.System(tset.Settings(cam=tc.Pinhole.from_list(camp), **kw),
                     tsys.Sensor.RGBD, enable_loop_closing=False,
                     device="cpu")
    for i in range(SCAN_TRACKED):
        state, _ = js.track_rgbd(seq["images"][i], seq["depths"][i],
                                 seq["timestamps"][i])
        assert state.name == "OK"
    _port_map_from(js.map, ts.map)
    assert ts.tracking.map is ts.map and ts.atlas.active is ts.map
    truth = [-R.T @ t for (R, t) in seq["poses"]]
    print(f"\nthe JAX map after {SCAN_TRACKED} frames: "
          f"{js.map.num_keyframes()} KFs, {js.map.num_points()} points")
    print("frame | JAX err mm | port err mm | gap mm | bound map points")
    ok_j, ok_t, gaps = [], [], []
    for i in range(len(seq["images"])):
        fj = js.tracking.pipeline.build_rgbd(seq["images"][i],
                                             seq["depths"][i], 50.0)
        fj.fid = 1000 + i
        ft = tframe.Frame(**{f.name: copy.deepcopy(getattr(fj, f.name))
                             for f in dataclasses.fields(tframe.Frame)})
        ok_j.append(js.tracking._relocalization(fj))
        ok_t.append(ts.tracking._relocalization(ft))
        cj, ct = (-f.R.T @ f.t if ok else None
                  for f, ok in ((fj, ok_j[-1]), (ft, ok_t[-1])))
        ej, et = (None if c is None else
                  round(float(np.linalg.norm(c - truth[i])) * 1e3, 3)
                  for c in (cj, ct))
        gaps.append(None if cj is None or ct is None else
                    float(np.linalg.norm(ct - cj)) * 1e3)
        bound = (None if not ok_j[-1] else
                 (int((fj.mp_ids >= 0).sum()), int((ft.mp_ids >= 0).sum())))
        print(f"{i:2d} | {ej} | {et} | {gaps[-1]} | {bound}")
    print(f"relocalized: JAX {sum(ok_j)}, port {sum(ok_t)} of {len(ok_j)}")
    assert ok_t == ok_j and sum(ok_j) >= 5
    assert max(g for g in gaps if g is not None) < 0.1

"""The PyTorch port's monocular System, and the example twins' dataset
modes, on the CPU.

The monocular System runs the frames of the JAX package's
test_xfeat_mono_tracks_single_dispatch (loop closing off, 18 frames) at
the size of ``test_torch_slam_system.py`` (384x288, the TUM1 intrinsics
scaled by 0.6, 500 features) and is held to its bars; its RANSAC draws
are its own (a generator seeded by the frame id), so its initialization
frame may differ from JAX's. The initial global BA's problem is solved
again by the JAX package's bundle_adjust and compared.

The dataset modes of ``examples/rgbd_tum`` and ``examples/mono_tum`` read
a TUM directory that ``tools/render_tum_dataset.py`` writes with cv2."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager CPU ops are thousands of small tensors; with the
    test workers sharing the cores, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.ops import camera as jc  # noqa: E402
from xfeatslam_tpu.optim import local_ba as jba  # noqa: E402
from xfeatslam_tpu_torch.examples import mono_tum, rgbd_tum  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402
from xfeatslam_tpu_torch.optim import local_ba as tba  # noqa: E402
from xfeatslam_tpu_torch.slam import settings as tset  # noqa: E402
from xfeatslam_tpu_torch.slam import system as tsys  # noqa: E402
from xfeatslam_tpu_torch.utils import io as tio  # noqa: E402
from xfeatslam_tpu_torch.utils import synthetic as tsyn  # noqa: E402

from test_torch_slam_system import CAMP, HW, KMAT, N_FEATURES  # noqa: E402
from test_torch_xfeat import NPZ  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    """``tools/render_tum_dataset.py``'s TUM directory (4 frames at
    640x480, PNGs written by cv2, its settings.yaml and ground truth) with
    ``tools/tum_associate.py``'s association file."""
    pytest.importorskip("cv2")
    import render_tum_dataset
    import tum_associate

    root = str(tmp_path_factory.mktemp("tum"))
    render_tum_dataset.render_tum_dataset(root, n_frames=4)
    tum_associate.main([root])
    return root


def test_example_twin_dataset_mode(tum_dir, tmp_path, monkeypatch):
    """``rgbd_tum``'s dataset mode on the rendered TUM directory: every
    frame's pose written, within 1 cm of the ground truth."""
    monkeypatch.setenv("XFEATSLAM_WEIGHTS", NPZ)
    rc = rgbd_tum.main([os.path.join(tum_dir, "settings.yaml"), tum_dir,
                        os.path.join(tum_dir, "association.txt"),
                        "--out", str(tmp_path), "--device", "cpu",
                        "--no-loop"])
    assert rc == 0
    ts, rows = tio.load_trajectory_tum(str(tmp_path / "CameraTrajectory.txt"))
    gt_t, gt = tio.load_trajectory_tum(os.path.join(tum_dir,
                                                    "groundtruth.txt"))
    assert rows.shape == (4, 7)
    assert tio.ate_rmse(gt_t, gt[:, :3], ts, rows[:, :3]) < 0.01


def test_mono_example_twin_dataset_mode(tum_dir, tmp_path, monkeypatch):
    """The ``mono_tum`` twin reads the TUM directory's rgb.txt and PNGs and
    writes its keyframe trajectory (4 frames may not initialize a
    monocular map; the file is written either way)."""
    monkeypatch.setenv("XFEATSLAM_WEIGHTS", NPZ)
    rc = mono_tum.main([os.path.join(tum_dir, "settings.yaml"), tum_dir,
                        "--out", str(tmp_path), "--device", "cpu",
                        "--no-loop"])
    assert rc == 0
    assert (tmp_path / "KeyFrameTrajectory.txt").exists()


MONO_FRAMES = 18


@pytest.fixture(scope="module")
def mono_run():
    """The port's monocular System over MONO_FRAMES rendered frames, with
    the initial global BA's problem and solve recorded."""
    seq = tsyn.make_sequence(n_frames=MONO_FRAMES, hw=HW, K=KMAT)
    system = tsys.System(
        tset.Settings(cam=tc.Pinhole.from_list(CAMP), fps=30.0,
                      n_features=N_FEATURES),
        tsys.Sensor.MONOCULAR, enable_loop_closing=False, device="cpu")
    gbas = []
    solve = tba.bundle_adjust

    def recording(prob, cam, bf=0.0, stage_iters=(5, 10), **kw):
        res = solve(prob, cam, bf, stage_iters=stage_iters, **kw)
        if tuple(stage_iters) == (10, 10) and prob.R.shape[0] == 4:
            gbas.append((prob, res))
        return res

    mp = pytest.MonkeyPatch()
    mp.setattr(tba, "bundle_adjust", recording)
    try:
        states = [system.track_monocular(seq["images"][i],
                                         seq["timestamps"][i])[0].name
                  for i in range(MONO_FRAMES)]
    finally:
        mp.undo()
    return {"system": system, "states": states, "gbas": gbas, "seq": seq}


def test_mono_tracks_at_jax_bars(mono_run):
    """test_xfeat_mono_tracks_single_dispatch's bars: the last state OK, at
    least 12 OK, at least 2 keyframes, the frame step used."""
    states, system = mono_run["states"], mono_run["system"]
    assert states[-1] == "OK", states
    assert states.count("OK") >= 12, states
    assert system.map.num_keyframes() >= 2
    assert system.tracking.stats.get("fused_grab", 0) >= 8
    # one initialization, one initial GBA
    assert len(mono_run["gbas"]) == 1


def test_mono_initial_gba_matches_jax(mono_run):
    """The initial GBA's problem (4 cameras, 2 of them padding; 1024
    points; 2048 mono observations) through the JAX package's
    bundle_adjust at (10, 10): poses within 1e-4, the same inliers, and
    each point two inliers determine within 2e-3 of its distance from the
    first camera. Two cameras fix each depth by one short baseline, so a
    depth's uncertainty grows with its square; float32 rounding over 20 LM
    iterations of 40 CG steps moves the far ones by ~1e-3 relative (CPU:
    at most 1.6e-3, 4.8e-3 m at 3 m)."""
    prob, res = mono_run["gbas"][0]
    rj = jba.bundle_adjust(
        jba.BAProblem(**{k: jnp.asarray(v.numpy())
                         for k, v in prob._asdict().items() if k != "plan"}),
        jc.Pinhole.from_list(CAMP), jnp.float32(0.0), stage_iters=(10, 10))
    rj = {k: np.asarray(v) for k, v in rj._asdict().items()}
    rt = {k: v.numpy() for k, v in res._asdict().items()}
    np.testing.assert_allclose(rt["R"], rj["R"], atol=1e-4)
    np.testing.assert_allclose(rt["t"], rj["t"], atol=1e-4)
    np.testing.assert_array_equal(rt["inlier"], rj["inlier"])
    obs_pt = prob.obs_pt.numpy()
    constrained = np.bincount(obs_pt[rj["inlier"]],
                              minlength=len(rj["X"])) >= 2
    assert constrained.sum() > 50
    dX = np.linalg.norm(rt["X"] - rj["X"], axis=1)[constrained]
    assert (dX <= 2e-3 * np.linalg.norm(rj["X"][constrained], axis=1)).all()

"""The port's stereo and fisheye frames and its stereo SLAM
(``FramePipeline.build_stereo`` / ``build_stereo_fisheye``,
``track_step.xfeat_stereo_frame_step``, ``System(Sensor.STEREO)``) against
the JAX package's on the same rendered images.

The rig is the one of ``tests/test_slam_integration.py::TestStereoSlam``:
``utils/synthetic.make_sequence`` (here at 384x288, the TUM1 intrinsics
scaled by 0.6) with the right view rendered 8 cm along +x, rectified by
construction. Bars:

- ``build_stereo``, XFeat: the same valid keypoints (1e-3 px; keypoints
  of equal score may come in another order, so rows are matched by
  pixel), depth and
  ur within 1e-4 where both frames have them, the same keypoints with
  depth but for near-ties of the matcher (<= 1%). ORB: level 0 as XFeat
  (integer pixels, exact); the resized levels part as in
  ``tests/test_torch_orb.py`` (keypoints by Jaccard >= 0.95 per level),
  so there depth and ur are held on the keypoints both frames share.
- ``build_stereo_fisheye`` (ORB, the rendered fisheye rig of
  ``tests/test_fisheye.py`` at 256x256, its cameras scaled by 0.5): the
  port's depth on the level-0 keypoints within 1e-4 relative of JAX's, at
  least 50 keypoints with depth, the median error against the rendered
  depth within 1e-3 of the JAX frame's and below 10% (JAX's 5% bar is for
  512x512; at half the resolution both packages read 6.9%).
- the eager ``xfeat_stereo_frame_step`` against JAX's with the bars of
  ``tests/test_torch_track_step.py`` (poses 1e-4, slots and inliers >=
  0.99).
- ``System(Sensor.STEREO)`` over 6 frames, both backends (XFeat in
  ``tests/test_torch_slam_stereo_xfeat.py``, which keeps each file near a
  minute), against the JAX System: the same states and keyframe counts,
  every frame within 8 cm of the truth (JAX's stereo bar); XFeat within
  0.01 mm of JAX on every frame (measured 2.3e-3 mm). ORB within 1.5 mm
  (measured 1.403 mm at frame 3, at most 0.029 mm elsewhere); with its
  levels above 0 resized by ``jax.image.resize`` it is within 0.01 mm
  (measured 2.79e-3 mm), so the gap is the port's antialiased resize,
  about 3e-6 a sample from JAX's, flipping FAST and BRIEF decisions on the
  upper levels. The keyframes' stereo observations (depth, ur) through
  atlas files, either package's file loaded equal in both.
- the JAX package's two ``TestStereoSlam`` tests at 640x480 through the
  port's System, ``slow``."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# both packages resolve the BRIEF pattern when imported
os.environ["XFEATSLAM_BRIEF_PATTERN"] = "gaussian"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.models import extractor as jex  # noqa: E402
from xfeatslam_tpu.models import orb as jorb  # noqa: E402
from xfeatslam_tpu.models import weights as jw  # noqa: E402
from xfeatslam_tpu.models.extractor import extract_fn as jax_extract  # noqa: E402
from xfeatslam_tpu.ops import camera as jc  # noqa: E402
from xfeatslam_tpu.optim import track_step as jts  # noqa: E402
from xfeatslam_tpu.slam import frame as jframe  # noqa: E402
from xfeatslam_tpu.slam import serialization as jser  # noqa: E402
from xfeatslam_tpu.slam import settings as jset  # noqa: E402
from xfeatslam_tpu.slam import system as jsys  # noqa: E402
from xfeatslam_tpu.utils import synthetic as jsyn  # noqa: E402
from xfeatslam_tpu_torch.models import extractor as tex  # noqa: E402
from xfeatslam_tpu_torch.models import orb as torb  # noqa: E402
from xfeatslam_tpu_torch.models import weights as tw  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402
from xfeatslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from xfeatslam_tpu_torch.optim import track_step as tts  # noqa: E402
from xfeatslam_tpu_torch.slam import frame as tframe  # noqa: E402
from xfeatslam_tpu_torch.slam import serialization as tser  # noqa: E402
from xfeatslam_tpu_torch.slam import settings as tset  # noqa: E402
from xfeatslam_tpu_torch.slam import system as tsys  # noqa: E402

from test_fisheye import KB1, KB2, fisheye_rays, make_rig  # noqa: E402
from test_torch_serialization import assert_same_atlas  # noqa: E402
from test_torch_xfeat import NPZ  # noqa: E402

N_FRAMES, HW, SCALE, BASELINE = 6, (288, 384), 0.6, 0.08
KMAT = np.array([[517.3 * SCALE, 0, 318.6 * SCALE],
                 [0, 516.5 * SCALE, 255.3 * SCALE], [0, 0, 1]], np.float32)
CAMP = [float(KMAT[0, 0]), float(KMAT[1, 1]), float(KMAT[0, 2]),
        float(KMAT[1, 2])]
BF = BASELINE * CAMP[0]
SETTINGS = dict(bf=BF, th_depth=3.0, depth_map_factor=1.0, n_features=1000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stereo_sequence(n, hw, K):
    """JAX's stereo test rig: the left frames of ``make_sequence`` and
    their right views 8 cm along the left camera's +x."""
    seq = jsyn.make_sequence(n_frames=n, hw=hw, K=K)
    K = seq["K"]
    scene = jsyn.RoomScene(seed=0)
    seq["rights"] = [scene.render(K, R, (t - np.array(
        [BASELINE, 0, 0], np.float32)).astype(np.float32), hw)[0]
        for (R, t) in seq["poses"][:n]]
    return seq


@pytest.fixture(scope="module")
def seq():
    return stereo_sequence(N_FRAMES, HW, KMAT)


def _pipelines(backend):
    if backend == "orb":
        jx, tx = (jorb.ORBExtractor(nfeatures=1000),
                  torb.ORBExtractor(nfeatures=1000, device="cpu"))
    else:
        jx, tx = (jex.XFeatExtractor(nfeatures=1000),
                  tex.XFeatExtractor(nfeatures=1000, device="cpu"))
    return (jframe.FramePipeline(jx, jc.Pinhole.from_list(CAMP), bf=BF,
                                 depth_factor=1.0),
            tframe.FramePipeline(tx, tc.Pinhole.from_list(CAMP), bf=BF,
                                 depth_factor=1.0))


def _keyed(f):
    """A frame's valid keypoints keyed by (octave, pixel of that level)."""
    lvl = f.kpts / 1.2 ** f.octave[:, None]
    return {(int(o), tuple(np.round(p).astype(np.int64))): i
            for i, (p, o, v) in enumerate(zip(lvl, f.octave, f.valid)) if v}


@pytest.mark.parametrize("backend", ["xfeat", "orb"])
def test_build_stereo_matches_jax(seq, backend):
    jp, tp = _pipelines(backend)
    fj = jp.build_stereo(seq["images"][1], seq["rights"][1], 0.0)
    ck.reset_launch_counts()
    ft = tp.build_stereo(seq["images"][1], seq["rights"][1], 0.0)
    assert set(ck.launch_counts().values()) == {0}
    kj, kt = _keyed(fj), _keyed(ft)
    if backend == "xfeat":
        # the same keypoints; equal scores may come in another order
        assert set(kt) == set(kj) and len(kt) > 300
        rows = [(kt[k], kj[k]) for k in kt]
        it, ij = (np.array(x) for x in zip(*rows))
        np.testing.assert_allclose(ft.kpts[it], fj.kpts[ij], atol=1e-3)
    else:
        for lvl in range(8):
            a = {k for k in kt if k[0] == lvl}
            b = {k for k in kj if k[0] == lvl}
            assert a == b if lvl == 0 else (
                len(a & b) >= 0.95 * len(a | b)), lvl
        rows = [(kt[k], kj[k]) for k in kt if k in kj]
    it, ij = (np.array(x) for x in zip(*rows))
    both = (ft.depth[it] > 0) & (fj.depth[ij] > 0)
    either = (ft.depth[it] > 0) | (fj.depth[ij] > 0)
    assert both.sum() >= 0.99 * either.sum() and both.sum() > 100
    np.testing.assert_allclose(ft.depth[it][both], fj.depth[ij][both],
                               rtol=1e-4)
    np.testing.assert_allclose(ft.ur[it][both], fj.ur[ij][both], atol=1e-4 * 384)
    assert (ft.ur[ft.depth <= 0] == -1).all()
    # against the rendered depth (JAX's stereo test's 5% median bar)
    sel = ft.valid & (ft.depth > 0)
    xi = np.clip(ft.kpts[sel, 0].astype(int), 0, HW[1] - 1)
    yi = np.clip(ft.kpts[sel, 1].astype(int), 0, HW[0] - 1)
    gt = seq["depths"][1][yi, xi]
    assert np.median(np.abs(ft.depth[sel] - gt) / gt) < 0.05


def test_build_stereo_fisheye_matches_jax():
    hw = (256, 256)
    kb1, kb2 = (jc.KannalaBrandt8.from_list(
        [float(v) * (0.5 if i < 4 else 1.0) for i, v in enumerate(cam)])
        for cam in (KB1, KB2))
    scene = jsyn.RoomScene(seed=3)
    T = make_rig()
    T21 = np.linalg.inv(T)
    R2, t2 = T21[:3, :3].astype(np.float32), T21[:3, 3].astype(np.float32)
    img1, dep1 = scene.render(None, np.eye(3, dtype=np.float32),
                              np.zeros(3, np.float32), hw,
                              rays_c=fisheye_rays(kb1, hw))
    img2, _ = scene.render(None, R2, t2, hw, rays_c=fisheye_rays(kb2, hw))
    jp = jframe.FramePipeline(jorb.ORBExtractor(nfeatures=1000), kb1, bf=21.0,
                              depth_factor=1.0)
    tk1, tk2 = (tc.KannalaBrandt8.from_list([float(v) for v in k])
                for k in (kb1, kb2))
    tp = tframe.FramePipeline(torb.ORBExtractor(nfeatures=1000, device="cpu"),
                              tk1, bf=21.0, depth_factor=1.0)
    lap = (0, 255)
    fj = jp.build_stereo_fisheye(img1, img2, 0.0, kb2, T, lapping1=lap,
                                 lapping2=lap)
    ft = tp.build_stereo_fisheye(img1, img2, 0.0, tk2, T, lapping1=lap,
                                 lapping2=lap)
    np.testing.assert_array_equal(ft.kpts_un, ft.kpts)  # raw fisheye pixels
    assert (ft.ur == -1).all()
    kj, kt = _keyed(fj), _keyed(ft)
    lvl0 = [k for k in kt if k[0] == 0]
    assert set(lvl0) == {k for k in kj if k[0] == 0}
    it = np.array([kt[k] for k in lvl0])
    ij = np.array([kj[k] for k in lvl0])
    both = (ft.depth[it] > 0) & (fj.depth[ij] > 0)
    assert both.sum() >= 0.99 * ((ft.depth[it] > 0) | (fj.depth[ij] > 0)).sum()
    np.testing.assert_allclose(ft.depth[it][both], fj.depth[ij][both],
                               rtol=1e-4)
    def median_rel(f):
        sel = f.valid & (f.depth > 0)
        xi = np.clip(np.round(f.kpts[sel, 0]).astype(int), 0, hw[1] - 1)
        yi = np.clip(np.round(f.kpts[sel, 1]).astype(int), 0, hw[0] - 1)
        gt = dep1[yi, xi]
        good = gt > 0
        return sel.sum(), np.median(np.abs(f.depth[sel][good] - gt[good])
                                    / gt[good])

    (n_t, rel_t), (_, rel_j) = median_rel(ft), median_rel(fj)
    assert n_t >= 50, n_t
    assert rel_t < 0.1 and abs(rel_t - rel_j) < 1e-3, (rel_t, rel_j)


def _pad(a, n, fill=0):
    out = np.full((n,) + a.shape[1:], fill, a.dtype)
    out[: len(a)] = a
    return out


def test_stereo_frame_step_matches_jax(seq):
    """Frame 0's keypoints with their rendered depth as the map (even ones
    stage 1's 500 slots, odd ones stage 2's 1024 rows), frame 1's pair
    through both packages' whole stereo step."""
    H, W = HW
    KP, M1, M2 = 500, 500, 1024
    params = jw.load_npz(NPZ)
    img0 = seq["images"][0].astype(np.float32)[None, ..., None] / 255.0
    o = {k: np.asarray(v) for k, v in jax_extract(params, jnp.asarray(img0),
                                                   KP).items()}
    kp, desc, val = o["kpts"][0], o["desc"][0], o["valid"][0]
    xi = np.clip(np.round(kp[:, 0]).astype(int), 0, W - 1)
    yi = np.clip(np.round(kp[:, 1]).astype(int), 0, H - 1)
    z = seq["depths"][0][yi, xi]
    fx, fy, cx, cy = CAMP
    Xc = np.stack([(kp[:, 0] - cx) / fx * z, (kp[:, 1] - cy) / fy * z, z], -1)
    R0, t0 = seq["poses"][0]
    Xw = ((Xc - t0) @ R0).astype(np.float32)
    sel = np.nonzero(val & (z > 0))[0]
    s1, s2 = sel[0::2], sel[1::2]
    maps = (R0, t0,
            _pad(Xw[s1], M1), _pad(desc[s1], M1),
            _pad(np.ones(len(s1), bool), M1, False), np.zeros(M1, np.float32),
            np.zeros(M1, np.int32),
            _pad(np.arange(len(s1), dtype=np.int32), M1, -1),
            _pad(Xw[s2], M2), _pad(desc[s2], M2),
            _pad(np.ones(len(s2), bool), M2, False), np.zeros(M2, np.float32),
            np.zeros(M2, np.int32),
            _pad(np.arange(len(s2), dtype=np.int32) + 100000, M2, -1),
            np.full(M2, 10.0, np.float32))
    images = np.stack([seq["images"][1], seq["rights"][1]]).astype(
        np.float32)[..., None] / 255.0
    scal = (BF, 0.5, 192.0, 550.0, 1.0, 15.0, 10.0, 1000.0, 0.9, 20, 1.0)
    jo, jr1, jr2 = jts.xfeat_stereo_frame_step(
        params, jnp.asarray(images), *map(jnp.asarray, maps),
        jc.Pinhole.from_list(CAMP), *(jnp.float32(v) for v in scal[:9]),
        jnp.int32(scal[9]), jnp.float32(scal[10]), jnp.float32(2 * cx),
        jnp.float32(2 * cy), num_keypoints=KP, n_levels=1)
    ck.reset_launch_counts()
    to, tr1, tr2 = tts.xfeat_stereo_frame_step(
        tw.load_npz(NPZ, device="cpu"), torch.from_numpy(images),
        *(torch.from_numpy(np.ascontiguousarray(m)) for m in maps),
        tc.Pinhole.from_list(CAMP), *scal, 2 * cx, 2 * cy,
        num_keypoints=KP, n_levels=1)
    assert set(ck.launch_counts().values()) == {0}
    # the same keypoints (rows matched by pixel: equal scores may come in
    # another order), their depth and ur
    kt = {tuple(np.round(p).astype(np.int64)): i for i, (p, v) in enumerate(
        zip(to["kpts"].numpy(), to["valid"].numpy())) if v}
    kj = {tuple(np.round(p).astype(np.int64)): i for i, (p, v) in enumerate(
        zip(np.asarray(jo["kpts"]), np.asarray(jo["valid"]))) if v}
    assert set(kt) == set(kj) and len(kt) > 300
    it, ij = (np.array(x) for x in zip(*[(kt[k], kj[k]) for k in kt]))
    np.testing.assert_allclose(to["kpts"].numpy()[it],
                               np.asarray(jo["kpts"])[ij], atol=1e-3)
    dt, dj = to["depth"].numpy()[it], np.asarray(jo["depth"])[ij]
    assert ((dt > 0) == (dj > 0)).mean() >= 0.99 and (dt > 0).sum() > 50
    both = (dt > 0) & (dj > 0)
    np.testing.assert_allclose(dt[both], dj[both], rtol=1e-4)
    np.testing.assert_allclose(to["ur"].numpy()[it][both],
                               np.asarray(jo["ur"])[ij][both], atol=1e-3)
    for jr, tr in ((jr1, tr1), (jr2, tr2)):
        np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=1e-4)
        np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-4)
        assert (tr.slot_mp.numpy() == np.asarray(jr.slot_mp)).mean() >= 0.99
        assert (tr.inlier.numpy() == np.asarray(jr.inlier)).mean() >= 0.99
        assert int(tr.n_matched) > 10
    Rg, tg = seq["poses"][1]
    C = -tr2.R.numpy().T @ tr2.t.numpy()
    assert np.linalg.norm(C - (-Rg.T @ tg)) < 0.02


def _run(system, seq, n):
    states, centres = [], []
    for i in range(n):
        state, pose = system.track_stereo(seq["images"][i], seq["rights"][i],
                                          seq["timestamps"][i])
        states.append(state.name)
        centres.append(-pose[0].T @ pose[1])
    return states, np.array(centres)


def _jax_system(seq, backend):
    js = jsys.System(jset.Settings(cam=jc.Pinhole.from_list(CAMP), **SETTINGS),
                     jsys.Sensor.STEREO, backend=backend,
                     enable_loop_closing=False)
    return js, _run(js, seq, N_FRAMES)


@pytest.fixture(scope="module")
def jax_orb_system(seq):
    """The JAX ORB stereo System over the frames, run once."""
    return _jax_system(seq, "orb")


def test_stereo_system_matches_jax(seq, jax_orb_system, tmp_path):
    """The ORB stereo System (the XFeat one is
    tests/test_torch_slam_stereo_xfeat.py's). The gap comes from the
    resized pyramid levels: ``test_stereo_system_on_jax_levels`` closes
    it."""
    check_stereo_system(seq, "orb", 1.5e-3, tmp_path, jax_orb_system)


def test_stereo_system_on_jax_levels(seq, jax_orb_system, tmp_path,
                                     monkeypatch):
    """The ORB stereo System with its levels above 0 resized by
    ``jax.image.resize``, as the JAX extractor resizes them, within 0.01 mm
    of the JAX System on every frame (measured 2.79e-3 mm; the port's own
    antialiased resize differs from JAX's by about 3e-6 a sample, which
    moves frame 3 by 1.403 mm)."""
    def level_image(img0, lvl, h, w):
        if lvl == 0:
            return img0
        x = jax.image.resize(jnp.asarray(img0.numpy()), (h, w), "bilinear")
        return torch.from_numpy(np.array(x))

    monkeypatch.setattr(torb, "_level_image", level_image)
    check_stereo_system(seq, "orb", 1e-5, tmp_path, jax_orb_system)


def check_stereo_system(seq, backend, gap, tmp_path, jax_run=None):
    js, (sj, cj) = jax_run or _jax_system(seq, backend)
    ts = tsys.System(tset.Settings(cam=tc.Pinhole.from_list(CAMP), **SETTINGS),
                     tsys.Sensor.STEREO, backend=backend,
                     enable_loop_closing=False, device="cpu")
    st, ct = _run(ts, seq, N_FRAMES)
    assert st == sj == ["OK"] * N_FRAMES
    assert ts.map.num_keyframes() == js.map.num_keyframes() >= 1
    assert ts.tracking.stats == js.tracking.stats
    if backend == "xfeat":
        # frames 1-5 through the whole stereo step
        assert ts.tracking.stats["fused_grab"] == N_FRAMES - 1
    truth = np.array([-R.T @ t for (R, t) in seq["poses"][:N_FRAMES]])
    for c in (cj, ct):
        # JAX's stereo bar (TestStereoSlam); both read 17.3 mm at most
        assert np.linalg.norm(c - truth, axis=1).max() < 0.08
    assert np.linalg.norm(ct - cj, axis=1).max() < gap
    f = ts.tracking.last_frame
    assert (f.depth > 0).sum() > 100 and (f.ur[f.depth <= 0] == -1).all()
    spans = ts.timer.samples
    assert len(spans["track"]) == N_FRAMES
    assert "track.stereo_match" in spans and "track.frame_build" in spans
    # the map holds the stereo observations (depth, ur), and either
    # package's atlas file loads equal in both
    kf = ts.map.keyframes[0]
    assert (kf.ur[kf.valid] > 0).sum() > 50
    assert (kf.depth[kf.ur > 0] > 0).all()
    for name, sys_ in (("jax", js), ("port", ts)):
        path = str(tmp_path / f"{name}.osa")
        sys_.save_atlas(path)
        assert_same_atlas(jser.load_atlas(path), tser.load_atlas(path))
    own = tser.load_atlas(str(tmp_path / "port.osa")).maps[ts.map.map_id]
    for k, kf in ts.map.keyframes.items():
        np.testing.assert_array_equal(own.keyframes[k].ur, kf.ur)
        np.testing.assert_array_equal(own.keyframes[k].depth, kf.depth)


def _full_size_run(backend, n):
    seq = stereo_sequence(n, (480, 640), None)
    K = seq["K"]
    settings = tset.Settings(
        cam=tc.Pinhole.from_list([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]),
        bf=BASELINE * K[0, 0], th_depth=3.0, depth_map_factor=1.0)
    system = tsys.System(settings, tsys.Sensor.STEREO, backend=backend,
                         device="cpu")
    errs, states = [], []
    for i in range(n):
        state, pose = system.track_stereo(seq["images"][i], seq["rights"][i],
                                          seq["timestamps"][i])
        states.append(state.name)
        if pose is not None:
            Rg, tg = seq["poses"][i]
            errs.append(float(np.linalg.norm(-pose[0].T @ pose[1]
                                             + Rg.T @ tg)))
    return seq, system, states, errs


@pytest.mark.slow
def test_jax_stereo_tracks_bars():
    """TestStereoSlam.test_stereo_tracks (ORB, 8 frames) on the port."""
    seq, system, states, errs = _full_size_run("orb", 8)
    assert set(states) <= {"OK", "NOT_INITIALIZED"}, states
    assert len(errs) >= 6
    assert max(errs) < 0.08, errs
    f = system.tracking.last_frame
    assert (f.depth > 0).sum() > 100
    d_gt = seq["depths"][7]
    sel = f.valid & (f.depth > 0)
    xi = np.clip(f.kpts[sel, 0].astype(int), 0, 639)
    yi = np.clip(f.kpts[sel, 1].astype(int), 0, 479)
    assert np.median(np.abs(f.depth[sel] - d_gt[yi, xi]) / d_gt[yi, xi]) < 0.05


@pytest.mark.slow
def test_jax_xfeat_stereo_single_dispatch_bars():
    """TestStereoSlam.test_xfeat_stereo_single_dispatch (10 frames) on the
    port."""
    n = 10
    _, system, states, errs = _full_size_run("xfeat", n)
    assert states.count("OK") >= n - 2, states
    assert max(errs) < 0.08, errs
    assert system.tracking.stats.get("fused_grab", 0) >= n - 4
    assert (system.tracking.last_frame.depth > 0).sum() > 50

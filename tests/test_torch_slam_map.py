"""The PyTorch port's SLAM data model and geometry against the JAX
package: the map (a scripted sequence of map edits gives identical
arrays), the atlas, the trajectory IO, the batched triangulation search
(identical indices and acceptance, points within 1e-4) and
``FramePipeline.build_rgbd`` (the extraction tests' tolerances:
sub-pixel offsets within one quantization step; the depth gate
identical)."""

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

import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.models.extractor import XFeatExtractor as JaxExtractor  # noqa: E402
from xfeatslam_tpu.ops import camera as jc  # noqa: E402
from xfeatslam_tpu.ops import geometry as jg  # noqa: E402
from xfeatslam_tpu.ops import lie as jl  # noqa: E402
from xfeatslam_tpu.slam import atlas as jatlas  # noqa: E402
from xfeatslam_tpu.slam import frame as jframe  # noqa: E402
from xfeatslam_tpu.slam import map as jmap  # noqa: E402
from xfeatslam_tpu.utils import io as jio  # noqa: E402
from xfeatslam_tpu.utils import synthetic as jsyn  # noqa: E402
from xfeatslam_tpu_torch.models.extractor import XFeatExtractor  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402
from xfeatslam_tpu_torch.ops import geometry as tg  # noqa: E402
from xfeatslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from xfeatslam_tpu_torch.slam import atlas as tatlas  # noqa: E402
from xfeatslam_tpu_torch.slam import frame as tframe  # noqa: E402
from xfeatslam_tpu_torch.slam import map as tmap  # noqa: E402
from xfeatslam_tpu_torch.utils import io as tio  # noqa: E402

from test_torch_xfeat import NPZ  # noqa: E402

POINT_FIELDS = ("pos", "desc", "normal", "dmin", "dmax", "n_obs", "visible",
                "found", "alive", "first_kf", "angle", "octave")


def _pose(xi):
    R, t = jl.se3_exp(jnp.asarray(np.asarray(xi, np.float32)))
    return np.asarray(R), np.asarray(t)


def _keyframe(mod, rng, kid, K=40):
    """A keyframe of module ``mod`` with random measurements (the same
    numbers for both packages when the rng state is the same)."""
    R, t = _pose(rng.normal(0, 0.05, 6))
    desc = rng.standard_normal((K, 64)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    return mod.KeyFrame(
        kid=kid, frame_id=kid, timestamp=kid / 30.0,
        kpts_un=rng.uniform(0, 640, (K, 2)).astype(np.float32), desc=desc,
        valid=rng.uniform(size=K) > 0.1,
        ur=np.where(rng.uniform(size=K) > 0.5, 300.0, -1.0).astype(np.float32),
        depth=rng.uniform(0.5, 4, K).astype(np.float32), R=R, t=t)


def _script(mod, seed):
    """Add, observe, replace, cull and snapshot: the calls tracking and
    local mapping make, in one fixed order."""
    rng = np.random.default_rng(seed)
    m = mod.SlamMap()
    kfs = [_keyframe(mod, rng, k) for k in range(5)]
    m.add_keyframe(kfs[0])
    mps = []
    for i in range(60):
        pos = rng.uniform(-2, 2, 3).astype(np.float32)
        pos[2] += 4.0
        mps.append(m.create_point(pos, kfs[0].desc[i % 40], 0,
                                  octave=int(i % 3),
                                  dist_ref=float(np.linalg.norm(pos))))
        m.add_observation(mps[-1], 0, i % 40, update_links=False)
    for k in range(1, 5):
        m.add_keyframe(kfs[k])
        for j, mp in enumerate(mps):
            if rng.uniform() < 0.6 and m.points.alive[mp] and \
                    kfs[k].mp_ids[j % 40] < 0:
                m.add_observation(mp, k, j % 40)
        m.update_connections(k)
    m.points.visible[mps[:10]] += 3
    m.points.found[mps[5:15]] += 1
    m.replace_point(mps[3], mps[4])
    m.replace_point(mps[7], mps[2])
    m.remove_observation(mps[11], 2)
    m.remove_point(mps[20])
    for mp in mps[30:40]:
        if m.points.alive[mp]:
            m.update_point(mp)
    m.remove_keyframe(3)
    m.update_connections(4)
    fresh = m.create_point(np.ones(3, np.float32), kfs[1].desc[0], 1)
    snap = m.point_snapshot(np.array(mps[::3] + [fresh]), 32)
    return m, snap


@pytest.mark.parametrize("seed", [0, 1])
def test_map_script_matches_jax(seed):
    mj, sj = _script(jmap, seed)
    mt, st = _script(tmap, seed)
    for f in POINT_FIELDS:
        np.testing.assert_array_equal(getattr(mt.points, f),
                                      getattr(mj.points, f), err_msg=f)
    assert mt.points.free == mj.points.free
    assert mt.obs == mj.obs
    assert mt.covis == mj.covis
    assert mt.change_index == mj.change_index
    assert sorted(mt.keyframes) == sorted(mj.keyframes)
    for kid, kf in mt.keyframes.items():
        np.testing.assert_array_equal(kf.mp_ids, mj.keyframes[kid].mp_ids)
        assert kf.parent == mj.keyframes[kid].parent
        assert kf.children == mj.keyframes[kid].children
    assert mt.culled.keys() == mj.culled.keys()
    for kid in mt.culled:
        for a, b in zip(mt.culled[kid], mj.culled[kid]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        mt.predict_scale(np.arange(10), np.full(10, 3.0, np.float32)),
        mj.predict_scale(np.arange(10), np.full(10, 3.0, np.float32)))
    assert mt.num_points() == mj.num_points() > 30
    assert mt.covisible_kfs(4) == mj.covisible_kfs(4)


def test_atlas_matches_jax():
    for mod, mapmod in ((jatlas, jmap), (tatlas, tmap)):
        a = mod.Atlas()
        removed = []
        a.kf_removed_hook = lambda mid, kid: removed.append((mid, kid))
        first = a.active
        second = a.create_new_map()
        assert a.active is second and a.active_id == 1
        a.change_map(0)
        assert a.active is first
        rng = np.random.default_rng(0)
        first.add_keyframe(_keyframe(mapmod, rng, 0))
        first.add_keyframe(_keyframe(mapmod, rng, 1))
        first.remove_keyframe(1)
        assert removed == [(0, 1)]
        assert a.total_keyframes() == 1 and len(a.all_maps()) == 2
        a.remove_map(1)
        assert list(a.maps) == [0]


def test_trajectory_io_matches_jax(tmp_path, rng):
    poses = [_pose(rng.normal(0, 0.5, 6)) for _ in range(7)]
    ts = [i / 30.0 for i in range(7)]
    for name in ("save_trajectory_tum", "save_trajectory_euroc"):
        pj, pt = tmp_path / f"j_{name}", tmp_path / f"t_{name}"
        getattr(jio, name)(str(pj), ts, poses)
        getattr(tio, name)(str(pt), ts, poses)
        assert pj.read_text() == pt.read_text()
    jio.save_trajectory_kitti(str(tmp_path / "jk"), poses)
    tio.save_trajectory_kitti(str(tmp_path / "tk"), poses)
    assert (tmp_path / "jk").read_text() == (tmp_path / "tk").read_text()
    for R, _ in poses:
        np.testing.assert_array_equal(tio.rotation_to_quat_xyzw(R),
                                      jio.rotation_to_quat_xyzw(R))
    t_ts, t_rows = tio.load_trajectory_tum(str(tmp_path / "t_save_trajectory_tum"))
    j_ts, j_rows = jio.load_trajectory_tum(str(tmp_path / "t_save_trajectory_tum"))
    np.testing.assert_array_equal(t_rows, j_rows)
    gt = rng.uniform(-1, 1, (7, 3))
    for align in (True, False):
        assert tio.ate_rmse(j_ts, gt, t_ts, t_rows[:, :3], align=align) == \
            jio.ate_rmse(j_ts, gt, t_ts, t_rows[:, :3], align=align)


def _tri_problem(seed, N=300, Nn=4, n_valid=3):
    """A keyframe and Nn stacked neighbours (n_valid real) observing the
    same points: planted descriptor matches, pixel noise, depth on about
    half of the slots, some slots taken."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = 517.3, 516.5, 318.6, 255.3
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    X = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                  rng.uniform(2, 7, N)], -1).astype(np.float32)
    base = rng.standard_normal((N, 64)).astype(np.float32)

    def view(xi):
        R, t = _pose(xi)
        Xc = X @ R.T + t
        uv = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx,
                       fy * Xc[:, 1] / Xc[:, 2] + cy], -1)
        uv = (uv + rng.normal(0, 0.4, uv.shape)).astype(np.float32)
        d = rng.standard_normal((N, 64)).astype(np.float32) * 0.15 + base
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        depth = np.where(rng.uniform(size=N) > 0.5, Xc[:, 2], 0.0).astype(
            np.float32)
        perm = rng.permutation(N)
        return R, t, uv[perm], d[perm], depth[perm], rng.uniform(size=N) > 0.15

    R1, t1, uv1, d1, dep1, free1 = view(np.zeros(6))
    nbs = [view(np.array([0.1 + 0.12 * j, 0.02 * j, 0.01, 0.01 * j, 0.02,
                          0.01 * j])) for j in range(Nn)]
    # R, t, uv, desc, free, depth
    stack = [np.stack([nb[i] for nb in nbs]) for i in (0, 1, 2, 3, 5, 4)]
    nb_valid = np.arange(Nn) < n_valid
    return (K, R1, t1, uv1, d1, free1, dep1, *stack, nb_valid,
            fx, fy, cx, cy, 40.0, 600.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangulation_search_matches_jax(seed):
    args = _tri_problem(seed)
    arrays, scalars = args[:14], args[14:]
    ij, okj, Xj = (np.asarray(a) for a in jg.triangulation_search_batched(
        *map(jnp.asarray, arrays), *(jnp.float32(s) for s in scalars),
        ratio=0.8))
    it, okt, Xt = (a.numpy() for a in tg.triangulation_search_batched(
        *(torch.from_numpy(np.asarray(a)) for a in arrays), *scalars,
        ratio=0.8))
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(okt, okj)
    assert okt[:3].sum() > 100 and not okt[3].any()
    np.testing.assert_allclose(Xt[okt], Xj[okj], atol=1e-4)


def test_geometry_helpers_match_jax(rng):
    R1, t1 = _pose(rng.normal(0, 0.1, 6))
    R2, t2 = _pose(rng.normal(0, 0.1, 6))
    K = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]], np.float32)
    Fj = np.asarray(jg.fundamental_from_poses(*map(jnp.asarray,
                                                   (K, R1, t1, K, R2, t2))))
    Ft = tg.fundamental_from_poses(*map(torch.from_numpy,
                                        (K, R1, t1, K, R2, t2))).numpy()
    np.testing.assert_allclose(Ft, Fj, rtol=1e-5, atol=1e-9)
    P1j = np.asarray(jg.projection_matrix(*map(jnp.asarray, (K, R1, t1))))
    P1t = tg.projection_matrix(*map(torch.from_numpy, (K, R1, t1))).numpy()
    np.testing.assert_allclose(P1t, P1j, rtol=1e-6, atol=1e-4)
    P2 = np.asarray(jg.projection_matrix(*map(jnp.asarray, (K, R2, t2))))
    X = rng.uniform(-1, 1, (50, 3)).astype(np.float32) + [0, 0, 4]
    uv1 = (X @ R1.T + t1)
    uv1 = (uv1[:, :2] / uv1[:, 2:]) * [517.3, 516.5] + [318.6, 255.3]
    uv2 = (X @ R2.T + t2)
    uv2 = (uv2[:, :2] / uv2[:, 2:]) * [517.3, 516.5] + [318.6, 255.3]
    uv1, uv2 = uv1.astype(np.float32), uv2.astype(np.float32)
    Xj = np.asarray(jg.triangulate_dlt(*map(jnp.asarray, (uv1, uv2, P1j, P2))))
    Xt = tg.triangulate_dlt(*map(torch.from_numpy, (uv1, uv2, P1j, P2))).numpy()
    np.testing.assert_allclose(Xt, Xj, atol=1e-4)
    np.testing.assert_allclose(Xt, X, atol=1e-2)
    ej = np.asarray(jg.epipolar_dist_sq(*map(jnp.asarray, (uv1, uv2, Fj))))
    et = tg.epipolar_dist_sq(*map(torch.from_numpy, (uv1, uv2, Fj))).numpy()
    np.testing.assert_allclose(et, ej, rtol=1e-4, atol=1e-6)
    c1, c2 = -R1.T @ t1, -R2.T @ t2
    np.testing.assert_allclose(
        tg.parallax_cos(*map(torch.from_numpy, (X, c1, c2))).numpy(),
        np.asarray(jg.parallax_cos(*map(jnp.asarray, (X, c1, c2)))),
        atol=1e-6)


H, W, KP = 96, 128, 128
STEP = 1.0 / 255 + 1e-5
KMAT = np.array([[517.3 * 0.2, 0, 318.6 * 0.2], [0, 516.5 * 0.2, 255.3 * 0.2],
                 [0, 0, 1]], np.float32)


def test_build_rgbd_matches_jax():
    seq = jsyn.make_sequence(2, (H, W), K=KMAT)
    camp = [float(KMAT[0, 0]), float(KMAT[1, 1]), float(KMAT[0, 2]),
            float(KMAT[1, 2])]
    pj = jframe.FramePipeline(JaxExtractor(nfeatures=KP, weights_path=NPZ),
                              jc.Pinhole.from_list(camp), bf=40.0,
                              depth_factor=1.0)
    pt = tframe.FramePipeline(XFeatExtractor(nfeatures=KP, weights_path=NPZ,
                                             device="cpu"),
                              tc.Pinhole.from_list(camp), bf=40.0,
                              depth_factor=1.0)
    ck.reset_launch_counts()
    for i in range(2):
        fj = pj.build_rgbd(seq["images"][i], seq["depths"][i], i / 30.0)
        ft = pt.build_rgbd(seq["images"][i], seq["depths"][i], i / 30.0)
        assert ft.fid == fj.fid == i
        np.testing.assert_array_equal(ft.valid, fj.valid)
        v = ft.valid
        assert v.sum() > 30
        # sub-pixel offsets within one quantization step (1/255 px), as the
        # detect tests allow
        np.testing.assert_allclose(ft.kpts[v], fj.kpts[v], atol=STEP)
        np.testing.assert_allclose(ft.kpts_un[v], fj.kpts_un[v], atol=STEP)
        # descriptors at 1e-4 where the keypoint agrees, and at 1e-3 where
        # its offset moved one step (the sample point moved with it)
        same = v & (np.abs(ft.kpts - fj.kpts).max(1) < 1e-4)
        assert same.sum() >= v.sum() - max(1, v.sum() // 100)
        np.testing.assert_allclose(ft.desc[same], fj.desc[same], atol=1e-4)
        np.testing.assert_allclose(ft.desc[v], fj.desc[v], atol=1e-3)
        np.testing.assert_allclose(ft.scores[v], fj.scores[v], atol=1e-5)
        # the depth gate: the same keypoints keep their depth
        np.testing.assert_array_equal(ft.depth > 0, fj.depth > 0)
        np.testing.assert_allclose(ft.depth, fj.depth, atol=1e-6)
        np.testing.assert_allclose(ft.ur, fj.ur, atol=STEP)
        assert 0 < (ft.depth > 0).sum() < v.sum()  # some gated, some kept
    assert set(ck.launch_counts().values()) == {0}

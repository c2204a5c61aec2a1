"""The PyTorch port's loop closing (``slam/loop_closing.py``) against the JAX
package on ``utils/synthetic.make_loop_map`` at the size of
``tests/test_loop_closing.py`` (14 keyframes, 400 points, monocular,
``fix_scale=False``, one confirmation, the 25/30 projection gates).

- The port's ``make_loop_map`` builds the JAX package's map from the same
  numpy generator: every keypoint, descriptor, slot binding, observation
  and covisibility weight equal. Its keyframe poses come from the port's
  float32 SE3 exponential, which rounds differently from XLA's (XLA:CPU
  contracts to FMA and has its own sin/cos), so poses and points are held
  to 1e-6 (6e-8 apart at most here).
- Both LoopClosings, fed copies of one map and the same RANSAC draws (the
  JAX package's ``jax.random.categorical`` draws, computed here), detect
  and close the same loops, and every keyframe pose ends within 1e-3 m of
  the JAX package's after the correction and its GBA. The same holds for
  the budgeted GBA (the port's three ticks against the JAX package's
  ``flush``, with a keyframe made during the session) and for two maps of
  one scene welded by a merge (the same merges, remaps and keyframes), and
  for an IMU-initialized map, whose loop goes through the 4-DoF essential
  graph (poses within 1e-4 m).
- On the port alone: no loop without a revisit; the budgeted GBA aborts
  when the map's geometry epoch moves; a culled keyframe leaves the index.

The 14-keyframe map is built once per module (``loop_map``) and every test
takes copies of it. The 40-keyframe ``bench.py --mode loop`` chain through
both packages is a ``slow`` test (not in Tier-1)."""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.ops import camera as jc  # noqa: E402
from xfeatslam_tpu.ops import lie as jl  # noqa: E402
from xfeatslam_tpu.slam import loop_closing as jlc  # noqa: E402
from xfeatslam_tpu.utils import synthetic as jsyn  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402
from xfeatslam_tpu_torch.slam import atlas as tatlas  # noqa: E402
from xfeatslam_tpu_torch.slam import loop_closing as tlc  # noqa: E402
from xfeatslam_tpu_torch.slam import map as tmap  # noqa: E402
from xfeatslam_tpu_torch.utils import synthetic as tsyn  # noqa: E402

CAMP = [517.3, 516.5, 318.6, 255.3]
JCAM, TCAM = jc.Pinhole.from_list(CAMP), tc.Pinhole.from_list(CAMP)
GATES = dict(proj_matches=25, proj_matches_strict=30)
# the port's loop closing on the CPU, as the tests run it
TGATES = dict(GATES, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_draws(valid, seed):
    """The minimal sets ``xfeatslam_tpu``'s loop closing draws for
    ``PRNGKey(seed)`` (``optim/sim3.sim3_ransac``), as a tensor."""
    v = valid.cpu().numpy()
    n = len(v)
    w = v.astype(np.float32) + 1e-6
    logits = jnp.log(w)[None, None, :].repeat(tlc.RANSAC_ITERS, 1).reshape(
        tlc.RANSAC_ITERS, 1, n).repeat(3, 1)
    key = jax.random.PRNGKey(seed)
    return torch.from_numpy(np.array(
        jax.random.categorical(key, logits, axis=-1)))


def port_copy(jmap):
    """A deep copy of a JAX package ``SlamMap`` in the port's classes."""
    m = tmap.SlamMap.__new__(tmap.SlamMap)
    m.__dict__ = copy.deepcopy(
        {k: v for k, v in jmap.__dict__.items()
         if k not in ("points", "keyframes", "on_kf_removed")})
    m.on_kf_removed = None
    m.points = tmap.MapPointStore.__new__(tmap.MapPointStore)
    m.points.__dict__ = copy.deepcopy(jmap.points.__dict__)
    m.keyframes = {
        k: tmap.KeyFrame(**{f.name: copy.deepcopy(getattr(kf, f.name))
                            for f in dataclasses.fields(tmap.KeyFrame)})
        for k, kf in jmap.keyframes.items()}
    return m


def rmse(m, poses, gt):
    return float(np.sqrt(np.mean([np.linalg.norm(poses(k) - gt[k][1]) ** 2
                                  for k in m.keyframes])))


@pytest.fixture(scope="module")
def loop_map():
    """The JAX package's 14-keyframe loop map and its truth, built once;
    tests take copies (``copy.deepcopy`` for the JAX package,
    ``port_copy`` for the port)."""
    return jsyn.make_loop_map(np.random.default_rng(0))


def assert_same_poses(tm, jm, atol=1e-3):
    """The same keyframes in both maps, every pose within ``atol``."""
    assert sorted(tm.keyframes) == sorted(jm.keyframes)
    gap = max(np.linalg.norm(tm.keyframes[k].center()
                             - jm.keyframes[k].center())
              for k in jm.keyframes)
    assert gap < atol, gap
    for k, jkf in jm.keyframes.items():
        np.testing.assert_allclose(tm.keyframes[k].R, jkf.R, atol=atol)
        np.testing.assert_allclose(tm.keyframes[k].t, jkf.t, atol=atol)


@pytest.mark.parametrize("kw", [None, dict(n_kf=18, revisit_tail=4,
                                           period=14, bf=40.0)])
def test_loop_map_matches_jax(kw, loop_map):
    if kw is None:
        jm, jgt, jest = loop_map
        kw = {}
    else:
        jm, jgt, jest = jsyn.make_loop_map(np.random.default_rng(0), **kw)
    tm, tgt, test_ = tsyn.make_loop_map(np.random.default_rng(0), **kw)
    for a, b in zip(jgt, tgt):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    for a, b in zip(jest, test_):
        np.testing.assert_allclose(b[0], a[0], atol=1e-6)
        np.testing.assert_allclose(b[1], a[1], atol=1e-6)
    assert sorted(jm.keyframes) == sorted(tm.keyframes)
    for k, jkf in jm.keyframes.items():
        tkf = tm.keyframes[k]
        for f in ("kpts_un", "desc", "valid", "ur", "depth", "mp_ids",
                  "global_desc"):
            assert np.array_equal(getattr(jkf, f), getattr(tkf, f)), f
        assert (jkf.parent, jkf.children) == (tkf.parent, tkf.children)
        np.testing.assert_allclose(tkf.R, jkf.R, atol=1e-6)
        np.testing.assert_allclose(tkf.t, jkf.t, atol=1e-6)
    n = jm.points.n
    assert n == tm.points.n
    assert np.array_equal(jm.points.desc[:n], tm.points.desc[:n])
    assert np.array_equal(jm.points.alive[:n], tm.points.alive[:n])
    np.testing.assert_allclose(tm.points.pos[:n], jm.points.pos[:n],
                               atol=1e-6)
    assert jm.obs == tm.obs and jm.covis == tm.covis


def both_loop_closings(loop_map, **kw):
    """A JAX and a port LoopClosing over copies of the loop map, the port
    fed the JAX draws."""
    jm = copy.deepcopy(loop_map[0])
    tm = port_copy(jm)
    j = jlc.LoopClosing(jm, JCAM, fix_scale=False, confirmations=1, **kw,
                        **GATES)
    t = tlc.LoopClosing(tm, TCAM, fix_scale=False, confirmations=1, **kw,
                        **TGATES)
    t._minimal_sets = jax_draws
    return j, t


@pytest.fixture(scope="module")
def closed(loop_map):
    """Both LoopClosings over copies of one map, with the JAX draws."""
    j, t = both_loop_closings(loop_map, run_gba=True)
    for kid in sorted(j.map.keyframes):
        j.process_keyframe(kid)
        t.process_keyframe(kid)
    return j, t, loop_map[1], loop_map[2]


def test_same_loops_as_jax(closed):
    j, t, _, _ = closed
    assert t.detected == j.detected
    assert t.closed == j.closed and len(t.closed) >= 1
    assert t.n_sim3_extended == j.n_sim3_extended


def test_corrected_poses_match_jax(closed):
    j, t, gt, est = closed
    assert_same_poses(t.map, j.map)
    # the JAX test's bar for the GBA after the loop, on the port
    m = t.map
    before = np.mean([np.linalg.norm(est[k][1] - gt[k][1])
                      for k in m.keyframes])
    after = np.mean([np.linalg.norm(m.keyframes[k].t - gt[k][1])
                     for k in m.keyframes])
    assert after < 0.85 * before, (after, before)


def test_inertial_loop_uses_the_4dof_graph_as_jax():
    """TestInertialLoop on both packages: an IMU-initialized map (a
    temporal chain, translation-only drift) closes its loop through the
    4-DoF essential graph; the port, fed the JAX draws, closes the same
    loop with the same poses, and meets that test's bars (the tail error
    shrinks, every update a yaw about world z and a translation)."""
    jm, gt, est = jsyn.make_loop_map(
        np.random.default_rng(0),
        drift_xi=np.array([1.0, 0.3, -0.5, 0, 0, 0], np.float32))
    prev = -1
    for kid in sorted(jm.keyframes):
        jm.keyframes[kid].prev_kf = prev
        jm.keyframes[kid].vel = np.zeros(3, np.float32)
        prev = kid
    jm.imu_initialized = True
    tm = port_copy(jm)
    R_wc_before = {k: tm.keyframes[k].R.T.copy() for k in tm.keyframes}
    j = jlc.LoopClosing(jm, JCAM, fix_scale=True, confirmations=1,
                        run_gba=False, **GATES)
    t = tlc.LoopClosing(tm, TCAM, fix_scale=True, confirmations=1,
                        run_gba=False, **TGATES)
    t._minimal_sets = jax_draws
    for kid in sorted(jm.keyframes):
        j.process_keyframe(kid)
        t.process_keyframe(kid)
    assert t.closed == j.closed and len(t.closed) >= 1
    assert_same_poses(tm, jm, atol=1e-4)
    tail = sorted(tm.keyframes)[-3:]
    err_b = np.mean([np.linalg.norm(est[k][1] - gt[k][1]) for k in tail])
    err_a = np.mean([np.linalg.norm(tm.keyframes[k].t - gt[k][1])
                     for k in tail])
    assert err_a < 0.6 * err_b, (err_a, err_b)
    for k, kf in tm.keyframes.items():
        dW = kf.R.T @ R_wc_before[k].T
        assert abs(dW[2, 2] - 1.0) < 1e-4, (k, dW)
        assert np.abs([dW[0, 2], dW[1, 2], dW[2, 0], dW[2, 1]]).max() < 5e-3


def test_no_false_loop_without_revisit():
    m, _, _ = tsyn.make_loop_map(np.random.default_rng(0), n_kf=8)
    for kid in (6, 7):
        m.remove_keyframe(kid)
    lc = tlc.LoopClosing(m, TCAM, fix_scale=False, confirmations=1,
                         run_gba=False, **TGATES)
    for kid in sorted(m.keyframes):
        lc.process_keyframe(kid)
    assert lc.closed == []


@pytest.fixture(scope="module")
def budgeted(loop_map):
    """Both LoopClosings with a 3-round budgeted GBA over copies of one
    map, with the JAX draws, stopped with the session in flight."""
    j, t = both_loop_closings(loop_map, run_gba=True)
    for lc in (j, t):
        lc.gba_budget_rounds = 3
        for kid in sorted(lc.map.keyframes):
            lc.process_keyframe(kid)
    return j, t, loop_map[1], loop_map[2]


def test_budgeted_gba_aborts_on_geometry_epoch(budgeted):
    lc = copy.deepcopy(budgeted[1])
    m = lc.map
    assert lc._gba_session is not None
    before = {k: kf.t.copy() for k, kf in m.keyframes.items()}
    # a whole-map rescale, as an IMU initialization or a merge moves it
    for kf in m.keyframes.values():
        kf.t = (2.0 * kf.t).astype(np.float32)
    m.points.pos[: m.points.n] *= 2.0
    m.geometry_epoch += 1
    lc.tick()
    assert lc._gba_session is None
    for k, kf in m.keyframes.items():
        np.testing.assert_allclose(kf.t, 2.0 * before[k], atol=1e-6)


def test_budgeted_gba_converges_in_ticks(budgeted):
    """The port's session runs its 3 rounds one per tick and lands where
    the JAX package's ``flush`` of the same session does, a keyframe made
    during the session carried along the spanning tree in both."""
    j, t, gt, est = budgeted
    assert t.closed == j.closed and len(t.closed) >= 1
    assert t._gba_session is not None and j._gba_session is not None
    t_rel = np.array([0.05, 0.0, -0.02], np.float32)
    last = max(t.map.keyframes)
    for m in (j.map, t.map):
        # a keyframe made during the session rides the spanning tree
        lkf = m.keyframes[last]
        nk = copy.deepcopy(lkf)
        nk.kid, nk.parent, nk.children = last + 1, last, set()
        nk.mp_ids = np.full_like(nk.mp_ids, -1)
        nk.t = (lkf.t + t_rel).astype(np.float32)
        m.keyframes[nk.kid] = nk
        m.covis[nk.kid] = {}
        lkf.children.add(nk.kid)
    ticks = 0
    while t._gba_session is not None and ticks < 10:
        t.tick()
        ticks += 1
    assert ticks == 3
    assert [s for s, _, _ in t.ba_seconds] == ["first", "tick", "tick",
                                               "tick"]
    j.flush()
    assert j._gba_session is None
    assert_same_poses(t.map, j.map)
    m = t.map
    errs_b = [np.linalg.norm(est[k][1] - gt[k][1]) for k in range(len(est))]
    errs_a = [np.linalg.norm(m.keyframes[k].t - gt[k][1])
              for k in range(len(est))]
    assert np.mean(errs_a) < 0.85 * np.mean(errs_b)
    nk = m.keyframes[last + 1]
    R_rel = nk.R @ m.keyframes[last].R.T
    np.testing.assert_allclose(R_rel, np.eye(3), atol=1e-4)
    np.testing.assert_allclose(nk.t - R_rel @ m.keyframes[last].t, t_rel,
                               atol=1e-4)


def test_culled_keyframe_evicted(loop_map):
    m = port_copy(loop_map[0])
    lc = tlc.LoopClosing(m, TCAM, fix_scale=False, confirmations=1,
                         run_gba=False, **TGATES)
    for kid in range(10):
        lc.process_keyframe(kid)
    assert (m.map_id, 5) in lc.retrieval._index
    m.remove_keyframe(5)
    assert (m.map_id, 5) not in lc.retrieval._index
    hits = lc.retrieval.query(m.keyframes[0].global_desc, set(), top_n=100,
                              min_score=-1.0)
    assert all(kid != 5 for kid, _s in hits)
    for kid in range(10, 14):  # the revisit keyframes verify candidates
        lc.process_keyframe(kid)


def two_map_atlas():
    """test_loop_closing.py's two-map split in the JAX package's classes:
    keyframes 0-6 in map A, 7-13 in map B under an SE3-offset world frame;
    map B's last keyframe revisits map A's first. Returns the atlas and
    the truth."""
    from xfeatslam_tpu.slam.atlas import Atlas

    atlas = Atlas(desc_dim=64)
    atlas.maps.clear()
    mA, gt, _ = jsyn.make_loop_map(np.random.default_rng(7), n_kf=14,
                                   drift_per_kf=0.0)
    for kid in range(7, 14):
        mA.remove_keyframe(kid)
    mA.map_id = 0
    atlas.maps[0] = mA
    mB, _, _ = jsyn.make_loop_map(np.random.default_rng(7), n_kf=14,
                                  drift_per_kf=0.0)
    for kid in range(0, 7):
        mB.remove_keyframe(kid)
    xi = np.array([0.4, -0.2, 0.3, 0.1, 0.2, -0.15], np.float32)
    dR, dt = (np.asarray(x) for x in jl.se3_exp(jnp.asarray(xi)))
    for kf in mB.keyframes.values():
        kf.R = (kf.R @ dR.T).astype(np.float32)
        kf.t = (kf.t - kf.R @ dt).astype(np.float32)
    for mp in list(mB.obs.keys()):
        if mB.points.alive[mp]:
            mB.points.pos[mp] = (dR @ mB.points.pos[mp] + dt).astype(
                np.float32)
    mB.map_id = 1
    atlas.maps[1] = mB
    atlas.active_id = 1
    return atlas, gt


def merge(lc_cls, atlas, **kw):
    """Map B's keyframes through a LoopClosing that knows map A's."""
    mA, mB = atlas.maps[0], atlas.maps[1]
    lc = lc_cls(mB, fix_scale=False, confirmations=1, run_gba=False,
                atlas=atlas, **kw)
    for kid in sorted(mA.keyframes):
        lc.retrieval.add(kid, mA.keyframes[kid].global_desc, map_id=0)
    for kid in sorted(mB.keyframes):
        lc.process_keyframe(kid)
    return lc


def test_two_maps_merge_as_jax():
    """Both packages weld the same two-map atlas (the port on copies of
    the JAX maps, with the JAX draws): the same merges, remaps and
    detections, and the welded map's keyframe poses within 1e-3 m."""
    jatlas, gt = two_map_atlas()
    atlas = tatlas.Atlas(desc_dim=64)
    atlas.maps = {mid: port_copy(m) for mid, m in jatlas.maps.items()}
    atlas.active_id = jatlas.active_id

    def port_lc(m, **kw):
        lc = tlc.LoopClosing(m, TCAM, device="cpu", **kw)
        lc._minimal_sets = jax_draws
        return lc

    j = merge(lambda m, **kw: jlc.LoopClosing(m, JCAM, **kw), jatlas)
    t = merge(port_lc, atlas)
    assert t.merged == j.merged == [(1, 0)]
    assert t.detected == j.detected and t.closed == j.closed
    assert atlas.remaps == jatlas.remaps == {1: (0, 7)}
    assert atlas.active_id == jatlas.active_id == 0
    assert sorted(atlas.maps) == sorted(jatlas.maps) == [0]
    merged = atlas.maps[0]
    assert t.map is merged and merged.num_keyframes() == 14
    assert_same_poses(merged, jatlas.maps[0])
    for k, kf in merged.keyframes.items():
        jkf = jatlas.maps[0].keyframes[k]
        assert (kf.parent, kf.children) == (jkf.parent, jkf.children)
    gt_centers = np.stack([-R.T @ t for (R, t) in gt])
    errs = [np.linalg.norm(gt_centers - kf.center(), axis=-1).min()
            for kf in merged.keyframes.values()]
    assert max(errs) < 0.05, errs
    # every index entry resolves to a live keyframe of the merged map
    assert sorted(t.retrieval._index) == sorted(j.retrieval._index)
    for (mid, kid), row in t.retrieval._index.items():
        assert mid == 0 and kid in merged.keyframes
        assert int(t.retrieval.kids[row]) == kid


# bench.py --mode loop's chain, and the read-out that holds loop accuracy
# on the card: the ATE RMSE after LOOP_EXTRA_GBAS further inline GBAs of the
# final map (the reference schedule's last GBA stops short of convergence)
BENCH_LOOP = dict(n_kf=40, n_pts=1200, period=36, revisit_tail=4, bf=40.0)
LOOP_EXTRA_GBAS = 3


@pytest.mark.slow
def test_bench_loop_chain_matches_jax():
    """``bench.py --mode loop``'s workload through both packages: the
    40-keyframe chain (period 36, 4 revisit keyframes, 1200 points, RGB-D
    with bf 40), fix_scale, 3 confirmations, the 25/30 gates, the inline
    GBA; the port on a copy of the JAX map with the JAX draws. The same
    closures, keyframe centres within 1e-3 m, and the RMSE after the
    correction below the RMSE before in both. Then LOOP_EXTRA_GBAS more
    GBAs of each final map: the JAX package's figure there is
    ``chip_smoke.JAX_LOOP_RMSE_CONVERGED``, and the port's stays within
    ``chip_smoke.LOOP_RMSE_FACTOR`` of it."""
    jm, gt, est = jsyn.make_loop_map(np.random.default_rng(0), **BENCH_LOOP)
    tm = port_copy(jm)
    lcs = (jlc.LoopClosing(jm, JCAM, bf=40.0, fix_scale=True,
                           confirmations=3, run_gba=True, **GATES),
           tlc.LoopClosing(tm, TCAM, bf=40.0, fix_scale=True,
                           confirmations=3, run_gba=True, **TGATES))
    lcs[1]._minimal_sets = jax_draws
    for lc in lcs:
        for kid in sorted(lc.map.keyframes):
            lc.process_keyframe(kid)
    j, t = lcs
    before = rmse(jm, lambda k: est[k][1], gt)
    after_j = rmse(jm, lambda k: jm.keyframes[k].t, gt)
    after_t = rmse(tm, lambda k: tm.keyframes[k].t, gt)
    print(f"closed {j.closed} / {t.closed}; ATE RMSE before {before!r} m, "
          f"after JAX {after_j!r}, port {after_t!r}")
    assert t.closed == j.closed and len(t.closed) >= 1
    assert after_t < before and after_j < before
    gap = max(np.linalg.norm(tm.keyframes[k].center()
                             - jm.keyframes[k].center())
              for k in jm.keyframes)
    assert gap < 1e-3, gap
    for _ in range(LOOP_EXTRA_GBAS):
        for lc in lcs:
            lc.global_bundle_adjust()
    conv_j = rmse(jm, lambda k: jm.keyframes[k].t, gt)
    conv_t = rmse(tm, lambda k: tm.keyframes[k].t, gt)
    print(f"after {LOOP_EXTRA_GBAS} more GBAs: JAX {conv_j!r} m, "
          f"port {conv_t!r} m")
    assert conv_j < after_j and conv_t < after_t
    assert conv_t <= 1.25 * conv_j

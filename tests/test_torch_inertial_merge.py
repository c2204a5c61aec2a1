"""The PyTorch port's inertial map weld and monocular IMU initialization
against the JAX package, at module level on hand-built maps.

- ``LocalMapping.merge_inertial_ba``: the two temporal windows and their
  anchors (``tests/test_inertial.py::TestMergeInertialBA::
  test_window_structure``'s three calls) equal JAX's; on
  ``test_weld_refinement``'s welded 13-keyframe scene (the same
  preintegrations and landmarks in both packages' classes) every state
  within 1e-4 and every landmark within 2e-3 m of JAX's (the tolerances of
  ``test_torch_inertial.py``'s ``local_inertial_ba`` parity), and the port
  meets the JAX test's bar ``err1 < 0.5 * err0``.
- ``LoopClosing.merge_maps`` on the same two IMU-flagged maps and Sim3 in
  both packages (``test_torch_loop_closing.two_map_atlas``), with only the
  moved map initialized and with both: every keyframe's velocity within
  1e-6, ``prev_kf``, the IMU flags and the biases equal, and the
  welding-BA hook called on the welded pair (JAX passes it a culled
  keyframe of the dissolved map in place of the matched one: the name
  ``ckid`` is reused by a loop, JAX ``loop_closing.py:1021``).
- ``LocalMapping._initialize_imu`` of a monocular map (``mono=True``): the
  scale-free first initialization (``prior_a = 1e6``) on a chain of
  ``make_imu_trajectory`` seen at 1/2.5 scale, then the scale refinement
  (priors 1e8, no full-chain BA, ``min_apply = 0.005``, biases left alone)
  after the map drifted 3% in scale, then a refinement below the apply
  threshold; scale within 1e-4 relative, gravity within 1e-4 rad, the
  keyframe poses within 1e-4, velocities within 1e-4 m/s and the biases
  within 1e-5 of JAX's."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xfeatslam_tpu.ops import imu as jimu  # noqa: E402
from xfeatslam_tpu.ops.camera import Pinhole as JPinhole  # noqa: E402
from xfeatslam_tpu.slam import loop_closing as jlc  # noqa: E402
from xfeatslam_tpu.slam import local_mapping as jlm  # noqa: E402
from xfeatslam_tpu.slam import map as jmap  # noqa: E402
from xfeatslam_tpu.utils.synthetic import make_imu_trajectory  # noqa: E402
from xfeatslam_tpu_torch.ops import imu as timu  # noqa: E402
from xfeatslam_tpu_torch.ops.camera import Pinhole  # noqa: E402
from xfeatslam_tpu_torch.optim import inertial as tin  # noqa: E402
from xfeatslam_tpu_torch.slam import atlas as tatlas  # noqa: E402
from xfeatslam_tpu_torch.slam import local_mapping as tlm  # noqa: E402
from xfeatslam_tpu_torch.slam import loop_closing as tlc  # noqa: E402
from xfeatslam_tpu_torch.slam import map as tmap  # noqa: E402

from test_torch_inertial import preintegrate_segments  # noqa: E402
from test_torch_loop_closing import port_copy, two_map_atlas  # noqa: E402

CAMP = [517.3, 516.5, 318.6, 255.3]
JCAM, CAM = JPinhole.from_list(CAMP), Pinhole.from_list(CAMP)
I3 = np.eye(3, dtype=np.float32)
Z3 = np.zeros(3, np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def calibs(noise_gyro=1e-3, noise_acc=1e-2):
    kw = dict(noise_gyro=noise_gyro, noise_acc=noise_acc, walk_gyro=1e-6,
              walk_acc=1e-5, R_bc=I3, t_bc=Z3)
    return jimu.ImuCalib(**kw), timu.ImuCalib(**kw)


def mappings(jm, tm, **kw):
    """Both packages' LocalMapping of a monocular inertial map."""
    jcal, tcal = calibs()
    return (jlm.LocalMapping(jm, JCAM, bf=0.0, imu_calib=jcal, mono=True,
                             **kw),
            tlm.LocalMapping(tm, CAM, 0.0, "cpu", imu_calib=tcal, mono=True,
                             **kw))


def close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), atol=tol,
                               err_msg=what)


# -- MergeInertialBA: the windows ---------------------------------------------

def _dummy_kf(mod, kid, prev):
    z4 = np.zeros(4, np.float32)
    kf = mod.KeyFrame(kid=kid, frame_id=kid, timestamp=float(kid),
                      kpts_un=np.zeros((4, 2), np.float32),
                      desc=np.zeros((4, 64), np.float32),
                      valid=np.zeros(4, bool), ur=z4 - 1.0, depth=z4,
                      R=I3.copy(), t=Z3.copy())
    kf.prev_kf = prev
    return kf


@pytest.mark.parametrize("curr,merge", [(19, 7), (19, 4), (13, 2)])
def test_window_structure(curr, merge):
    """TestMergeInertialBA.test_window_structure's map (the old map's chain
    0-7, the moved map's 8-19, disjoint after the weld) and its three
    calls: the merge keyframe at the old chain's end, mid-chain (the
    window extends forward), and a current chain without a predecessor
    (its oldest state demoted to a fixed anchor). The port hands its
    inertial BA the same free chain, fixed anchors and flags as JAX."""
    jm, tm = jmap.SlamMap(desc_dim=64), tmap.SlamMap(desc_dim=64)
    for m, mod in ((jm, jmap), (tm, tmap)):
        for k in range(20):
            m.keyframes[k] = _dummy_kf(mod, k, -1 if k in (0, 8) else k - 1)
    jl, tl = mappings(jm, tm)
    calls = {}
    for name, lm in (("jax", jl), ("port", tl)):
        calls[name] = []
        lm._local_inertial_ba = (lambda kid, _c=calls[name], **kw:
                                 _c.append((kid, kw)))
        lm.merge_inertial_ba(curr, merge)
    assert calls["port"] == calls["jax"]
    (kid, kw), = calls["port"]
    assert kid == curr and kw["total_slots"] == tlm.MERGE_IBA_SLOTS == 24
    expect = {(19, 7): ([5, 6, 7, 14, 15, 16, 17, 18, 19], [4, 13]),
              (19, 4): ([2, 3, 4, 5, 6, 7, 14, 15, 16, 17, 18, 19], [1, 13]),
              (13, 2): ([1, 2, 3, 4, 5, 9, 10, 11, 12, 13], [0, 8])}
    assert (kw["chain_override"], kw["force_fixed"]) == expect[curr, merge]
    assert kw["fix_anchor"] is False


# -- MergeInertialBA: the weld scene ------------------------------------------

def _project(Xw, R_wb, p_wb):
    R_cw, t_cw = tin.np_body_to_cam(R_wb, p_wb, I3, Z3)
    Xc = Xw @ R_cw.T + t_cw
    z = np.maximum(Xc[:, 2], 1e-6)
    return np.stack([517.3 * Xc[:, 0] / z + 318.6,
                     516.5 * Xc[:, 1] / z + 255.3], -1), Xc[:, 2] > 0.2


def _banks(rng, traj, n_kf, n=60):
    """test_inertial.py's ``_visual_edges`` landmarks (noise 0) of each
    keyframe but the last."""
    out = []
    for k in range(n_kf - 1):
        R_cw, t_cw = tin.np_body_to_cam(traj["R_wb"][k], traj["p_wb"][k],
                                        I3, Z3)
        C = -R_cw.T @ t_cw
        dirs = rng.standard_normal((n, 3))
        dirs[:, 2] = np.abs(dirs[:, 2]) + 1.5
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        Xc = dirs * rng.uniform(2.0, 6.0, n)[:, None]
        rng.standard_normal((n, 2))  # the JAX test's pixel noise draw
        out.append((Xc @ R_cw + C).astype(np.float32))
    return out


def weld_scene(mod, pre_cls, traj, pres, banks, n_kf=13, split=6):
    """TestMergeInertialBA.test_weld_refinement's map in ``mod``'s classes:
    keyframes 0-5 the old map, 6-12 the moved one (its chain cut at 6), the
    moved free states 7-12 off by 3 degrees of yaw and 8 cm, landmarks that
    consecutive keyframes share."""
    yaw = np.deg2rad(3.0)
    cz, sz = np.cos(yaw), np.sin(yaw)
    R_off = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float32)
    t_off = np.array([0.08, -0.05, 0.03], np.float32)
    c0 = traj["p_wb"][7].astype(np.float32)
    m = mod.SlamMap(desc_dim=64)
    m.imu_initialized = True
    K_slots = 128
    mp_of = {}
    for k in range(n_kf):
        obs_uv, obs_key = [], []
        for b in ([k - 1] if k > 0 else []) + ([k] if k < n_kf - 1 else []):
            uv, vis = _project(banks[b], traj["R_wb"][k], traj["p_wb"][k])
            for j in np.nonzero(vis)[0]:
                if len(obs_uv) >= K_slots:
                    break
                obs_uv.append(uv[j])
                obs_key.append((b, int(j)))
        kpts = np.zeros((K_slots, 2), np.float32)
        valid = np.zeros(K_slots, bool)
        kpts[: len(obs_uv)] = np.asarray(obs_uv, np.float32)
        valid[: len(obs_uv)] = True
        R_wb = traj["R_wb"][k].astype(np.float32)
        p_wb = traj["p_wb"][k].astype(np.float32)
        v_w = traj["v_w"][k].astype(np.float32)
        if k >= 7:
            R_wb = (R_off @ traj["R_wb"][k]).astype(np.float32)
            p_wb = (R_off @ (traj["p_wb"][k] - c0) + c0 + t_off).astype(
                np.float32)
            v_w = (R_off @ traj["v_w"][k]).astype(np.float32)
        R_cw, t_cw = tin.np_body_to_cam(R_wb, p_wb, I3, Z3)
        kf = mod.KeyFrame(kid=k, frame_id=k, timestamp=float(traj["t_kf"][k]),
                          kpts_un=kpts, desc=np.zeros((K_slots, 64),
                                                      np.float32),
                          valid=valid, ur=np.full(K_slots, -1.0, np.float32),
                          depth=np.zeros(K_slots, np.float32), R=R_cw, t=t_cw)
        kf.prev_kf = -1 if k in (0, split) else k - 1
        if k not in (0, split):
            kf.pre_kf = pre_cls(*[np.array(f) for f in pres[k - 1]])
        kf.vel = v_w
        m.keyframes[k] = kf
        m.covis.setdefault(k, {})
        if m.kf_origin is None:
            m.kf_origin = k
        for slot, key in enumerate(obs_key):
            if key not in mp_of:
                mp_of[key] = m.create_point(
                    banks[key[0]][key[1]].astype(np.float32),
                    np.zeros(64, np.float32), k)
            m.add_observation(mp_of[key], k, slot, update_links=False)
        m.update_connections(k)
    return m


def test_weld_refinement_against_jax():
    """The welded scene through both packages' ``merge_inertial_ba``: the
    same 24-slot problem (free states 3-5 and 7-12, anchors 2 and 6), the
    states and landmarks at the stated tolerances, and the moved side
    pulled back onto the welding-region landmarks (err1 < 0.5 * err0)."""
    n_kf, split = 13, 6
    traj = make_imu_trajectory(n_kf=n_kf, g_dir=np.array([0, 0, -1.0]))
    pres = preintegrate_segments(traj)
    banks = _banks(np.random.default_rng(0), traj, n_kf)
    jm = weld_scene(jmap, jimu.Preintegrated, traj, pres, banks)
    tm = weld_scene(tmap, timu.Preintegrated, traj, pres, banks)
    jl, tl = mappings(jm, tm)
    moved = range(7, n_kf)

    def err(m):
        return max(np.linalg.norm(m.keyframes[k].center() - traj["p_wb"][k])
                   for k in moved)

    err0 = err(tm)
    assert err0 > 0.05  # the perturbation is real
    jl.merge_inertial_ba(n_kf - 1, split - 1)
    tl.merge_inertial_ba(n_kf - 1, split - 1)
    for k in range(n_kf):
        jkf, tkf = jm.keyframes[k], tm.keyframes[k]
        close(jkf.R, tkf.R, 1e-4, f"R {k}")
        close(jkf.center(), tkf.center(), 1e-4, f"center {k}")
        for f in ("vel", "bg", "ba"):
            close(getattr(jkf, f), getattr(tkf, f), 1e-4, f"{f} {k}")
    n = tm.points.n
    assert jm.points.n == n
    np.testing.assert_array_equal(tm.points.alive[:n], jm.points.alive[:n])
    close(jm.points.pos[:n], tm.points.pos[:n], 2e-3, "landmarks")
    assert tm.change_index == jm.change_index
    err1 = err(tm)
    assert err1 < 0.5 * err0, (err0, err1)


# -- merge_maps with inertial maps ----------------------------------------------

def _imu_flag(m, initialized, rng, bg, ba):
    """Give a JAX package map an inertial chain: velocities, biases, one
    random preintegration on each keyframe after its map's first, and the
    IMU flags."""
    kids = sorted(m.keyframes)
    pre = [np.asarray(rng.standard_normal(s), np.float32)
           for s in ((), (3, 3), (3,), (3,), (15, 15), (3, 3), (3, 3),
                     (3, 3), (3, 3), (3, 3), (3,), (3,))]
    for i, k in enumerate(kids):
        kf = m.keyframes[k]
        kf.prev_kf = kids[i - 1] if i else -1
        kf.vel = rng.standard_normal(3).astype(np.float32)
        kf.bg, kf.ba = bg.copy(), ba.copy()
        kf.pre_kf = None if i == 0 else jimu.Preintegrated(
            *[a.copy() for a in pre])
    m.imu_initialized = initialized
    m.imu_ba1 = m.imu_ba2 = initialized
    m.imu_bg, m.imu_ba = bg.copy(), ba.copy()


@pytest.mark.parametrize("old_initialized", [False, True],
                         ids=["moved_only", "both"])
def test_merge_maps_inertial_as_jax(old_initialized):
    """Both packages weld map B (IMU-initialized) into map A (initialized
    or not) through the same Sim3: each moved keyframe's prev_kf shifted
    by the keyframe offset and its velocity rotated and scaled, the
    preintegrations unchanged, the flags cleared when only the moved map
    was initialized, the moved map's biases adopted, and the welding BA
    called (with the welded keyframe pair) only on an initialized map."""
    jatlas, _gt = two_map_atlas()
    rng = np.random.default_rng(3)
    _imu_flag(jatlas.maps[1], True, rng,
              np.array([0.004, -0.003, 0.002], np.float32),
              np.array([0.03, -0.02, 0.04], np.float32))
    _imu_flag(jatlas.maps[0], old_initialized, rng,
              np.array([0.001, 0.002, -0.001], np.float32),
              np.array([-0.01, 0.01, 0.02], np.float32))
    atlas = tatlas.Atlas(desc_dim=64)
    atlas.maps = {mid: port_copy(m) for mid, m in jatlas.maps.items()}
    for mid, m in atlas.maps.items():
        for k, kf in m.keyframes.items():
            pre = jatlas.maps[mid].keyframes[k].pre_kf
            kf.pre_kf = None if pre is None else timu.Preintegrated(
                *copy.deepcopy(pre))
    atlas.active_id = jatlas.active_id
    ang = np.array([0.02, -0.05, 0.1])
    th = np.linalg.norm(ang)
    Kx = np.array([[0, -ang[2], ang[1]], [ang[2], 0, -ang[0]],
                   [-ang[1], ang[0], 0]]) / th
    R12 = (np.eye(3) + np.sin(th) * Kx
           + (1 - np.cos(th)) * Kx @ Kx).astype(np.float32)
    t12 = np.array([0.1, -0.05, 0.2], np.float32)
    s12 = 1.1
    vel_before = {k: kf.vel.copy()
                  for k, kf in jatlas.maps[1].keyframes.items()}
    welds = {}
    for name, at, lc_cls, cam, kw in (
            ("jax", jatlas, jlc.LoopClosing, JCAM, {}),
            ("port", atlas, tlc.LoopClosing, CAM, dict(device="cpu"))):
        lc = lc_cls(at.maps[1], cam, fix_scale=False, run_gba=False,
                    atlas=at, **kw)
        welds[name] = []
        lc.welding_iba = lambda kid, ck, _w=welds[name]: _w.append((kid, ck))
        off = lc.merge_maps(at.maps[1], at.maps[0], 13, 0, s12, R12, t12)
        assert off == 7 and lc.map is at.maps[0]
    # the port hands the welding BA the matched keyframe (0); JAX hands it
    # the last culled keyframe of the dissolved map (6): its loop over
    # m_new.culled reuses the name ckid (JAX loop_closing.py:1021)
    assert welds["port"] == ([(20, 0)] if old_initialized else [])
    assert welds["jax"] == ([(20, 6)] if old_initialized else [])
    jm, tm = jatlas.maps[0], atlas.maps[0]
    assert sorted(tm.keyframes) == sorted(jm.keyframes)
    for flag in ("imu_initialized", "imu_ba1", "imu_ba2"):
        assert getattr(tm, flag) == getattr(jm, flag) == old_initialized
    for f in ("imu_bg", "imu_ba"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    np.testing.assert_array_equal(
        tm.imu_bg, np.array([0.004, -0.003, 0.002], np.float32))
    for k, jkf in jm.keyframes.items():
        tkf = tm.keyframes[k]
        assert tkf.prev_kf == jkf.prev_kf
        close(jkf.vel, tkf.vel, 1e-6, f"vel {k}")
        for f in ("bg", "ba"):
            np.testing.assert_array_equal(getattr(tkf, f), getattr(jkf, f))
        assert (tkf.pre_kf is None) == (jkf.pre_kf is None)
        if jkf.pre_kf is not None:
            for a, b in zip(tkf.pre_kf, jkf.pre_kf):
                np.testing.assert_array_equal(a, b)
    # the moved keyframes: chain shifted by the offset, velocity by the
    # weld's inverse Sim3 (not the identity)
    for k in range(7, 14):
        assert tm.keyframes[k + 7].prev_kf == (k + 6 if k > 7 else -1)
        assert not np.allclose(tm.keyframes[k + 7].vel, vel_before[k])


# -- the monocular IMU initialization and the scale refinement -------------------

def mono_chain(mod, pre_cls, traj, pres, scale):
    """A 12-keyframe monocular map of ``make_imu_trajectory``'s chain, its
    visual poses at ``scale`` of the truth (no landmarks: the full-chain BA
    finds nothing to refine)."""
    m = mod.SlamMap(desc_dim=64)
    for k in range(len(traj["t_kf"])):
        R_cw, t_cw = tin.np_body_to_cam(
            traj["R_wb"][k], (scale * traj["p_wb"][k]).astype(np.float32),
            I3, Z3)
        z = np.zeros(4, np.float32)
        kf = mod.KeyFrame(kid=k, frame_id=k, timestamp=float(traj["t_kf"][k]),
                          kpts_un=np.zeros((4, 2), np.float32),
                          desc=np.zeros((4, 64), np.float32),
                          valid=np.zeros(4, bool), ur=z - 1.0, depth=z,
                          R=R_cw, t=t_cw)
        kf.prev_kf = k - 1
        if k:
            kf.pre_kf = pre_cls(*[np.array(f) for f in pres[k - 1]])
        m.keyframes[k] = kf
        m.covis.setdefault(k, {})
        if m.kf_origin is None:
            m.kf_origin = k
    return m


def assert_maps_close(jm, tm):
    for k, jkf in jm.keyframes.items():
        tkf = tm.keyframes[k]
        close(jkf.R, tkf.R, 1e-4, f"R {k}")
        close(jkf.t, tkf.t, 1e-4, f"t {k}")
        if jkf.vel is None:
            assert tkf.vel is None
        else:
            close(jkf.vel, tkf.vel, 1e-4, f"vel {k}")
        close(jkf.bg, tkf.bg, 1e-5, f"bg {k}")
        close(jkf.ba, tkf.ba, 1e-5, f"ba {k}")
    close(jm.imu_bg, tm.imu_bg, 1e-5, "imu_bg")
    close(jm.imu_ba, tm.imu_ba, 1e-5, "imu_ba")
    assert tm.imu_initialized == jm.imu_initialized


def assert_last_solve_close(jl, tl):
    (js, jsc, jR, jc, jn), (ts, tsc, tR, tc, tn) = (jl.init_debug[-1],
                                                    tl.init_debug[-1])
    assert (ts, tn) == (js, jn)
    assert abs(tsc - jsc) <= 1e-4 * jsc
    g = np.array([0.0, 0.0, -9.81])
    g_j, g_t = jR @ g, tR @ g
    cos = g_j @ g_t / (np.linalg.norm(g_j) * np.linalg.norm(g_t))
    assert np.arccos(min(1.0, cos)) < 1e-4


def test_mono_initialization_and_scale_refinement_against_jax():
    """A monocular map's schedule on one chain in both packages: the first
    initialization finds the scale (2.5 within 2%, as TestInertialInit's
    bar) and gravity with the scale free; after a 3% scale drift the
    refinement pulls the scale back with the biases untouched and its
    transform composed into the one tracking has not consumed; a third
    solve, below the apply threshold, changes nothing."""
    traj = make_imu_trajectory(n_kf=12)
    pres = preintegrate_segments(traj)
    jm = mono_chain(jmap, jimu.Preintegrated, traj, pres, 1 / 2.5)
    tm = mono_chain(tmap, timu.Preintegrated, traj, pres, 1 / 2.5)
    jl, tl = mappings(jm, tm)
    assert (tl.imu_init_time, tl.imu_min_kfs) == (jl.imu_init_time,
                                                  jl.imu_min_kfs) == (2.0, 10)
    chain = tl._kf_chain(11)
    assert chain == jl._kf_chain(11) == list(range(12))
    # the first initialization, as _imu_step calls it on a monocular map
    for lm in (jl, tl):
        assert lm._initialize_imu(chain, prior_g=1e2, prior_a=1e6)
    assert_last_solve_close(jl, tl)
    assert abs(tl.init_debug[-1][1] - 2.5) / 2.5 < 0.02
    assert_maps_close(jm, tm)
    bias = (tm.imu_bg.copy(), tm.imu_ba.copy(),
            {k: (kf.bg.copy(), kf.ba.copy()) for k, kf in tm.keyframes.items()})
    # the map drifts 3% in scale; the refinement
    for m in (jm, tm):
        m.apply_scaled_rotation(I3, 1.03)
    for lm in (jl, tl):
        assert lm._initialize_imu(chain, prior_g=1e8, prior_a=1e8,
                                  fiba=False, min_apply=0.005,
                                  update_bias=False)
    assert_last_solve_close(jl, tl)
    assert abs(tl.init_debug[-1][1] * 1.03 - 1.0) < 0.01
    assert_maps_close(jm, tm)
    np.testing.assert_array_equal(tm.imu_bg, bias[0])
    np.testing.assert_array_equal(tm.imu_ba, bias[1])
    for k, (bg, ba) in bias[2].items():
        np.testing.assert_array_equal(tm.keyframes[k].bg, bg)
        np.testing.assert_array_equal(tm.keyframes[k].ba, ba)
    (js, jR), (ts, tR) = jl.pending_map_transform, tl.pending_map_transform
    assert abs(ts - js) <= 1e-4 * js
    close(jR, tR, 1e-4, "pending R_wg")
    # converged: below min_apply and the tilt gate, nothing moves
    before = {k: (kf.R.copy(), kf.t.copy()) for k, kf in tm.keyframes.items()}
    chg = tm.change_index
    for lm in (jl, tl):
        assert lm._initialize_imu(chain, prior_g=1e8, prior_a=1e8,
                                  fiba=False, min_apply=0.005,
                                  update_bias=False)
    assert_last_solve_close(jl, tl)
    assert abs(tl.init_debug[-1][1] - 1.0) < 0.005
    assert tm.change_index == chg
    for k, (R, t) in before.items():
        np.testing.assert_array_equal(tm.keyframes[k].R, R)
        np.testing.assert_array_equal(tm.keyframes[k].t, t)
    assert len(tl.init_debug) == len(jl.init_debug) == 3

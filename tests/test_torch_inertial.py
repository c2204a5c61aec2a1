"""The PyTorch port's inertial optimizers (``optim/inertial.py``,
``optim/viba.py``) against the JAX package on the inputs of
``tests/test_inertial.py``: ``inertial_init`` with a free and a fixed scale
(``TestInertialInit``), both visual-inertial pose LMs
(``TestPoseInertial``, ``TestFramePriorChaining``),
``local_inertial_ba_states`` (``TestLocalInertialBA``) and the joint
``local_inertial_ba`` on a window whose landmarks two keyframes see. Each
is held to the JAX function at the stated tolerances and to the JAX test's
own bar, and ``TestFullInertialBA`` is mirrored on the port's
``LocalMapping``. Where a float32 accept-or-reject decision of an LM differs
from JAX's, the test says where, and that value is held to the JAX test's
bar."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.ops import imu as jimu  # noqa: E402
from xfeatslam_tpu.ops.camera import Pinhole as JPinhole  # noqa: E402
from xfeatslam_tpu.optim import inertial as jin  # noqa: E402
from xfeatslam_tpu.optim import viba as jviba  # noqa: E402
from xfeatslam_tpu.utils.synthetic import make_imu_trajectory  # noqa: E402
from xfeatslam_tpu_torch.ops import imu as timu  # noqa: E402
from xfeatslam_tpu_torch.ops.camera import Pinhole  # noqa: E402
from xfeatslam_tpu_torch.optim import inertial as tin  # noqa: E402
from xfeatslam_tpu_torch.optim import viba as tviba  # noqa: E402

JCAM = JPinhole.from_list([517.3, 516.5, 318.6, 255.3])
CAM = Pinhole.from_list([517.3, 516.5, 318.6, 255.3])
I3 = np.eye(3, dtype=np.float32)
CHAIN = ("dts", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "cov9")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a))


def preintegrate_segments(traj):
    """tests/test_inertial.py's preintegrations (JAX), as numpy."""
    pres = []
    for seg in traj["imu"]:
        n = len(seg["acc"])
        pres.append(jimu.Preintegrated(*(np.asarray(f) for f in
                                         jimu.preintegrate(
            jnp.asarray(seg["acc"]), jnp.asarray(seg["gyro"]),
            jnp.asarray(seg["dts"]), jnp.ones(n, bool), jnp.zeros(3),
            jnp.zeros(3), noise_gyro=1e-3, noise_acc=1e-2))))
    return pres


def stack_pres(pres):
    out = {n: np.stack([getattr(p, n) for p in pres]) for n in
           ("JRg", "JVg", "JVa", "JPg", "JPa", "dR", "dV", "dP")}
    out["dts"] = np.stack([p.dt for p in pres])
    out["cov9"] = np.stack([p.cov[:9, :9] for p in pres])
    out["walk_cov"] = np.stack([p.cov[9:, 9:] for p in pres])
    return out


def visual_edges(rng, R_wb, p_wb, n=200, noise=0.3):
    """tests/test_inertial.py's landmarks in front of the camera and their
    noisy projections (R_bc = I)."""
    R_cw, t_cw = tin.np_body_to_cam(R_wb, p_wb, I3, np.zeros(3, np.float32))
    C = -R_cw.T @ t_cw
    dirs = rng.standard_normal((n, 3))
    dirs[:, 2] = np.abs(dirs[:, 2]) + 1.5
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    Xc = dirs * rng.uniform(2.0, 6.0, n)[:, None]
    Xw = Xc @ R_cw + C
    uv = np.stack([517.3 * Xc[:, 0] / Xc[:, 2] + 318.6,
                   516.5 * Xc[:, 1] / Xc[:, 2] + 255.3], -1) \
        + noise * rng.standard_normal((n, 2))
    return Xw.astype(np.float32), uv.astype(np.float32)


def close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), atol=tol,
                               err_msg=what)


# -- inertial_init ---------------------------------------------------------

@pytest.mark.parametrize("fix_scale", [False, True])
def test_inertial_init_against_jax(fix_scale):
    """TestInertialInit's two problems: the free-scale one (visual poses
    shrunk 2.5x, the 21-candidate log-scale seed grid) and the fixed-scale
    one with injected biases. Scale within 1e-4 relative, gravity direction
    within 1e-4 rad, biases within 1e-5, velocities within 1e-4 m/s, and
    the JAX test's bars.

    On the fixed-scale problem one float32 accept-or-reject decision
    differs: at LM iteration 10 of 60 JAX's step lowers the cost from
    1.2944733 to 1.2944700 and is kept, the port's (from 1.2944702) raises
    it to 1.2944800 and is rejected, and the two walks end 3.7e-5 apart in
    the weakly observed acc bias (prior_a = 1e2). There the acc bias is
    held to the JAX test's own bar (3e-2 from the truth) and both final
    costs to 1e-5 of each other."""
    if fix_scale:
        bg_t = np.array([0.02, -0.015, 0.01], np.float32)
        ba_t = np.array([0.05, 0.08, -0.06], np.float32)
        traj = make_imu_trajectory(n_kf=16, bg=bg_t, ba=ba_t)
        p_vis, kw = traj["p_wb"], dict(prior_a=1e2, fix_scale=True)
    else:
        traj = make_imu_trajectory(n_kf=16)
        p_vis, kw = traj["p_wb"] / 2.5, {}
    st = stack_pres(preintegrate_segments(traj))
    args = [traj["R_wb"], p_vis] + [st[k] for k in CHAIN] + [
        np.ones(15, bool)]
    j = jin.inertial_init(*(jnp.asarray(a) for a in args), **kw)
    t = tin.inertial_init(*(T(a) for a in args), **kw)
    s_j, s_t = float(j.scale), float(t.scale)
    assert abs(s_t - s_j) <= 1e-4 * s_j
    g = np.array([0, 0, -9.81])
    g_j, g_t = np.asarray(j.R_wg) @ g, t.R_wg.numpy() @ g
    cos = g_j @ g_t / (np.linalg.norm(g_j) * np.linalg.norm(g_t))
    assert np.arccos(min(1.0, cos)) < 1e-4
    close(j.bg, t.bg, 1e-5, "bg")
    if not fix_scale:
        close(j.ba, t.ba, 1e-5, "ba")
    close(j.vel, t.vel, 1e-4, "vel")
    if fix_scale:
        assert abs(float(t.cost) - float(j.cost)) <= 1e-5 * float(j.cost)
        np.testing.assert_allclose(t.bg.numpy(), bg_t, atol=3e-3)
        np.testing.assert_allclose(t.ba.numpy(), ba_t, atol=3e-2)
    else:
        assert abs(s_t - 2.5) / 2.5 < 0.02
        cos = g_t @ traj["g_w"] / (np.linalg.norm(g_t) * 9.81)
        assert cos > 0.999
        assert np.linalg.norm(t.vel.numpy() - traj["v_w"], axis=-1).max() \
            < 0.05


# -- the pose LMs --------------------------------------------------------------

def _visual_args(Xw, uv):
    n = len(Xw)
    return (Xw, uv, np.zeros(n, np.float32), np.ones(n, np.float32),
            np.zeros(n, bool), np.ones(n, bool))


def _pose_both(states, pre, Xw, uv, g, last_frame=False):
    """One pose LM through both packages on the same numpy inputs."""
    vis = _visual_args(Xw, uv)
    jfn = (jin.pose_inertial_optimization_last_frame if last_frame
           else jin.pose_inertial_optimization)
    tfn = (tin.pose_inertial_optimization_last_frame if last_frame
           else tin.pose_inertial_optimization)
    j = jfn(*(jnp.asarray(a) for a in states),
            jimu.Preintegrated(*(jnp.asarray(f) for f in pre)),
            *(jnp.asarray(a) for a in vis), JCAM, jnp.float32(0.0),
            jnp.asarray(I3), jnp.zeros(3), gravity=jnp.asarray(g))
    t = tfn(*(T(a) for a in states), timu.Preintegrated(*(T(f) for f in pre)),
            *(T(a) for a in vis), CAM, 0.0, T(I3), torch.zeros(3),
            gravity=T(g))
    return j, t


def _assert_pose_close(j, t, biases: bool = True):
    fields = ("R_wb", "p_wb", "v_w") + (("bg", "ba") if biases else ())
    for f in fields:
        close(getattr(j, f), getattr(t, f), 1e-4, f)
    inl_j, inl_t = np.asarray(j.inliers), t.inliers.numpy()
    assert (inl_j == inl_t).mean() >= 0.99
    Hj = np.asarray(j.H, np.float64)
    assert np.abs(t.H.numpy() - Hj).max() <= 1e-4 * np.abs(Hj).max()


def test_pose_inertial_optimization_against_jax():
    """TestPoseInertial: the anchor KF1 fixed, KF2 from its perturbed IMU
    prediction and 200 noisy projections."""
    rng = np.random.default_rng(0)
    traj = make_imu_trajectory(n_kf=3)
    pre = preintegrate_segments(traj)[1]
    Xw, uv = visual_edges(rng, traj["R_wb"][2], traj["p_wb"][2])
    Rp, pp, vp = (np.asarray(x) for x in jimu.predict_state(
        jnp.asarray(traj["R_wb"][1]), jnp.asarray(traj["p_wb"][1]),
        jnp.asarray(traj["v_w"][1]),
        jimu.Preintegrated(*(jnp.asarray(f) for f in pre)),
        gravity=jnp.asarray(traj["g_w"])))
    pp = (pp + np.array([0.05, -0.03, 0.04])).astype(np.float32)
    z = np.zeros(3, np.float32)
    states = (Rp, pp, vp, z, z, traj["R_wb"][1], traj["p_wb"][1],
              traj["v_w"][1])
    j, t = _pose_both(states, pre, Xw, uv, traj["g_w"])
    _assert_pose_close(j, t)
    assert np.linalg.norm(t.p_wb.numpy() - traj["p_wb"][2]) < 0.01
    # the flat form the card's graph captures: the same solve
    flat = tin.pose_inertial_flat(
        *(T(a) for a in states), *(T(f) for f in pre),
        *(T(a) for a in _visual_args(Xw, uv)), T(I3), torch.zeros(3),
        cam=CAM, bf=0.0)
    t0 = tin.pose_inertial_optimization(
        *(T(a) for a in states), timu.Preintegrated(*(T(f) for f in pre)),
        *(T(a) for a in _visual_args(Xw, uv)), CAM, 0.0, T(I3),
        torch.zeros(3))
    for a, b in zip(flat, t0):
        assert torch.equal(a, b)
    assert np.linalg.norm(t.v_w.numpy() - traj["v_w"][2]) < 0.1
    assert int(t.num_inliers) > 150


def test_frame_prior_chain_against_jax():
    """TestFramePriorChaining's 2-s keyframe-less stretch (noisy IMU, 20
    weak projections a frame), run by the port: the first frame anchored
    to the keyframe, then the LastFrame variant chaining marginalized
    posteriors. Each chained solve is held to the JAX function on the
    port's own inputs (R, t and v within 1e-4, the inlier flags), and the
    chain must beat re-anchoring every frame to the keyframe (the JAX
    test's bar).

    The biases are held to that bar alone: in the flat end of these LMs
    (cost changes ~1e-5 relative) float32 accept-or-reject decisions
    differ from JAX's, e.g. in the second chained solve at iteration 4 JAX
    rejects a step from 29.293673 to 29.293755 while the port accepts one
    from 29.293808 to 29.293352, and with the weak gyro observability
    (noise 0.004) the gyro bias ends up to 1.3e-4 apart."""
    rng = np.random.default_rng(0)
    n = 9
    traj = make_imu_trajectory(n_kf=n, seed=3, noise_gyro=0.004,
                               noise_acc=0.06)
    pres = preintegrate_segments(traj)
    obs = [visual_edges(rng, traj["R_wb"][k], traj["p_wb"][k], n=20,
                        noise=1.0) for k in range(1, n)]
    g = traj["g_w"]
    z = np.zeros(3, np.float32)
    tg = T(g)
    R0, p0, v0 = traj["R_wb"][0], traj["p_wb"][0], traj["v_w"][0]

    def predict(R, p, v, pre):
        return (x.numpy() for x in timu.predict_state(
            T(R), T(p), T(v), timu.Preintegrated(*(T(f) for f in pre)),
            gravity=tg))

    # (a) every frame anchored to the keyframe through one long edge
    errs_kf = []
    pre_acc = pres[0]
    for k in range(1, n):
        Rp, pp, vp = predict(R0, p0, v0, pre_acc)
        t = tin.pose_inertial_optimization(
            *(T(a) for a in (Rp, pp, vp, z, z, R0, p0, v0)),
            timu.Preintegrated(*(T(f) for f in pre_acc)),
            *(T(a) for a in _visual_args(*obs[k - 1])), CAM, 0.0, T(I3),
            torch.zeros(3), gravity=tg)
        errs_kf.append(np.linalg.norm(t.p_wb.numpy() - traj["p_wb"][k]))
        if k < n - 1:
            pre_acc = timu.to_numpy(timu.merge_previous(
                *(timu.Preintegrated(*(T(f) for f in p))
                  for p in (pre_acc, pres[k]))))
    # (b) the chain of marginalized posteriors
    Rp, pp, vp = predict(R0, p0, v0, pres[0])
    _, t = _pose_both((Rp, pp, vp, z, z, R0, p0, v0), pres[0], *obs[0], g)
    errs_chain = [np.linalg.norm(t.p_wb.numpy() - traj["p_wb"][1])]
    for k in range(2, n):
        H = t.H.numpy().astype(np.float64)
        L = np.linalg.cholesky(0.5 * (H + H.T) + 1e-4 * np.eye(15)).astype(
            np.float32)
        Ri, pi, vi, bgi, bai = (getattr(t, f).numpy() for f in
                                ("R_wb", "p_wb", "v_w", "bg", "ba"))
        Rp, pp, vp = predict(Ri, pi, vi, pres[k - 1])
        j, t = _pose_both((Rp, pp, vp, bgi, bai, Ri, pi, vi, bgi, bai, L),
                          pres[k - 1], *obs[k - 1], g, last_frame=True)
        _assert_pose_close(j, t, biases=False)
        errs_chain.append(np.linalg.norm(t.p_wb.numpy() - traj["p_wb"][k]))
    assert np.mean(errs_chain[-3:]) < np.mean(errs_kf[-3:]), (errs_chain,
                                                              errs_kf)


# -- the inertial BA -------------------------------------------------------

def _window(rng, K=6):
    """TestLocalInertialBA's window: 6 keyframes, all but the anchor
    perturbed (4 cm, 0.1 m/s), 120 projections each."""
    traj = make_imu_trajectory(n_kf=K)
    st = stack_pres(preintegrate_segments(traj))
    free = (np.arange(K) > 0)[:, None]
    p_pert = (traj["p_wb"] + np.where(
        free, 0.04 * rng.standard_normal((K, 3)).astype(np.float32), 0)
    ).astype(np.float32)
    v_pert = (traj["v_w"] + np.where(
        free, 0.1 * rng.standard_normal((K, 3)).astype(np.float32), 0)
    ).astype(np.float32)
    return traj, st, p_pert, v_pert


def test_local_inertial_ba_states_against_jax():
    rng = np.random.default_rng(0)
    K = 6
    traj, st, p_pert, v_pert = _window(rng, K)
    obs_cam, Xw, uv = [], [], []
    for k in range(K):
        Xk, uvk = visual_edges(rng, traj["R_wb"][k], traj["p_wb"][k], n=120)
        obs_cam.extend([k] * len(Xk))
        Xw.append(Xk)
        uv.append(uvk)
    Xw, uv = np.concatenate(Xw), np.concatenate(uv)
    O = len(Xw)
    fixed = np.arange(K) == 0
    z = np.zeros((K, 3), np.float32)
    args = ([traj["R_wb"], p_pert, v_pert, z, z, fixed]
            + [st[k] for k in CHAIN] + [st["walk_cov"], np.ones(K - 1, bool),
                                        np.asarray(obs_cam, np.int32), Xw, uv,
                                        np.zeros(O, np.float32),
                                        np.ones(O, np.float32),
                                        np.zeros(O, bool), np.ones(O, bool)])
    j = jin.local_inertial_ba_states(
        *(jnp.asarray(a) for a in args), JCAM, jnp.float32(0.0),
        jnp.asarray(I3), jnp.zeros(3), gravity=jnp.asarray(traj["g_w"]))
    t = tin.local_inertial_ba_states(*(T(a) for a in args), CAM, 0.0, T(I3),
                                     torch.zeros(3), gravity=T(traj["g_w"]))
    for a, b, name in zip(j, t, ("R", "p", "v", "bg", "ba")):
        close(a, b, 1e-4, name)
    err_before = np.linalg.norm(p_pert - traj["p_wb"], axis=-1)
    err_after = np.linalg.norm(t[1].numpy() - traj["p_wb"], axis=-1)
    assert err_after.max() < 0.25 * err_before.max()
    assert np.linalg.norm(t[2].numpy() - traj["v_w"], axis=-1).max() < 0.1


def viba_problem(rng, K=6, K_pad=8):
    """A joint problem: TestLocalInertialBA's perturbed window (padded to
    K_pad states) and landmark banks that consecutive keyframes share
    (each landmark seen twice), the landmarks perturbed 2 cm."""
    traj, st, p_pert, v_pert = _window(rng, K)
    obs_cam, obs_pt, uv, X = [], [], [], []
    for k in range(K - 1):
        Xb, _ = visual_edges(rng, traj["R_wb"][k], traj["p_wb"][k], n=60,
                             noise=0.0)
        for kk in (k, k + 1):
            R_cw, t_cw = tin.np_body_to_cam(traj["R_wb"][kk],
                                            traj["p_wb"][kk], I3,
                                            np.zeros(3, np.float32))
            Xc = Xb @ R_cw.T + t_cw
            u = np.stack([517.3 * Xc[:, 0] / Xc[:, 2] + 318.6,
                          516.5 * Xc[:, 1] / Xc[:, 2] + 255.3], -1)
            uv.append(u + 0.3 * rng.standard_normal(u.shape))
            obs_cam.extend([kk] * len(Xb))
            obs_pt.extend(range(k * 60, k * 60 + 60))
        X.append(Xb)
    X = np.concatenate(X)
    P, O = len(X), len(obs_cam)
    E = K_pad - 1

    def pad(a, n, fill=0.0):
        a = np.asarray(a)
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[:len(a)] = a
        return out

    def whiten(c, eps):
        info = np.linalg.inv(c.astype(np.float64) + eps * np.eye(len(c)))
        return np.linalg.cholesky(0.5 * (info + info.T)).astype(np.float32)

    eye3 = np.tile(I3, (K_pad, 1, 1))
    prob = dict(
        R_wb=np.concatenate([traj["R_wb"], eye3[K:]]),
        p_wb=pad(p_pert, K_pad), v_w=pad(v_pert, K_pad),
        bg=np.zeros((K_pad, 3), np.float32),
        ba=np.zeros((K_pad, 3), np.float32),
        fixed=np.arange(K_pad) == 0, state_valid=np.arange(K_pad) < K,
        X=(X + 0.02 * rng.standard_normal(X.shape)).astype(np.float32),
        p_valid=np.ones(P, bool), obs_cam=np.asarray(obs_cam, np.int32),
        obs_pt=np.asarray(obs_pt, np.int32),
        uv=np.concatenate(uv).astype(np.float32),
        ur=np.zeros(O, np.float32), stereo=np.zeros(O, bool),
        valid=np.ones(O, bool), inv_sigma2=np.ones(O, np.float32),
        dts=pad(st["dts"], E), dR=np.concatenate([st["dR"], eye3[K:]]),
        dV=pad(st["dV"], E), dP=pad(st["dP"], E),
        L9=pad(np.stack([whiten(c, 1e-12) for c in st["cov9"]]), E),
        Lb=pad(np.stack([whiten(c, 1e-10) for c in st["walk_cov"]]), E),
        e_valid=np.arange(E) < K - 1,
        **{n: pad(st[n], E) for n in ("JRg", "JVg", "JVa", "JPg", "JPa")})
    return traj, prob


def test_local_inertial_ba_against_jax():
    """The joint solve: states within 1e-4, landmarks within 2e-3 m, the
    inlier flags equal, and the window pulled back toward the truth."""
    traj, prob = viba_problem(np.random.default_rng(0))
    g = traj["g_w"]
    j = jviba.local_inertial_ba(
        jviba.VIBAProblem(**{k: jnp.asarray(v) for k, v in prob.items()}),
        JCAM, jnp.asarray(I3), jnp.zeros(3), jnp.float32(0.0),
        gravity=jnp.asarray(g))
    t = tviba.local_inertial_ba(
        tviba.VIBAProblem(**{k: T(v) for k, v in prob.items()}), CAM, T(I3),
        torch.zeros(3), 0.0, gravity=T(g))
    for f in ("R_wb", "p_wb", "v_w", "bg", "ba"):
        close(getattr(j, f), getattr(t, f), 1e-4, f)
    close(j.X, t.X, 2e-3, "X")
    assert (np.asarray(j.inlier) == t.inlier.numpy()).all()
    K = 6
    err0 = np.linalg.norm(prob["p_wb"][:K] - traj["p_wb"], axis=-1).max()
    err1 = np.linalg.norm(t.p_wb.numpy()[:K] - traj["p_wb"], axis=-1).max()
    assert err1 < 0.5 * err0, (err0, err1)


def test_full_inertial_ba_on_the_port_local_mapping():
    """TestFullInertialBA on the port's ``LocalMapping``: a 40-keyframe
    chain with a uniform 2% visual scale error (landmark banks that
    consecutive keyframes share, the preintegrations the port's own); the
    whole-chain solve (FullInertialBA) must pull the old section onto the
    IMU while the 16-keyframe window freezes its scale error (the JAX
    test's bars)."""
    from xfeatslam_tpu_torch.slam.local_mapping import (IBA_MAX_KFS_TOTAL,
                                                        LocalMapping)
    from xfeatslam_tpu_torch.slam.map import KeyFrame, SlamMap

    rng = np.random.default_rng(0)
    n_kf = 40
    traj = make_imu_trajectory(n_kf=n_kf, g_dir=np.array([0, 0, -1.0]))
    pres = [timu.to_numpy(timu.preintegrate(
        T(seg["acc"]), T(seg["gyro"]), T(seg["dts"]),
        torch.ones(len(seg["acc"]), dtype=torch.bool), torch.zeros(3),
        torch.zeros(3), noise_gyro=1e-3, noise_acc=1e-2))
        for seg in traj["imu"]]
    s = 1.02
    banks = [visual_edges(rng, traj["R_wb"][k], traj["p_wb"][k], n=60,
                          noise=0.0)[0] for k in range(n_kf - 1)]

    def project(Xw, R_wb, p_wb):
        R_cw, t_cw = tin.np_body_to_cam(R_wb, p_wb, I3,
                                        np.zeros(3, np.float32))
        Xc = Xw @ R_cw.T + t_cw
        z = np.maximum(Xc[:, 2], 1e-6)
        return np.stack([517.3 * Xc[:, 0] / z + 318.6,
                         516.5 * Xc[:, 1] / z + 255.3], -1), Xc[:, 2] > 0.2

    def build_map():
        m = SlamMap(desc_dim=64)
        m.imu_initialized = True
        K_slots = 128
        mp_of = {}
        for k in range(n_kf):
            obs_uv, obs_key = [], []
            for b in ([k - 1] if k > 0 else []) + (
                    [k] if k < n_kf - 1 else []):
                uv, vis = project(banks[b], traj["R_wb"][k], traj["p_wb"][k])
                for j in np.nonzero(vis)[0]:
                    if len(obs_uv) >= K_slots:
                        break
                    obs_uv.append(uv[j])
                    obs_key.append((b, int(j)))
            kpts = np.zeros((K_slots, 2), np.float32)
            valid = np.zeros(K_slots, bool)
            kpts[: len(obs_uv)] = np.asarray(obs_uv, np.float32)
            valid[: len(obs_uv)] = True
            R_cw, t_cw = tin.np_body_to_cam(
                traj["R_wb"][k], (s * traj["p_wb"][k]).astype(np.float32),
                I3, np.zeros(3, np.float32))
            kf = KeyFrame(kid=k, frame_id=k, timestamp=float(traj["t_kf"][k]),
                          kpts_un=kpts, desc=np.zeros((K_slots, 64),
                                                      np.float32),
                          valid=valid, ur=np.full(K_slots, -1.0, np.float32),
                          depth=np.zeros(K_slots, np.float32), R=R_cw, t=t_cw)
            kf.prev_kf = k - 1
            if k > 0:
                kf.pre_kf = pres[k - 1]
            kf.vel = (s * traj["v_w"][k]).astype(np.float32)
            m.keyframes[k] = kf
            m.covis.setdefault(k, {})
            if m.kf_origin is None:
                m.kf_origin = k
            for slot, key in enumerate(obs_key):
                if key not in mp_of:
                    mp_of[key] = m.create_point(
                        (s * banks[key[0]][key[1]]).astype(np.float32),
                        np.zeros(64, np.float32), k)
                m.add_observation(mp_of[key], k, slot, update_links=False)
            m.update_connections(k)
        return m

    calib = timu.ImuCalib(noise_gyro=1e-3, noise_acc=1e-2, walk_gyro=1e-6,
                          walk_acc=1e-5, R_bc=I3, t_bc=np.zeros(3, np.float32))

    def max_err(m, kids):
        """The old section's worst position error after a rigid alignment
        of the whole chain to the truth (R_bc = I: center = body)."""
        est = np.stack([m.keyframes[k].center() for k in range(n_kf)])
        gtp = traj["p_wb"][:n_kf]
        mu_e, mu_g = est.mean(0), gtp.mean(0)
        U, _S, Vt = np.linalg.svd((gtp - mu_g).T @ (est - mu_e))
        D = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            D[2, 2] = -1
        al = (est - mu_e) @ (U @ D @ Vt).T + mu_g
        return max(np.linalg.norm(al[k] - gtp[k]) for k in kids)

    old = range(0, n_kf - IBA_MAX_KFS_TOTAL)
    m_full = build_map()
    LocalMapping(m_full, CAM, 0.0, "cpu", imu_calib=calib)._local_inertial_ba(
        n_kf - 1, fix_anchor=False, full_chain=True)
    m_win = build_map()
    LocalMapping(m_win, CAM, 0.0, "cpu", imu_calib=calib)._local_inertial_ba(
        n_kf - 1, window=IBA_MAX_KFS_TOTAL, fix_anchor=False)
    err0 = (s - 1.0) * np.abs(traj["p_wb"][: n_kf - 16]).max()
    full_old, win_old = max_err(m_full, old), max_err(m_win, old)
    assert win_old > 0.5 * err0, (win_old, err0)
    assert full_old < 0.4 * win_old, (full_old, win_old)

"""The PyTorch port's IMU preintegration (``ops/imu.py``) and its
visual-inertial generators (``utils/synthetic.make_vi_sequence`` and
``make_imu_trajectory``) against the JAX package.

The first seven tests mirror ``tests/test_imu.py`` on the port (the same
simulated trajectories, the same bars). The rest feed the same inputs to
both packages: ``preintegrate`` on windows of 5, 20 and 33 samples with
padding (deltas and Jacobians within 1e-5, the covariance within 1e-5 of
its largest entry), ``preintegrate_segment``'s buckets, ``relinearize``,
``merge_previous``, ``delta_with_bias``, ``predict_state`` and
``inertial_residual`` at the same bars, and both generators bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.ops import imu as jimu  # noqa: E402
from xfeatslam_tpu.utils import synthetic as jsyn  # noqa: E402
from xfeatslam_tpu_torch.ops import imu  # noqa: E402
from xfeatslam_tpu_torch.ops import lie  # noqa: E402
from xfeatslam_tpu_torch.utils import synthetic as tsyn  # noqa: E402

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def simulate(n=200, dt=0.005, bg=None, ba=None):
    """tests/test_imu.py's smooth trajectory with perfect measurements (the
    rotation integrated by the port's so3_exp)."""
    bg = np.zeros(3, np.float32) if bg is None else bg
    ba = np.zeros(3, np.float32) if ba is None else ba
    g = np.array([0.0, 0.0, -9.81])
    R = np.eye(3)
    p = np.zeros(3)
    v = np.array([0.3, 0.1, 0.0])
    accs, gyros = [], []
    Rs, ps, vs = [R.copy()], [p.copy()], [v.copy()]
    for k in range(n):
        t = k * dt
        w_world = np.array([0.2 * np.sin(t), 0.3, 0.1 * np.cos(t)])
        a_world = np.array([0.5 * np.cos(2 * t), -0.2, 0.4 * np.sin(t)])
        w_body = R.T @ w_world
        a_body = R.T @ (a_world - g)
        accs.append(a_body + ba)
        gyros.append(w_body + bg)
        p = p + v * dt + 0.5 * a_world * dt * dt
        v = v + a_world * dt
        R = R @ lie.so3_exp(torch.from_numpy(
            (w_body * dt).astype(np.float32))).numpy()
        Rs.append(R.copy())
        ps.append(p.copy())
        vs.append(v.copy())
    return (np.array(accs, np.float32), np.array(gyros, np.float32),
            np.full(n, dt, np.float32), Rs, ps, vs)


def integrate(acc, gyro, dts, bg=None, ba=None, **kw):
    n = len(acc)
    z = np.zeros(3, np.float32)
    return imu.preintegrate(T(acc), T(gyro), T(dts),
                            torch.ones(n, dtype=torch.bool),
                            T(z if bg is None else bg),
                            T(z if ba is None else ba), **kw)


def f32(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# -- tests/test_imu.py on the port -------------------------------------------

class TestPreintegration:
    def test_predicts_state(self):
        accs, gyros, dts, Rs, ps, vs = simulate()
        pre = integrate(accs, gyros, dts)
        R_pred, p_pred, v_pred = imu.predict_state(
            torch.eye(3), torch.zeros(3), f32(vs[0]), pre)
        assert np.abs(R_pred.numpy() - Rs[-1]).max() < 1e-3
        assert np.linalg.norm(v_pred.numpy() - vs[-1]) < 1e-2
        assert np.linalg.norm(p_pred.numpy() - ps[-1]) < 1e-2

    def test_padding_mask(self):
        accs, gyros, dts, *_ = simulate(n=100)
        pad = 60
        valid = np.concatenate([np.ones(100, bool), np.zeros(pad, bool)])
        pre_p = imu.preintegrate(
            f32(np.concatenate([accs, np.ones((pad, 3)) * 99])),
            f32(np.concatenate([gyros, np.ones((pad, 3)) * 99])),
            f32(np.concatenate([dts, np.full(pad, 0.005)])), T(valid),
            torch.zeros(3), torch.zeros(3))
        pre = integrate(accs, gyros, dts)
        np.testing.assert_allclose(pre_p.dR.numpy(), pre.dR.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(pre_p.dP.numpy(), pre.dP.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(float(pre_p.dt), float(pre.dt), atol=1e-6)

    def test_bias_jacobians(self):
        bg_t = np.array([0.02, -0.01, 0.015], np.float32)
        ba_t = np.array([0.05, 0.03, -0.04], np.float32)
        accs, gyros, dts, *_ = simulate(bg=bg_t, ba=ba_t)
        pre0 = integrate(accs, gyros, dts)
        dR_c, dV_c, dP_c = imu.delta_with_bias(pre0, T(bg_t), T(ba_t))
        pre1 = integrate(accs, gyros, dts, bg_t, ba_t)
        assert np.abs(dR_c.numpy() - pre1.dR.numpy()).max() < 5e-3
        assert np.linalg.norm(dV_c.numpy() - pre1.dV.numpy()) < 2e-2
        assert np.linalg.norm(dP_c.numpy() - pre1.dP.numpy()) < 2e-2

    def test_residual_zero_at_truth(self):
        accs, gyros, dts, Rs, ps, vs = simulate()
        pre = integrate(accs, gyros, dts)
        r = imu.inertial_residual(torch.eye(3), torch.zeros(3), f32(vs[0]),
                                  f32(Rs[-1]), f32(ps[-1]), f32(vs[-1]),
                                  torch.zeros(3), torch.zeros(3), pre)
        assert np.abs(r.numpy()).max() < 2e-2, r

    def test_covariance_grows(self):
        accs, gyros, dts, *_ = simulate(n=50)
        short = integrate(accs[:10], gyros[:10], dts[:10])
        long_ = integrate(accs, gyros, dts)
        assert float(torch.trace(long_.cov)) > float(torch.trace(short.cov))
        c = long_.cov.numpy()
        np.testing.assert_allclose(c, c.T, atol=1e-10)


class TestMergeAndCovariance:
    def test_cov_is_15x15_with_bias_walk(self):
        N = 50
        acc = np.tile(np.array([0.0, 0.0, 9.81], np.float32), (N, 1))
        gyro = np.zeros((N, 3), np.float32)
        dts = np.full(N, 0.005, np.float32)
        c = integrate(acc, gyro, dts).cov.numpy()
        assert c.shape == (15, 15)
        assert (np.diag(c)[9:] > 0).all()
        c2 = integrate(np.tile(acc, (2, 1)), np.tile(gyro, (2, 1)),
                       np.tile(dts, 2)).cov.numpy()
        np.testing.assert_allclose(np.diag(c2)[9:], 2 * np.diag(c)[9:],
                                   rtol=1e-4)

    def test_merge_previous_matches_one_shot(self):
        acc, gyro, dts = merge_inputs()
        pre_all = integrate(acc, gyro, dts)
        merged = imu.merge_previous(integrate(acc[:40], gyro[:40], dts[:40]),
                                    integrate(acc[40:], gyro[40:], dts[40:]))
        np.testing.assert_allclose(float(merged.dt), float(pre_all.dt),
                                   rtol=1e-6)
        np.testing.assert_allclose(merged.dR.numpy(), pre_all.dR.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(merged.dV.numpy(), pre_all.dV.numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(merged.dP.numpy(), pre_all.dP.numpy(),
                                   atol=1e-4)
        db = f32([0.01, -0.02, 0.015])
        for a, b in zip(imu.delta_with_bias(merged, db, db),
                        imu.delta_with_bias(pre_all, db, db)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3)


def merge_inputs(N=80):
    t = np.arange(N) * 0.005
    acc = np.stack([0.3 * np.sin(3 * t), 0.2 * np.cos(2 * t),
                    9.81 + 0.1 * np.sin(t)], -1).astype(np.float32)
    gyro = np.stack([0.1 * np.cos(t), 0.05 * np.sin(2 * t),
                     0.2 * np.ones(N)], -1).astype(np.float32)
    return acc, gyro, np.full(N, 0.005, np.float32)


# -- the same inputs through both packages -----------------------------------

def assert_pre_close(j, t, tol=1e-5):
    """Deltas and Jacobians within ``tol``; the covariance within ``tol``
    of its largest entry."""
    for name in jimu.Preintegrated._fields:
        a = np.asarray(getattr(j, name), np.float64)
        b = np.asarray(getattr(t, name), np.float64)
        if name == "cov":
            assert np.abs(a - b).max() <= tol * np.abs(a).max(), name
        else:
            np.testing.assert_allclose(b, a, atol=tol, err_msg=name)


def window(rng, n, N):
    """A window of n noisy samples padded to N with junk."""
    acc = (rng.standard_normal((N, 3)) * 0.5 + [0, 0, 9.81]).astype(
        np.float32)
    gyro = (rng.standard_normal((N, 3)) * 0.3).astype(np.float32)
    dts = rng.uniform(0.004, 0.006, N).astype(np.float32)
    acc[n:] = 99.0
    valid = np.arange(N) < n
    bg = (rng.standard_normal(3) * 0.01).astype(np.float32)
    ba = (rng.standard_normal(3) * 0.05).astype(np.float32)
    return acc, gyro, dts, valid, bg, ba


def both(acc, gyro, dts, valid, bg, ba, **kw):
    j = jimu.preintegrate(*(jnp.asarray(x) for x in (acc, gyro, dts, valid,
                                                     bg, ba)), **kw)
    t = imu.preintegrate(*(T(x) for x in (acc, gyro, dts, valid, bg, ba)),
                         **kw)
    return j, imu.to_numpy(t)


@pytest.mark.parametrize("n,N", [(5, 8), (20, 32), (33, 64)])
def test_preintegrate_against_jax(n, N):
    rng = np.random.default_rng(n)
    j, t = both(*window(rng, n, N), noise_gyro=2e-4, noise_acc=2e-3,
                walk_gyro=1e-6, walk_acc=1e-5)
    assert_pre_close(j, t)


@pytest.mark.parametrize("n", [5, 20, 33])
def test_preintegrate_segment_against_jax(n):
    """The host entry: the window padded to JAX's bucket (8, 32, 64), the
    calibration's noise, numpy out."""
    rng = np.random.default_rng(100 + n)
    acc, gyro, dts, _valid, bg, ba = window(rng, n, n)
    calib = imu.ImuCalib(noise_gyro=2e-4, noise_acc=2e-3, walk_gyro=1e-6,
                         walk_acc=1e-5)
    jcal = jimu.ImuCalib(noise_gyro=2e-4, noise_acc=2e-3, walk_gyro=1e-6,
                         walk_acc=1e-5)
    t = imu.preintegrate_segment(acc, gyro, dts, bg, ba, calib, device="cpu")
    j = jimu.preintegrate_segment(acc, gyro, dts, bg, ba, jcal)
    assert isinstance(t.dR, np.ndarray)
    assert_pre_close(j, t)
    assert imu._bucket(n) == {5: 8, 20: 32, 33: 64}[n]


def test_preintegrate_segment_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    z = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        imu.preintegrate_segment(z, z, np.full(4, 0.005, np.float32),
                                 np.zeros(3), np.zeros(3))


def test_bias_functions_against_jax():
    """relinearize, merge_previous, delta_with_bias, predict_state and
    inertial_residual on the same preintegrations."""
    rng = np.random.default_rng(7)
    ja, ta = both(*window(rng, 20, 32))
    jb, tb = both(*window(rng, 33, 64))
    tt = [imu.to_tensors(p, "cpu") for p in (ta, tb)]
    bg = (rng.standard_normal(3) * 0.01).astype(np.float32)
    ba = (rng.standard_normal(3) * 0.05).astype(np.float32)
    assert_pre_close(jimu.relinearize(ja, jnp.asarray(bg), jnp.asarray(ba)),
                     imu.to_numpy(imu.relinearize(tt[0], T(bg), T(ba))))
    assert_pre_close(jimu.merge_previous(ja, jb),
                     imu.to_numpy(imu.merge_previous(*tt)))
    for a, b in zip(jimu.delta_with_bias(jb, jnp.asarray(bg),
                                         jnp.asarray(ba)),
                    imu.delta_with_bias(tt[1], T(bg), T(ba))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    R = lie.so3_exp(f32([0.1, -0.2, 0.3])).numpy()
    p = np.array([0.5, -0.2, 1.0], np.float32)
    v = np.array([0.3, 0.1, -0.2], np.float32)
    g = np.array([1.4, -0.9, -9.6], np.float32)
    for a, b in zip(
            jimu.predict_state(jnp.asarray(R), jnp.asarray(p), jnp.asarray(v),
                               jb, jnp.asarray(bg), jnp.asarray(ba),
                               gravity=jnp.asarray(g)),
            imu.predict_state(T(R), T(p), T(v), tt[1], T(bg), T(ba),
                              gravity=T(g))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    Rj = lie.so3_exp(f32([0.12, -0.18, 0.33])).numpy()
    pj = p + np.array([0.02, 0.01, -0.03], np.float32)
    vj = v + np.array([0.05, -0.02, 0.01], np.float32)
    a = jimu.inertial_residual(*(jnp.asarray(x) for x in (R, p, v, Rj, pj, vj,
                                                          bg, ba)), jb)
    b = imu.inertial_residual(*(T(x) for x in (R, p, v, Rj, pj, vj, bg, ba)),
                              tt[1])
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


def test_make_imu_trajectory_bit_for_bit():
    kw = dict(n_kf=5, seed=3, bg=[0.01, 0, -0.02], ba=[0.1, 0.2, 0.0],
              noise_gyro=0.004, noise_acc=0.06)
    j = jsyn.make_imu_trajectory(**kw)
    t = tsyn.make_imu_trajectory(**kw)
    assert j.keys() == t.keys()
    for k in j:
        if k == "imu":
            for sj, st in zip(j[k], t[k]):
                for f in ("acc", "gyro", "dts"):
                    np.testing.assert_array_equal(st[f], sj[f])
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_make_vi_sequence_bit_for_bit():
    """Images, depths, poses, IMU samples (the noise drawn in the same
    order) and the truth, at a small size."""
    kw = dict(n_frames=3, fps=10.0, imu_rate=200.0, hw=(48, 64),
              K=np.array([[51.7, 0, 31.9], [0, 51.6, 25.5], [0, 0, 1]],
                         np.float32),
              seed=1, bg=[0.004, -0.003, 0.002], ba=[0.03, -0.02, 0.04],
              noise_gyro=2e-4, noise_acc=2e-3)
    j = jsyn.make_vi_sequence(**kw)
    t = tsyn.make_vi_sequence(**kw)
    assert j.keys() == t.keys()
    for k in ("images", "depths"):
        for a, b in zip(j[k], t[k]):
            np.testing.assert_array_equal(b, a)
    for (Rj, tj), (Rt, tt) in zip(j["poses"], t["poses"]):
        np.testing.assert_array_equal(Rt, Rj)
        np.testing.assert_array_equal(tt, tj)
    for sj, st in zip(j["imu"], t["imu"]):
        assert len(sj) == len(st)
        for a, b in zip(sj, st):
            np.testing.assert_array_equal(b[0], a[0])
            np.testing.assert_array_equal(b[1], a[1])
            assert b[2] == a[2]
    for k in ("timestamps", "R_wb", "p_wb", "v_w", "g_w", "bg", "ba", "K"):
        np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]),
                                      err_msg=k)

"""The port's Kannala-Brandt fisheye camera and two-camera triangulation
(``xfeatslam_tpu_torch/ops/camera.py``) against the JAX package's on the
same seeded points: ``kb8_project``, ``kb8_unproject`` (10 Newton steps)
and ``kb8_project_jac`` within 1e-5 (float32, the same operations), the
dispatchers on both models, and the four cases of
``tests/test_fisheye.py::TestTriangulateMatchesKernel`` through
``stereo_triangulate_matches``: the points within 1e-4 relative (the 4x4
SVD of LAPACK in both, float32), the ``ok`` flags equal, and the JAX
test's own bars on the port's output."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.ops import camera as jc  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402

from test_fisheye import KB1, KB2, make_rig  # noqa: E402

KB = [190.98, 190.97, 254.93, 256.9, 0.0034823894, 0.0007150348,
      -0.0020532361, 0.00020293673]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(rng, n=256):
    return np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                     rng.uniform(0.3, 4.0, n)], -1).astype(np.float32)


def _port(cam):
    return tc.KannalaBrandt8.from_list([float(v) for v in cam])


def test_kb8_project_unproject_jac_match_jax(rng):
    jcam, tcam = jc.KannalaBrandt8.from_list(KB), tc.KannalaBrandt8.from_list(KB)
    X = _points(rng)
    uv_j = np.array(jc.kb8_project(jcam, jnp.asarray(X)))
    uv_t = tc.kb8_project(tcam, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(uv_t, uv_j, rtol=1e-5, atol=1e-5 * 256)
    ray_j = np.array(jc.kb8_unproject(jcam, jnp.asarray(uv_j)))
    ray_t = tc.kb8_unproject(tcam, torch.from_numpy(uv_j)).numpy()
    np.testing.assert_allclose(ray_t, ray_j, rtol=1e-5, atol=1e-5)
    # the bearing recovers the point's direction
    np.testing.assert_allclose(ray_t[:, :2], X[:, :2] / X[:, 2:], atol=2e-3)
    J_j = np.array(jc.kb8_project_jac(jcam, jnp.asarray(X)))
    J_t = tc.kb8_project_jac(tcam, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(J_t, J_j, rtol=1e-5, atol=1e-5 * np.abs(J_j).max())
    # the dispatchers route each model
    np.testing.assert_array_equal(tc.project(tcam, torch.from_numpy(X)).numpy(),
                                  uv_t)
    np.testing.assert_array_equal(
        tc.project_jac(tcam, torch.from_numpy(X)).numpy(), J_t)
    np.testing.assert_array_equal(
        tc.unproject(tcam, torch.from_numpy(uv_j)).numpy(), ray_t)
    assert tcam.params_list() == [float(v) for v in KB]
    np.testing.assert_allclose(tcam.K.numpy(), np.asarray(jcam.K), atol=1e-4)


def _triangulate_both(cam1, cam2, uv1, uv2, R12, t12):
    Xj, zj, okj = jc.stereo_triangulate_matches(
        cam1, cam2, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(R12),
        jnp.asarray(t12))
    tcam1 = _port(cam1) if isinstance(cam1, jc.KannalaBrandt8) else \
        tc.Pinhole.from_list([float(v) for v in cam1])
    tcam2 = _port(cam2) if isinstance(cam2, jc.KannalaBrandt8) else \
        tc.Pinhole.from_list([float(v) for v in cam2])
    Xt, zt, okt = tc.stereo_triangulate_matches(
        tcam1, tcam2, torch.from_numpy(uv1), torch.from_numpy(uv2),
        torch.from_numpy(R12), torch.from_numpy(t12))
    Xj, zj, okj = np.asarray(Xj), np.asarray(zj), np.asarray(okj)
    Xt, zt, okt = Xt.numpy(), zt.numpy(), okt.numpy()
    np.testing.assert_array_equal(okt, okj)
    sel = okj
    np.testing.assert_allclose(Xt[sel], Xj[sel], rtol=1e-4,
                               atol=1e-4 * np.abs(Xj[sel]).max(initial=1.0))
    np.testing.assert_allclose(zt[sel], zj[sel], rtol=1e-4)
    return Xt, zt, okt


def _rig_views(X):
    T = make_rig()
    R12, t12 = T[:3, :3], T[:3, 3]
    X2 = (X - t12) @ R12
    uv1 = np.array(jc.kb8_project(KB1, jnp.asarray(X)))
    uv2 = np.array(jc.kb8_project(KB2, jnp.asarray(X2)))
    return uv1, uv2, R12, t12


def test_triangulate_recovers_points():
    rng = np.random.default_rng(0)
    X = _points(rng)
    X[:, 2] = rng.uniform(0.5, 4.0, len(X))
    uv1, uv2, R12, t12 = _rig_views(X)
    inb = (((uv1 > 2) & (uv1 < 509)).all(-1)
           & ((uv2 > 2) & (uv2 < 509)).all(-1))
    Xr, z1, ok = _triangulate_both(KB1, KB2, uv1, uv2, R12, t12)
    sel = ok & inb
    assert sel.sum() > 0.8 * inb.sum()
    assert np.median(np.linalg.norm(Xr[sel] - X[sel], axis=-1)) < 5e-3
    np.testing.assert_allclose(z1[sel], X[sel][:, 2], rtol=2e-2)


def test_triangulate_parallax_gate_rejects_distant_points():
    X = np.array([[0.2, 0.1, 40.0], [-0.3, 0.2, 60.0]], np.float32)
    uv1, uv2, R12, t12 = _rig_views(X)
    _, _, ok = _triangulate_both(KB1, KB2, uv1, uv2, R12, t12)
    assert not ok.any()


def test_triangulate_reprojection_gate_rejects_bad_matches():
    rng = np.random.default_rng(1)
    N = 64
    X = np.stack([rng.uniform(-1, 1, N), rng.uniform(-0.8, 0.8, N),
                  rng.uniform(0.8, 3.0, N)], -1).astype(np.float32)
    uv1, uv2, R12, t12 = _rig_views(X)
    _, _, ok_good = _triangulate_both(KB1, KB2, uv1, uv2, R12, t12)
    _, _, ok_bad = _triangulate_both(KB1, KB2, uv1, uv2[rng.permutation(N)],
                                     R12, t12)
    assert ok_good.mean() > 0.8
    assert ok_bad.mean() < 0.1


def test_triangulate_works_for_pinhole_too():
    cam = jc.Pinhole.from_list([500.0, 500.0, 320.0, 240.0])
    rng = np.random.default_rng(2)
    N = 64
    X = np.stack([rng.uniform(-0.8, 0.8, N), rng.uniform(-0.6, 0.6, N),
                  rng.uniform(1.0, 3.0, N)], -1).astype(np.float32)
    t12 = np.array([0.1, 0, 0], np.float32)
    R12 = np.eye(3, dtype=np.float32)
    uv1 = np.array(jc.pinhole_project(cam, jnp.asarray(X)))
    uv2 = np.array(jc.pinhole_project(cam, jnp.asarray(X - t12)))
    Xr, _, ok = _triangulate_both(cam, cam, uv1, uv2, R12, t12)
    assert ok.mean() > 0.9
    np.testing.assert_allclose(Xr[ok], X[ok], atol=5e-3)

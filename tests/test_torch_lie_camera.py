"""The PyTorch port's SO3/SE3 and Pinhole camera functions against the JAX
package on the same numpy inputs, including the small-angle branches,
rotations near pi and the TUM1 distortion. Tolerances: 1e-6 on rotations,
tangents and unit-scale points (float32 sums taken in another order), 1e-4
px on pixels (a few ulps of values ~500)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.ops import camera as jc  # noqa: E402
from xfeatslam_tpu.ops import lie as jl  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402
from xfeatslam_tpu_torch.ops import lie as tl  # noqa: E402

# TUM1.yaml intrinsics with distortion, as tests/test_camera.py
TUM1 = [517.306408, 516.469215, 318.643040, 255.313989,
        0.262383, -0.953104, -0.005358, 0.002628, 1.163314]


def t(x):
    return torch.tensor(np.asarray(x))


def n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, ref, atol=1e-6):
    np.testing.assert_allclose(n(got), n(ref), atol=atol, rtol=0)


def port_pinhole(cam: jc.Pinhole) -> tc.Pinhole:
    """The JAX Pinhole carried over through its parameter list."""
    return tc.Pinhole.from_list(cam.params_list())


def tangents(rng):
    """Generic, small-angle (theta^2 < 1e-8) and near-pi rotation vectors."""
    phi = rng.normal(0, 1.0, (40, 3))
    small = rng.normal(0, 1e-5, (10, 3))
    axis = rng.normal(0, 1, (10, 3))
    near_pi = axis / np.linalg.norm(axis, axis=1, keepdims=True) * (
        np.pi - rng.uniform(1e-4, 1e-2, (10, 1)))
    return np.concatenate([phi, small, near_pi, np.zeros((1, 3))]).astype(
        np.float32)


@pytest.mark.parametrize("fn", ["so3_hat", "so3_exp", "so3_left_jacobian",
                                "so3_left_jacobian_inv"])
def test_so3_tangent_functions_match_jax(rng, fn):
    phi = tangents(rng)
    close(getattr(tl, fn)(t(phi)), getattr(jl, fn)(jnp.asarray(phi)))


def test_so3_log_quaternion_vee_match_jax(rng):
    R = np.asarray(jl.so3_exp(jnp.asarray(tangents(rng))))
    close(tl.so3_log(t(R)), jl.so3_log(jnp.asarray(R)), atol=2e-6)
    q = jl.rotation_to_quaternion(jnp.asarray(R))
    close(tl.rotation_to_quaternion(t(R)), q)
    close(tl.quaternion_to_rotation(t(np.asarray(q))),
          jl.quaternion_to_rotation(q))
    Phi = np.asarray(jl.so3_hat(jnp.asarray(tangents(rng))))
    close(tl.so3_vee(t(Phi)), jl.so3_vee(jnp.asarray(Phi)))


def test_se3_functions_match_jax(rng):
    xi = np.concatenate([rng.normal(0, 1, (61, 3)).astype(np.float32),
                         tangents(rng)], -1)
    Rj, tj = jl.se3_exp(jnp.asarray(xi))
    Rt, tt = tl.se3_exp(t(xi))
    close(Rt, Rj)
    close(tt, tj, atol=2e-6)
    close(tl.se3_log(t(np.asarray(Rj)), t(np.asarray(tj))),
          jl.se3_log(Rj, tj), atol=2e-5)  # near pi the log amplifies ulps
    Ra, ta = np.asarray(Rj[:30]), np.asarray(tj[:30])
    Rb, tb = np.asarray(Rj[30:60]), np.asarray(tj[30:60])
    for g, r in zip(tl.se3_compose(t(Ra), t(ta), t(Rb), t(tb)),
                    jl.se3_compose(*map(jnp.asarray, (Ra, ta, Rb, tb)))):
        close(g, r, atol=2e-6)
    for g, r in zip(tl.se3_inverse(t(Ra), t(ta)),
                    jl.se3_inverse(jnp.asarray(Ra), jnp.asarray(ta))):
        close(g, r, atol=2e-6)
    X = rng.normal(0, 2, (200, 3)).astype(np.float32)
    close(tl.se3_apply(t(Ra[0]), t(ta[0]), t(X)),
          jl.se3_apply(jnp.asarray(Ra[0]), jnp.asarray(ta[0]), jnp.asarray(X)),
          atol=2e-6)
    close(tl.se3_matrix(t(Ra), t(ta)),
          jl.se3_matrix(jnp.asarray(Ra), jnp.asarray(ta)))


def test_normalize_rotation_matches_jax(rng):
    R = np.asarray(jl.so3_exp(jnp.asarray(rng.normal(0, 1, (20, 3)).astype(
        np.float32))))
    noisy = (R + rng.normal(0, 1e-3, R.shape)).astype(np.float32)
    noisy[3] = -noisy[3]  # a reflection
    got = tl.normalize_rotation(t(noisy)).numpy()
    keep = np.arange(20) != 3
    close(got[keep], np.asarray(jl.normalize_rotation(jnp.asarray(noisy)))[keep],
          atol=2e-6)
    # the reflection's fix flips the singular vector of the smallest of three
    # near-equal singular values, which two SVD libraries pick differently:
    # hold that one to being a rotation
    np.testing.assert_allclose(got[3].T @ got[3], np.eye(3), atol=1e-5)
    assert np.linalg.det(got[3]) > 0
    np.testing.assert_array_equal(tl.np_normalize_rotation(noisy[0]),
                                  jl.np_normalize_rotation(noisy[0]))


def test_mat_mul_ignores_tf32_flag(rng):
    """The geometry products are elementwise, so the TF32 switch has no
    say: full float32 with the flag on."""
    a = rng.normal(0, 1, (50, 3, 3)).astype(np.float32)
    b = rng.normal(0, 1, (50, 3, 3)).astype(np.float32)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        close(tl.mat_mul(t(a), t(b)), a.astype(np.float64) @ b, atol=1e-5)
        close(tl.mat_vec(t(a), t(b[:, 0])),
              np.einsum("nij,nj->ni", a.astype(np.float64), b[:, 0]), atol=1e-5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("distorted", [False, True])
def test_pinhole_functions_match_jax(rng, distorted):
    jcam = jc.Pinhole.from_list(TUM1 if distorted else TUM1[:4])
    cam = port_pinhole(jcam)
    assert cam.params_list() == pytest.approx(jcam.params_list())
    X = np.stack([rng.uniform(-2, 2, 300), rng.uniform(-1.5, 1.5, 300),
                  rng.uniform(0.5, 6, 300)], -1).astype(np.float32)
    close(tc.project(cam, t(X)), jc.project(jcam, jnp.asarray(X)), atol=1e-4)
    close(tc.project_jac(cam, t(X)), jc.project_jac(jcam, jnp.asarray(X)),
          atol=1e-4)
    uv = np.stack([rng.uniform(0, 640, 300), rng.uniform(0, 480, 300)],
                  -1).astype(np.float32)
    close(tc.unproject(cam, t(uv)), jc.unproject(jcam, jnp.asarray(uv)))
    xy = (X[:, :2] / X[:, 2:]).astype(np.float32) * 0.5
    close(tc.distort_normalized(cam, t(xy)),
          jc.distort_normalized(jcam, jnp.asarray(xy)))
    close(tc.undistort_points(cam, t(uv)),
          jc.undistort_points(jcam, jnp.asarray(uv)), atol=1e-4)
    np.testing.assert_allclose(cam.K.numpy(), np.asarray(jcam.K), atol=1e-4)


def test_camera_dispatch_refuses_other_models():
    with pytest.raises(TypeError, match="Pinhole"):
        tc.project(jc.KannalaBrandt8.from_list([1.0] * 8), torch.zeros(1, 3))

"""The PyTorch port's Sim3 (``ops/lie.py``) and Sim3 solvers
(``optim/sim3.py``) against the JAX package on the same numpy inputs.

Bars: the Lie functions within 1e-5; Horn and the LM refinement within
1e-4 (float32 sums in another order); RANSAC fed the JAX draw's minimal
sets (computed here as ``xfeatslam_tpu/optim/sim3.py`` draws them) picks
the same hypothesis: ``success``, the inlier count and mask identical and
s, R, t within 1e-4. Then ``tests/test_solvers.py::TestSim3``'s three
cases on the port, with its own draws (``torch.multinomial`` from a seeded
generator)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.ops import camera as jc  # noqa: E402
from xfeatslam_tpu.ops import lie as jl  # noqa: E402
from xfeatslam_tpu.optim import sim3 as jsim3  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402
from xfeatslam_tpu_torch.ops import lie as tl  # noqa: E402
from xfeatslam_tpu_torch.optim import sim3 as tsim3  # noqa: E402

import test_solvers  # noqa: E402

CAMP = [517.3, 516.5, 318.6, 255.3]
JCAM, TCAM = jc.Pinhole.from_list(CAMP), tc.Pinhole.from_list(CAMP)
ITERS = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make(seed, **kw):
    """TestSim3.make: KF2 camera points, a known Sim3, both projections,
    a fraction of KF2's points moved 0.5-2 m."""
    return test_solvers.TestSim3().make(np.random.default_rng(seed), **kw)


def t(x):
    return torch.tensor(np.asarray(x))


def jax_draws(valid, key):
    """The (ITERS, 3) minimal sets ``xfeatslam_tpu.optim.sim3.sim3_ransac``
    draws from ``key``."""
    n = len(valid)
    w = valid.astype(np.float32) + 1e-6
    logits = jnp.log(w)[None, None, :].repeat(ITERS, 1).reshape(
        ITERS, 1, n).repeat(3, 1)
    return np.asarray(jax.random.categorical(key, logits, axis=-1))


def tangents():
    """sim3 tangents: generic, small rotations, small sigma, both small."""
    rng = np.random.default_rng(0)
    xi = (rng.normal(size=(40, 7)) * 0.4).astype(np.float32)
    xi[:10, 3:6] *= 1e-5
    xi[10:20, 6] *= 1e-6
    xi[20:25, 3:] *= 1e-6
    return xi


def test_sim3_lie_matches_jax():
    xi = tangents()
    ja, ta = jl.sim3_exp(jnp.asarray(xi)), tl.sim3_exp(t(xi))
    for a, b in zip(ja, ta):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    np.testing.assert_allclose(tl.sim3_log(*ta).numpy(),
                               np.asarray(jl.sim3_log(*ja)), atol=1e-5)
    jb, tb = ((x[::-1].copy() for x in map(np.asarray, ja)),
              (x.flip(0) for x in ta))
    jb, tb = tuple(jb), tuple(tb)
    for fn_j, fn_t, args_j, args_t in (
            (jl.sim3_compose, tl.sim3_compose, ja + jb, ta + tb),
            (jl.sim3_inverse, tl.sim3_inverse, ja, ta)):
        for a, b in zip(fn_j(*map(jnp.asarray, args_j)), fn_t(*args_t)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    x = np.random.default_rng(1).normal(size=(40, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tl.sim3_apply(*ta, t(x)).numpy(),
        np.asarray(jl.sim3_apply(*ja, jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_matches_jax(fix_scale):
    Xc1, Xc2, *_ = make(0, outlier_frac=0.0)
    ref = jsim3.horn_sim3(jnp.asarray(Xc1), jnp.asarray(Xc2), fix_scale)
    got = tsim3.horn_sim3(t(Xc1), t(Xc2), fix_scale)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
    # batched minimal sets, as RANSAC solves them
    idx = np.random.default_rng(2).integers(0, len(Xc1), (16, 3))
    ref = jsim3.horn_sim3(jnp.asarray(Xc1[idx]), jnp.asarray(Xc2[idx]),
                          fix_scale)
    got = tsim3.horn_sim3(t(Xc1[idx]), t(Xc2[idx]), fix_scale)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


@pytest.mark.parametrize("fix_scale,seed", [(False, 0), (True, 1),
                                            (False, 5)])
def test_ransac_on_jax_draws(fix_scale, seed):
    Xc1, Xc2, uv1, uv2, _, _ = make(seed, s_true=1.0 if fix_scale else 1.3)
    valid = np.ones(len(Xc1), bool)
    valid[-7:] = False
    key = jax.random.PRNGKey(seed)
    ref = jsim3.sim3_ransac(*map(jnp.asarray, (Xc1, Xc2, uv1, uv2, valid)),
                            JCAM, key, fix_scale=fix_scale)
    got = tsim3.sim3_ransac(*map(t, (Xc1, Xc2, uv1, uv2, valid)), TCAM,
                            idx=t(jax_draws(valid, key)),
                            fix_scale=fix_scale)
    assert bool(got.success) == bool(ref.success)
    assert int(got.num_inliers) == int(ref.num_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(ref.inliers))
    for a, b in zip((ref.s, ref.R, ref.t), (got.s, got.R, got.t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches_jax(fix_scale):
    Xc1, Xc2, uv1, uv2, (s, R, tt), _ = make(3, outlier_frac=0.1)
    dxi = np.zeros(7, np.float32)
    dxi[:3] = 0.05
    dxi[6] = 0.0 if fix_scale else 0.05
    ds, dR, dt = (np.asarray(x) for x in jl.sim3_exp(jnp.asarray(dxi)))
    s0 = np.float32(float(ds) * s)
    R0 = (dR @ R).astype(np.float32)
    t0 = (float(ds) * (dR @ tt) + dt).astype(np.float32)
    valid = np.ones(len(Xc1), bool)
    args = (Xc1, Xc2, uv1, uv2, valid)
    ref = jsim3.optimize_sim3(jnp.float32(s0), jnp.asarray(R0),
                              jnp.asarray(t0), *map(jnp.asarray, args), JCAM,
                              fix_scale=fix_scale)
    got = tsim3.optimize_sim3(t(s0), t(R0), t(t0), *map(t, args), TCAM,
                              fix_scale=fix_scale)
    for a, b in zip(ref[:3], got[:3]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
    assert (got[3].numpy() == np.asarray(ref[3])).mean() >= 0.99
    assert abs(int(got[4]) - int(ref[4])) <= 1


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra @ Rb.T) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


def test_port_ransac_own_draws():
    """TestSim3.test_ransac on the port with its own draws."""
    Xc1, Xc2, uv1, uv2, (s, R, tt), _ = make(0)
    gen = torch.Generator().manual_seed(0)
    res = tsim3.sim3_ransac(*map(t, (Xc1, Xc2, uv1, uv2)),
                            torch.ones(len(Xc1), dtype=torch.bool), TCAM,
                            generator=gen)
    assert bool(res.success), int(res.num_inliers)
    assert abs(float(res.s) - s) < 0.02, float(res.s)
    assert _rot_deg(res.R.numpy(), R) < 0.5
    assert np.linalg.norm(res.t.numpy() - tt) < 0.05


def test_port_refinement():
    """TestSim3.test_refinement on the port."""
    Xc1, Xc2, uv1, uv2, (s, R, tt), _ = make(0, outlier_frac=0.1)
    dxi = np.zeros(7, np.float32)
    dxi[:3] = 0.05
    dxi[6] = 0.05
    ds, dR, dt = tl.sim3_exp(t(dxi))
    s0 = ds * s
    R0 = tl.mat_mul(dR, t(R))
    t0 = ds * tl.mat_vec(dR, t(tt)) + dt
    s1, R1, _, _, _ = tsim3.optimize_sim3(
        s0, R0, t0, *map(t, (Xc1, Xc2, uv1, uv2)),
        torch.ones(len(Xc1), dtype=torch.bool), TCAM)
    assert abs(float(s1) - s) < 0.01, float(s1)
    assert _rot_deg(R1.numpy(), R) < 0.3


def test_port_fix_scale():
    """TestSim3.test_fix_scale on the port: the scale stays exactly 1."""
    Xc1, Xc2, uv1, uv2, _, _ = make(0, s_true=1.0, outlier_frac=0.1)
    gen = torch.Generator().manual_seed(0)
    res = tsim3.sim3_ransac(*map(t, (Xc1, Xc2, uv1, uv2)),
                            torch.ones(len(Xc1), dtype=torch.bool), TCAM,
                            generator=gen, fix_scale=True)
    assert float(res.s) == 1.0

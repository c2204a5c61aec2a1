"""The PyTorch port's two-view initializer (``optim/two_view``) against the
JAX package's on the cases of ``tests/test_two_view.py``.

JAX draws the (200, 8) RANSAC minimal sets inside
``reconstruct_two_views`` with ``jax.random.categorical``; the port takes
them as an input. Each case feeds the port JAX's own draws (the same call
on the same key), so both score the same models: success, the model used
and the good-point mask must be equal, R and t within 1e-5 where the
initializer succeeds, and the good points within 1e-3 (in units of the
baseline; the DLT's eigen-solve and the refit's SVD round differently in
the two frameworks). The homography decomposition must give the same 8
motions, matched as a set (an SVD's signs may order them differently).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager CPU ops are many small tensors; with the test
    workers sharing the cores, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.ops import lie as jl  # noqa: E402
from xfeatslam_tpu.optim import two_view as jtv  # noqa: E402
from xfeatslam_tpu_torch.optim import two_view as ttv  # noqa: E402

from test_two_view import K, make_pair  # noqa: E402


def jax_draws(valid, key):
    """The minimal sets the JAX initializer draws for ``key``
    (``two_view.py:226-231``)."""
    n = len(valid)
    w = jnp.asarray(valid).astype(jnp.float32) + 1e-6
    logits = jnp.log(w)[None, None, :].repeat(jtv.N_ITERS, 1).reshape(
        jtv.N_ITERS, 1, n).repeat(8, 1)
    return np.asarray(jax.random.categorical(key, logits, axis=-1))


def run_both(uv1, uv2, valid, seed):
    key = jax.random.PRNGKey(seed)
    rj = jtv.reconstruct_two_views(jnp.asarray(uv1), jnp.asarray(uv2),
                                   jnp.asarray(valid), jnp.asarray(K), key)
    rt = ttv.reconstruct_two_views(
        torch.from_numpy(uv1), torch.from_numpy(uv2),
        torch.from_numpy(valid), torch.from_numpy(K),
        idx=torch.from_numpy(jax_draws(valid, key).copy()))
    return ({k: np.asarray(v) for k, v in rj._asdict().items()},
            {k: v.numpy() for k, v in rt._asdict().items()})


def check_same(rj, rt):
    assert bool(rt["success"]) == bool(rj["success"])
    assert bool(rt["used_h"]) == bool(rj["used_h"])
    np.testing.assert_array_equal(rt["good"], rj["good"])
    if bool(rj["success"]):
        np.testing.assert_allclose(rt["R"], rj["R"], atol=1e-5)
        np.testing.assert_allclose(rt["t"], rj["t"], atol=1e-5)
        good = rj["good"]
        np.testing.assert_allclose(rt["points"][good], rj["points"][good],
                                   atol=1e-3)


def outliers(rng, uv1, uv2):
    sel = rng.choice(len(uv1), 60, replace=False)
    uv2 = uv2.copy()
    uv2[sel] = rng.uniform(0, 640, (60, 2)).astype(np.float32) * [1, 0.75]
    return uv2


# (pair options, key, perturbation of the second view): TestTwoView's
# general, planar, outlier and no-motion cases
CASES = {
    "general_scene_f_model": (dict(), 0, None),
    "planar_scene": (dict(planar=True), 1, None),
    "outliers": (dict(), 2, outliers),
    "degenerate_no_motion": (dict(baseline=0.0, noise=0.3), 3,
                             lambda rng, uv1, uv2: uv1.copy()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_reconstruction_matches_jax(case):
    kw, seed, perturb = CASES[case]
    rng = np.random.default_rng(0)
    uv1, uv2, valid, _, _ = make_pair(rng, **kw)
    if perturb is not None:
        uv2 = perturb(rng, uv1, uv2)
    rj, rt = run_both(uv1, uv2, valid, seed)
    check_same(rj, rt)
    # the JAX package's own expectation of each case
    if case in ("general_scene_f_model", "outliers"):
        assert bool(rt["success"])
    if case == "degenerate_no_motion":
        assert not bool(rt["success"])


def test_homography_decomposition_matches_jax():
    """TestTwoView.test_homography_decomposition's exact plane homography:
    the same 8 (R, t) hypotheses, and the true motion among them."""
    n_pl = np.array([0.0, 0.0, 1.0])
    R, t = jl.se3_exp(jnp.asarray(np.array(
        [0.3, 0.05, 0.02, 0.02, -0.12, 0.01], np.float32)))
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    H = K.astype(np.float64) @ (R + np.outer(t, n_pl) / 4.0) @ np.linalg.inv(
        K.astype(np.float64))
    Rj, tj = (np.asarray(x) for x in jtv._motions_from_h(
        jnp.asarray(H, jnp.float32), jnp.asarray(K)))
    Rt, tt = (x.numpy() for x in ttv._motions_from_h(
        torch.from_numpy(H.astype(np.float32)), torch.from_numpy(K)))
    for i in range(8):
        d = [np.abs(Rt[k] - Rj[i]).max() + np.abs(tt[k] - tj[i]).max()
             for k in range(8)]
        assert min(d) < 1e-4, (i, d)
    t_dir = t / np.linalg.norm(t)
    rot = [np.degrees(np.arccos(np.clip((np.trace(Rt[i] @ R.T) - 1) / 2,
                                        -1, 1))) for i in range(8)]
    terr = [np.degrees(np.arccos(np.clip(abs(tt[i] @ t_dir), -1, 1)))
            for i in range(8)]
    best = int(np.argmin(np.array(rot) + np.array(terr)))
    assert rot[best] < 0.5 and terr[best] < 1.0


def test_draws_follow_the_valid_mask():
    """The port's own draws: (N_ITERS, 8) indices, all on valid slots
    (the 1e-6 weight of an invalid slot is never drawn at this size), the
    same for the same generator seed."""
    valid = np.zeros(300, bool)
    valid[::3] = True
    v = torch.from_numpy(valid)
    a = ttv.draw_minimal_sets(v, torch.Generator().manual_seed(4))
    b = ttv.draw_minimal_sets(v, torch.Generator().manual_seed(4))
    assert a.shape == (ttv.N_ITERS, 8)
    assert torch.equal(a, b)
    assert valid[a.numpy()].all()

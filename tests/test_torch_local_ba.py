"""The PyTorch port's bundle adjustment against the JAX package: one padded
problem built in numpy goes through both ``bundle_adjust``s. Poses must
agree within 1e-4, the inlier classification exactly, and the points that
two or more inlier observations determine within 1e-4 (2e-3 on a problem
of mostly mono edges, where float32 rounding in the conjugate gradients
moves weakly determined depths). The problems are those of
``tests/test_local_ba.py`` with RGB-D (stereo) edges on part of the
observations, which fix the scale gauge that mono edges leave free."""

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

from xfeatslam_tpu.ops import camera as jc  # noqa: E402
from xfeatslam_tpu.ops import lie as jl  # noqa: E402
from xfeatslam_tpu.optim import local_ba as jba  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402
from xfeatslam_tpu_torch.optim import local_ba as tba  # noqa: E402

CAMP = [517.3, 516.5, 318.6, 255.3]
BF = 40.0


def make_problem(seed, n_cams=6, n_pts=300, noise_px=0.4, pose_noise=0.02,
                 point_noise=0.05, outlier_frac=0.0, stereo_frac=0.5,
                 pad_cams=8, pad_pts=512, pad_obs=4096):
    """Cameras along a small arc, points in front, observations with pixel
    noise (and outliers), perturbed starting poses and points; camera 0
    fixed. Returns the BAProblem fields as numpy arrays, the truth and
    the outlier mask."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = CAMP
    X_true = rng.uniform(-2.5, 2.5, (n_pts, 3)).astype(np.float32)
    X_true[:, 2] = rng.uniform(3.0, 8.0, n_pts)
    poses = [tuple(np.asarray(a) for a in jl.se3_exp(jnp.asarray(np.array(
        [0.12 * i, 0.02 * i, 0.01 * i, 0.01 * i, 0.03 * i, 0.005 * i],
        np.float32)))) for i in range(n_cams)]
    obs_cam, obs_pt, uv, ur = [], [], [], []
    for c, (R, t) in enumerate(poses):
        Xc = X_true @ R.T + t
        u = fx * Xc[:, 0] / Xc[:, 2] + cx
        v = fy * Xc[:, 1] / Xc[:, 2] + cy
        vis = (u >= 0) & (u < 640) & (v >= 0) & (v < 480) & (Xc[:, 2] > 0.1)
        for p in np.nonzero(vis)[0]:
            obs_cam.append(c)
            obs_pt.append(p)
            uv.append([u[p], v[p]])
            ur.append(u[p] - BF / Xc[p, 2])
    n_obs = len(obs_cam)
    noise = rng.normal(0, noise_px, (n_obs, 3)).astype(np.float32)
    uv = np.array(uv, np.float32) + noise[:, :2]
    ur = np.array(ur, np.float32) + noise[:, 2]
    stereo = rng.uniform(size=n_obs) < stereo_frac
    is_out = np.zeros(n_obs, bool)
    if outlier_frac > 0:
        sel = rng.choice(n_obs, int(outlier_frac * n_obs), replace=False)
        uv[sel] += rng.uniform(20, 60, (len(sel), 2)).astype(np.float32)
        is_out[sel] = True
    R0, t0 = [poses[0][0]], [poses[0][1]]
    for c in range(1, n_cams):
        dR, dt = (np.asarray(a) for a in jl.se3_exp(jnp.asarray(
            rng.normal(0, pose_noise, 6).astype(np.float32))))
        R0.append(dR @ poses[c][0])
        t0.append(dR @ poses[c][1] + dt)
    X0 = X_true + rng.normal(0, point_noise, X_true.shape).astype(np.float32)

    def pad(a, n, fill=0, dtype=None):
        a = np.asarray(a, dtype)
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[: len(a)] = a
        return out

    fixed = np.zeros(pad_cams, bool)
    fixed[0] = True
    fields = dict(
        R=pad(R0, pad_cams, 0, np.float32), t=pad(t0, pad_cams, 0, np.float32),
        fixed=fixed, cam_valid=pad(np.ones(n_cams, bool), pad_cams, False),
        X=pad(X0, pad_pts), p_valid=pad(np.ones(n_pts, bool), pad_pts, False),
        obs_cam=pad(obs_cam, pad_obs, 0, np.int32),
        obs_pt=pad(obs_pt, pad_obs, 0, np.int32),
        uv=pad(uv, pad_obs), ur=pad(np.where(stereo, ur, 0.0), pad_obs, 0,
                                    np.float32),
        stereo=pad(stereo, pad_obs, False),
        valid=pad(np.ones(n_obs, bool), pad_obs, False),
        inv_sigma2=np.ones(pad_obs, np.float32))
    return fields, X_true, is_out, n_obs


def run_both(fields, **kw):
    rj = jba.bundle_adjust(
        jba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jc.Pinhole.from_list(CAMP), jnp.float32(BF), **kw)
    rt = tba.bundle_adjust(
        tba.BAProblem(**{k: torch.from_numpy(np.array(v))
                         for k, v in fields.items()}),
        tc.Pinhole.from_list(CAMP), BF, **kw)
    return ({k: np.asarray(v) for k, v in rj._asdict().items()},
            {k: v.numpy() for k, v in rt._asdict().items()})


def constrained(fields, res, n_obs):
    """Points with at least two inlier observations: those the problem
    determines (local mapping drops a point left with fewer)."""
    ok = res["inlier"][:n_obs]
    return np.bincount(fields["obs_pt"][:n_obs][ok],
                       minlength=len(fields["X"])) >= 2


# (problem, tolerance on the constrained points' X). Poses agree within
# 1e-4 everywhere. Where most edges are mono, a point's depth is weakly
# determined and float32 rounding in the 40-step CG moves it by up to
# ~1e-3 between the two implementations.
CASES = {
    "clean": (dict(noise_px=0.0, pose_noise=0.03, point_noise=0.08), 1e-4),
    "noisy": (dict(noise_px=0.5, pose_noise=0.03, point_noise=0.08), 1e-4),
    "outliers": (dict(noise_px=0.4, outlier_frac=0.15, stereo_frac=1.0),
                 1e-4),
    "mono_heavy": (dict(stereo_frac=0.2), 2e-3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bundle_adjust_matches_jax(case):
    kw, x_tol = CASES[case]
    fields, X_true, is_out, n_obs = make_problem(0, **kw)
    j, t = run_both(fields)
    for k in ("R", "t"):
        np.testing.assert_allclose(t[k], j[k], atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(t["inlier"], j["inlier"])
    c = constrained(fields, j, n_obs)
    assert c.sum() > 250
    np.testing.assert_allclose(t["X"][c], j["X"][c], atol=x_tol)
    np.testing.assert_allclose(t["chi2"][:n_obs], j["chi2"][:n_obs],
                               rtol=1e-3, atol=1e-2)
    # and the solve moved the points toward the truth
    def err(X):
        return np.median(np.linalg.norm(X[:300] - X_true, axis=1))

    assert err(t["X"]) < 0.7 * err(fields["X"])
    if case == "outliers":
        inl = t["inlier"][:n_obs]
        assert inl[~is_out].mean() > 0.9 and inl[is_out].mean() < 0.05


def test_budgeted_rounds_match_jax():
    """The rounds local mapping runs: the robust first stage alone, then
    one budgeted tick (prune, 5 iterations) from its result."""
    fields, _, _, n_obs = make_problem(0, noise_px=0.5, pose_noise=0.03,
                                       point_noise=0.08)
    j1, t1 = run_both(fields, stage_iters=(5, 0))
    fields2 = dict(fields, R=j1["R"], t=j1["t"], X=j1["X"])
    j2, t2 = run_both(fields2, stage_iters=(0, 5))
    for j, t in ((j1, t1), (j2, t2)):
        for k in ("R", "t"):
            np.testing.assert_allclose(t[k], j[k], atol=1e-4, err_msg=k)
        np.testing.assert_array_equal(t["inlier"], j["inlier"])
        c = constrained(fields, j, n_obs)
        np.testing.assert_allclose(t["X"][c], j["X"][c], atol=1e-4)
        # the fixed camera and the padding stay where they were
        np.testing.assert_array_equal(t["R"][0], fields["R"][0])
        np.testing.assert_array_equal(t["t"][6:], fields["t"][6:])

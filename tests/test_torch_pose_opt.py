"""The PyTorch port's robust pose LM against the JAX package on the
problems of tests/test_pose_opt.py (same numpy inputs). The LM's
accept/reject decisions and chi2 gates compare sums taken in another
order, so the poses are held to 1e-4 (far below the 1e-3..3e-2 the JAX
tests hold against the truth) and the inlier sets by agreement >= 0.99."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.optim import pose_opt as jp  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402
from xfeatslam_tpu_torch.optim import pose_opt as tp  # noqa: E402

from test_pose_opt import BF, CAM, make_problem  # noqa: E402

PORT_CAM = tc.Pinhole.from_list(CAM.params_list())


def t(x):
    return torch.tensor(np.asarray(x))


CASES = {
    "exact": dict(noise_px=0.0),
    "noise": dict(noise_px=0.5),
    "outliers": dict(noise_px=0.3, outlier_frac=0.25),
    "stereo": dict(noise_px=0.2, stereo=True),
    "padded": dict(n=100, noise_px=0.2, pad=60),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pose_optimization_matches_jax(rng, case):
    kw = dict(CASES[case])
    pad = kw.pop("pad", 0)
    stereo = kw.get("stereo", False)
    X, uv, ur, (R_true, t_true), is_out = make_problem(rng, **kw)
    n = len(X)
    X = np.concatenate([X, np.zeros((pad, 3), np.float32)])
    uv = np.concatenate([uv, np.zeros((pad, 2), np.float32)])
    ur = np.concatenate([ur, np.zeros(pad, np.float32)])
    valid = np.arange(n + pad) < n
    inv_sigma2 = np.ones(n + pad, np.float32)
    is_stereo = np.full(n + pad, stereo)
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    args = (R0, t0, X, uv, ur, inv_sigma2, is_stereo, valid)
    ref = jp.pose_optimization(*map(jnp.asarray, args), CAM, jnp.float32(BF))
    got = tp.pose_optimization(*map(t, args), PORT_CAM, BF)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)
    inl = got.inliers.numpy()
    assert (inl == np.asarray(ref.inliers)).mean() >= 0.99
    assert not inl[n:].any()
    assert got.num_inliers.dtype == torch.int32
    assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= 0.01 * n
    # and near the truth, at tests/test_pose_opt.py's loosest bars
    cos = (np.trace(got.R.numpy() @ R_true.T) - 1) / 2
    assert np.arccos(np.clip(cos, -1, 1)) < 5e-3
    assert np.linalg.norm(got.t.numpy() - t_true) < 3e-2
    if is_out.any():
        assert not inl[:n][is_out].any()

"""The PyTorch port's robust pose LM against the JAX package on the
problems of tests/test_pose_opt.py (same numpy inputs). The LM's
accept/reject decisions and chi2 gates compare sums taken in another
order, so the poses are held to 1e-4 (far below the 1e-3..3e-2 the JAX
tests hold against the truth) and the inlier sets by agreement >= 0.99.

On CPU tensors ``pose_optimization`` is the plain version of the
``pose_lm`` kernel (``ops/cuda_kernels.pose_lm_plain``) and counts no
launch. The kernel itself runs only on the card (``chip_smoke.py`` holds it
to the plain version there); here its wrapper's CUDA branch is driven with
the library call recorded instead of made: wrong dtypes, shapes, layouts
and too many edges raise before the call, and a good call hands the kernel
the tensors' pointers, the sizes and the camera."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.optim import pose_opt as jp  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402
from xfeatslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
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


def _problem(n=120, stereo=True):
    X, uv, ur, _, _ = make_problem(np.random.default_rng(3), n=n,
                                   noise_px=0.3, outlier_frac=0.1,
                                   stereo=stereo)
    return (torch.eye(3), torch.zeros(3), t(X), t(uv), t(ur),
            torch.ones(n), torch.full((n,), stereo), torch.ones(n,
                                                                 dtype=bool))


def test_cpu_tensors_take_the_plain_path():
    """On CPU tensors pose_optimization is the kernel's plain version, bit
    for bit, and counts no launch; it still matches the JAX package."""
    args = _problem()
    before = ck.pose_lm.launches
    got = tp.pose_optimization(*args, PORT_CAM, BF)
    assert ck.pose_lm.launches == before
    plain = ck.pose_lm_plain(*args, PORT_CAM, BF)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    ref = jp.pose_optimization(*(jnp.asarray(a.numpy()) for a in args), CAM,
                               jnp.float32(BF))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)
    assert (got.inliers.numpy() == np.asarray(ref.inliers)).mean() >= 0.99


@pytest.fixture
def as_if_on_cuda(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors, with the library call
    recorded instead of made."""
    calls = []
    monkeypatch.setattr(ck, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(ck, "_launch", lambda fn, dev, *a: calls.append(
        (fn, a)))
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    return calls


BAD_INPUTS = {
    "R0 float64": (0, lambda a: a.double(), TypeError),
    "t0 shape": (1, lambda a: torch.zeros(4), ValueError),
    "Xw dtype": (2, lambda a: a.half(), TypeError),
    "Xw rows": (2, lambda a: a[:-1], ValueError),
    "obs_uv shape": (3, lambda a: a[:, :1].contiguous(), ValueError),
    "obs_ur 2-D": (4, lambda a: a[:, None], ValueError),
    "inv_sigma2 dtype": (5, lambda a: a.double(), TypeError),
    "is_stereo not bool": (6, lambda a: a.to(torch.uint8), TypeError),
    "valid rows": (7, lambda a: a[:-2], ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_wrapper_checks_raise_before_the_library(as_if_on_cuda, case):
    pos, bad, err = BAD_INPUTS[case]
    args = list(_problem())
    args[pos] = bad(args[pos])
    with pytest.raises(err):
        ck.pose_lm(*args, PORT_CAM, BF)
    assert as_if_on_cuda == []


def test_wrapper_packs_strided_inputs(as_if_on_cuda):
    """Views (a transposed rotation, a column-major Xw) reach the kernel as
    packed copies with the same values."""
    args = list(_problem())
    args[0] = torch.eye(3).t()
    Xw = args[2].t().contiguous().t()
    args[2] = Xw
    assert not Xw.is_contiguous()
    ck.pose_lm(*args, PORT_CAM, BF)
    (fn, a), = as_if_on_cuda
    assert a[2] != Xw.data_ptr() and a[3] == args[3].data_ptr()


def test_wrapper_refuses_too_many_edges(as_if_on_cuda):
    n = ck.POSE_LM_MAX_EDGES + 1
    args = (torch.eye(3), torch.zeros(3), torch.zeros(n, 3),
            torch.zeros(n, 2), torch.zeros(n), torch.ones(n),
            torch.zeros(n, dtype=bool), torch.ones(n, dtype=bool))
    with pytest.raises(ValueError, match="edges"):
        ck.pose_lm(*args, PORT_CAM, BF)
    assert as_if_on_cuda == []


def test_wrapper_passes_the_kernel_its_arguments(as_if_on_cuda):
    args = _problem(n=77)
    before = ck.pose_lm.launches
    R, tt, inl, num, chi2 = ck.pose_lm(*args, PORT_CAM, BF, rounds=3,
                                       iters=7)
    assert ck.pose_lm.launches == before + 1
    (fn, a), = as_if_on_cuda
    assert fn == "pose_lm"
    ptrs = [x.data_ptr() for x in args] + [x.data_ptr()
                                           for x in (R, tt, inl, num, chi2)]
    assert list(a[:13]) == ptrs
    assert a[13:16] == (77, 3, 7)
    assert a[16:] == (PORT_CAM.fx, PORT_CAM.fy, PORT_CAM.cx, PORT_CAM.cy, BF)
    assert (R.shape, tt.shape, inl.shape, num.shape, chi2.shape) == (
        (3, 3), (3,), (77,), (), (77,))
    assert inl.dtype == torch.bool and num.dtype == torch.int32

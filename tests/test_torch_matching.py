"""The PyTorch port's matching ops against the JAX package on the same
numpy inputs, including the planted correspondences of
tests/test_pallas_kernels.py::TestMutualNNPairs. The Pallas kernel runs in
interpret mode; the port's wrapper takes its plain version on CPU
tensors."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# float32 parity: no TF32 in convolutions or matmuls, should a GPU be used
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.ops import matching as jm  # noqa: E402
from xfeatslam_tpu.ops import pallas_kernels as pk  # noqa: E402
from xfeatslam_tpu.parallel import batched as jb  # noqa: E402
from xfeatslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from xfeatslam_tpu_torch.ops import matching as tm  # noqa: E402
from xfeatslam_tpu_torch.parallel import batched as tb  # noqa: E402


def t(x):
    return torch.tensor(np.asarray(x))


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def planted_frames(rng, B=4, K=300, D=64):
    """Frames whose first 150 descriptors continue into the next frame."""
    d = unit(rng.standard_normal((B, K, D)).astype(np.float32))
    d[1:, :150] = d[:-1, :150] + 0.01 * rng.standard_normal(
        (B - 1, 150, D)).astype(np.float32)
    d = unit(d).astype(np.float32)
    return d, rng.uniform(size=(B, K)) > 0.1


def test_mutual_nn_pairs_matches_pallas(rng):
    d, valid = planted_frames(rng)
    vb = valid[1:].copy()
    vb[0] = False  # a frame with no valid column: s1 = -inf, idx 0
    ref = [np.asarray(x) for x in pk.mutual_nn_pairs(
        jnp.asarray(d[:-1]), jnp.asarray(d[1:]), jnp.asarray(valid[:-1]),
        jnp.asarray(vb), interpret=True)]
    got = [x.numpy() for x in ck.mutual_nn_pairs(
        t(d[:-1]), t(d[1:]), t(valid[:-1]), t(vb))]
    best, second, idx, col_best = got
    assert idx.dtype == np.int32 and col_best.dtype == np.int32
    np.testing.assert_array_equal(idx, ref[2])
    np.testing.assert_array_equal(col_best, ref[3])
    assert np.isinf(best[0]).all() and np.isinf(second[0]).all()
    f = np.isfinite(ref[0])
    np.testing.assert_array_equal(np.isfinite(best), f)
    np.testing.assert_allclose(best[f], ref[0][f], atol=1e-3)
    f2 = np.isfinite(ref[1])
    np.testing.assert_allclose(second[f2], ref[1][f2], atol=1e-3)


@pytest.mark.parametrize("fused", [False, True])
def test_match_consecutive_matches_jax(rng, fused):
    d, valid = planted_frames(rng)
    ref = jb.match_consecutive(jnp.asarray(d), jnp.asarray(valid), fused=fused)
    got = tb.match_consecutive(t(d), t(valid))
    m = np.asarray(ref.mask)
    assert m.any()
    np.testing.assert_array_equal(got.mask.numpy(), m)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_allclose(got.dist.numpy()[m], np.asarray(ref.dist)[m],
                               atol=1e-3)


@pytest.mark.parametrize("binary", [False, True])
def test_match_mutual_nn_matches_jax(rng, binary):
    N, M, D = 333, 257, 64
    if binary:
        a = (rng.uniform(size=(N, D)) > 0.5).astype(np.float32)
        b = a[rng.permutation(N)[:M]].copy()
        flip = rng.uniform(size=b.shape) < 0.05
        b[flip] = 1.0 - b[flip]
        kw = dict(max_dist=10.0, ratio=0.9)
    else:
        a = unit(rng.standard_normal((N, D)).astype(np.float32))
        b = unit(rng.standard_normal((M, D)).astype(np.float32))
        b[:100] = unit(a[:100] + 0.01 * rng.standard_normal((100, D)).astype(
            np.float32))
        kw = dict(max_dist=200.0, ratio=0.95)
    va = np.ones(N, bool)
    va[7::50] = False
    vb = np.ones(M, bool)
    vb[3::40] = False
    ref = jm.match_mutual_nn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va),
                             jnp.asarray(vb), binary=binary, fused=False, **kw)
    got = tm.match_mutual_nn(t(a), t(b), t(va), t(vb), binary=binary, **kw)
    m = np.asarray(ref.mask)
    assert m.sum() > 20
    np.testing.assert_array_equal(got.mask.numpy(), m)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(ref.dist),
                               atol=1e-3)


def test_distance_matrices_match_jax(rng):
    a = unit(rng.standard_normal((40, 64)).astype(np.float32))
    b = unit(rng.standard_normal((30, 64)).astype(np.float32))
    np.testing.assert_allclose(
        tm.xfeat_distance_matrix(t(a), t(b)).numpy(),
        np.asarray(jm.xfeat_distance_matrix(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-3)
    ab = (a > 0).astype(np.float32)
    bb = (b > 0).astype(np.float32)
    np.testing.assert_array_equal(
        tm.hamming_distance_matrix(t(ab), t(bb)).numpy(),
        np.asarray(jm.hamming_distance_matrix(jnp.asarray(ab),
                                              jnp.asarray(bb))))


def test_best_two_single_column():
    dist = torch.tensor([[3.0], [1.0]])
    best, second, idx = tm._best_two(dist)
    assert best.tolist() == [3.0, 1.0] and idx.tolist() == [0, 0]
    assert (second == tm.INVALID).all()

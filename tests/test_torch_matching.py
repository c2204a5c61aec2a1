"""The PyTorch port's matching ops against the JAX package on the same
numpy inputs, including the planted correspondences of
tests/test_pallas_kernels.py::TestMutualNNPairs and the cases of its
TestSimilarityTop2. The Pallas kernels run in interpret mode; the port's
wrappers take their plain versions on CPU tensors. Similarities agree to
1e-6 (float32 dot products of unit vectors summed in another order) and
distances, which scale them by 1024, to 1e-3; indices and masks exactly."""

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

from chip_smoke import TIE_CASES, tie_banks  # noqa: E402


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


# ---------------------------------------------------------------------------
# kernel 4: similarity_top2 and the single-pair fused matcher route


def _unit_pair(rng, N, M, D=64):
    a = unit(rng.standard_normal((N, D)).astype(np.float32))
    b = unit(rng.standard_normal((M, D)).astype(np.float32))
    return a, b


def test_similarity_top2_matches_pallas(rng):
    """TestSimilarityTop2::test_matches_xla_reference: N=512, M=384."""
    a, b = _unit_pair(rng, 512, 384)
    ref = [np.asarray(x) for x in pk.similarity_top2(
        jnp.asarray(a), jnp.asarray(b), interpret=True)]
    ck.reset_launch_counts()
    s1, s2, i1 = (x.numpy() for x in ck.similarity_top2(t(a), t(b)))
    assert ck.similarity_top2.launches == 0  # CPU tensors: the plain version
    assert i1.dtype == np.int32
    np.testing.assert_array_equal(i1, ref[2])
    np.testing.assert_allclose(s1, ref[0], atol=1e-6)
    np.testing.assert_allclose(s2, ref[1], atol=1e-6)


def test_best_two_distances_self_match(rng):
    """TestSimilarityTop2::test_distance_mapping: a bank against itself."""
    a, _ = _unit_pair(rng, 256, 1)
    ref = [np.asarray(x) for x in pk.xfeat_best_two_distances(
        jnp.asarray(a), jnp.asarray(a), interpret=True)]
    d1, d2, i1 = (x.numpy() for x in ck.xfeat_best_two_distances(t(a), t(a)))
    np.testing.assert_array_equal(i1, np.arange(256))
    np.testing.assert_array_equal(i1, ref[2])
    np.testing.assert_allclose(d1, ref[0], atol=1e-3)
    np.testing.assert_allclose(d2, ref[1], atol=1e-3)
    assert (d2 > d1).all()


def test_best_two_distances_ragged_rows_and_masks(rng):
    """TestSimilarityTop2::test_row_padding_and_column_mask (N=300, not a
    multiple of the TPU row tile), plus masked rows (inf) and a bank with
    no valid column (s1 = s2 = -inf, i1 = 0)."""
    a, b = _unit_pair(rng, 300, 200)
    va = np.ones(300, bool)
    va[5::17] = False
    vb = np.ones(200, bool)
    vb[::3] = False
    for valid_b in (vb, np.zeros(200, bool)):
        ref = [np.asarray(x) for x in pk.xfeat_best_two_distances(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(va),
            jnp.asarray(valid_b), interpret=True)]
        got = [x.numpy() for x in ck.xfeat_best_two_distances(
            t(a), t(b), t(va), t(valid_b))]
        np.testing.assert_array_equal(got[2], ref[2])
        for g, r in zip(got[:2], ref[:2]):
            np.testing.assert_array_equal(np.isinf(g), np.isinf(r))
            f = np.isfinite(r)
            np.testing.assert_allclose(g[f], r[f], atol=1e-3)
    assert np.isinf(got[0]).all() and (got[2] == 0).all()
    s1, s2, i1 = ck.similarity_top2(t(a), t(b), t(np.zeros(200, bool)))
    assert torch.isneginf(s1).all() and torch.isneginf(s2).all()
    assert (i1 == 0).all()


def _planted_pair(rng, N=333, M=257, D=64):
    a, b = _unit_pair(rng, N, M, D)
    b[:100] = unit(a[:100] + 0.01 * rng.standard_normal((100, D)).astype(
        np.float32))
    va = np.ones(N, bool)
    va[7::50] = False
    vb = np.ones(M, bool)
    vb[3::40] = False
    return a, b, va, vb


def test_mutual_nn_top2_matches_pallas(rng):
    """col_best_row is the row pass of b against a: not masked by
    valid_b."""
    a, b, va, vb = _planted_pair(rng)
    ref = [np.asarray(x) for x in pk.mutual_nn_top2(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb),
        interpret=True)]
    got = [x.numpy() for x in ck.mutual_nn_top2(t(a), t(b), t(va), t(vb))]
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[3], ref[3])
    assert (got[3][~vb] != 0).any()  # invalid columns keep their best row
    f = np.isfinite(ref[0])
    np.testing.assert_array_equal(np.isfinite(got[0]), f)
    np.testing.assert_allclose(got[0][f], ref[0][f], atol=1e-3)


@pytest.mark.parametrize("fused", [True, False])
def test_match_mutual_nn_routes_match_jax(rng, fused):
    """TestSimilarityTop2::test_mutual_nn_matches_xla_path on both routes,
    each against the same JAX route: exact idx and mask, and each route's
    dist convention for invalid rows (inf on the kernel route, 1e9 on the
    distance-matrix route)."""
    a, b, va, vb = _planted_pair(rng)
    kw = dict(max_dist=200.0, ratio=0.95)
    ref = jm.match_mutual_nn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va),
                             jnp.asarray(vb), fused=fused, **kw)
    got = tm.match_mutual_nn(t(a), t(b), t(va), t(vb), fused=fused, **kw)
    m = np.asarray(ref.mask)
    assert m.sum() > 20
    np.testing.assert_array_equal(got.mask.numpy(), m)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    dist, rdist = got.dist.numpy(), np.asarray(ref.dist)
    invalid_dist = np.inf if fused else tm.INVALID
    assert (dist[~va] == invalid_dist).all() and (rdist[~va] == invalid_dist).all()
    np.testing.assert_allclose(dist[va], rdist[va], atol=1e-3)
    # the default on CPU tensors is the distance-matrix route
    dflt = tm.match_mutual_nn(t(a), t(b), t(va), t(vb), **kw)
    assert (dflt.dist.numpy()[~va] == tm.INVALID).all()


def test_match_consecutive_per_pair_matches_jax(rng):
    """fused=False: match_mutual_nn pair by pair, the JAX vmapped form."""
    d, valid = planted_frames(rng)
    ref = jb.match_consecutive(jnp.asarray(d), jnp.asarray(valid), fused=False)
    got = tb.match_consecutive(t(d), t(valid), fused=False)
    m = np.asarray(ref.mask)
    assert m.any() and got.idx.shape == (3, 300)
    np.testing.assert_array_equal(got.mask.numpy(), m)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(ref.dist),
                               atol=1e-3)


# ---------------------------------------------------------------------------
# exact ties, the cases chip_smoke.py holds the CUDA matchers to: the first
# column wins idx, the first valid row wins col_best


def _tie_counts(a, b, va, vb):
    """Rows whose best valid column is not unique, and valid columns whose
    best valid row is not unique (float64: the similarities are exact)."""
    sim = np.einsum("pnd,pmd->pnm", a.astype(np.float64), b.astype(np.float64))
    sim = np.where(vb[:, None, :], sim, -np.inf)
    rows = (sim == sim.max(2, keepdims=True)) & np.isfinite(sim)
    simv = np.where(va[:, :, None], sim, -np.inf)
    cols = (simv == simv.max(1, keepdims=True)) & np.isfinite(simv)
    return int((rows.sum(2) > 1).sum()), int((cols.sum(1) > 1).sum())


@pytest.mark.parametrize("case", TIE_CASES)
def test_mutual_nn_pairs_ties_match_pallas(case):
    a, b, va, vb = tie_banks(np.random.default_rng(7), case, 2, 48, 48)
    row_ties, col_ties = _tie_counts(a, b, va, vb)
    assert row_ties > 0 and col_ties > 0
    ref = pk.mutual_nn_pairs(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va),
                             jnp.asarray(vb), interpret=True)
    got = ck.mutual_nn_pairs(t(a), t(b), t(va), t(vb))
    # every similarity is exact, so the distances are equal too
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("case", TIE_CASES)
def test_best_two_distances_ties_match_pallas(case):
    a, b, va, vb = (x[0] for x in tie_banks(np.random.default_rng(7), case,
                                            1, 48, 40))
    assert _tie_counts(a[None], b[None], va[None], vb[None])[0] > 0
    ref = pk.xfeat_best_two_distances(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(va), jnp.asarray(vb),
                                      interpret=True)
    got = ck.xfeat_best_two_distances(t(a), t(b), t(va), t(vb))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    _, s2, i1 = ck.similarity_top2(t(a), t(b), t(vb))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ref[2]))
    if case == "duplicate columns":  # a tie at the best gives s2 = s1
        s1 = ck.similarity_top2(t(a), t(b), t(vb))[0]
        assert (s2 == s1).any()


# ---------------------------------------------------------------------------
# the projection, window, general and stereo searches (tie-free inputs:
# continuous random descriptors and positions)


def _assert_same_match(got, ref):
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(got.mask.numpy(), m)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(ref.dist),
                               atol=1e-3)
    return m


def _scene(rng, M=200, N=150, D=64):
    """Map points projected near keypoints, descriptors planted for the
    first 100 map points."""
    kpt_uv = rng.uniform(0, 300, (N, 2)).astype(np.float32)
    kd = unit(rng.standard_normal((N, D)).astype(np.float32))
    src = rng.permutation(N)[:100]
    pred = rng.uniform(0, 300, (M, 2)).astype(np.float32)
    pred[:100] = kpt_uv[src] + rng.normal(0, 3, (100, 2)).astype(np.float32)
    md = unit(rng.standard_normal((M, D)).astype(np.float32))
    md[:100] = unit(kd[src] + 0.3 * rng.standard_normal((100, D)).astype(
        np.float32))
    return (pred, md, rng.uniform(size=M) > 0.05, kpt_uv, kd,
            rng.uniform(size=N) > 0.05)


@pytest.mark.parametrize("gates", ["plain", "free_and_octave"])
def test_search_by_projection_matches_jax(rng, gates):
    pred, md, vm, kuv, kd, vk = _scene(rng)
    M, N = len(pred), len(kuv)
    radius = rng.uniform(6, 15, M).astype(np.float32)
    kw = {}
    if gates == "free_and_octave":
        oct_k = rng.integers(0, 3, N).astype(np.int32)
        lo = rng.integers(-1, 2, M).astype(np.int32)
        kw = dict(kpt_free=rng.uniform(size=N) > 0.2, kpt_octave=oct_k,
                  oct_lo=lo, oct_hi=lo + 1)
    ref = jm.search_by_projection(
        jnp.asarray(pred), jnp.asarray(md), jnp.asarray(vm), jnp.asarray(kuv),
        jnp.asarray(kd), jnp.asarray(vk), radius=jnp.asarray(radius),
        max_dist=1000.0, ratio=0.9, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tm.search_by_projection(
        t(pred), t(md), t(vm), t(kuv), t(kd), t(vk), radius=t(radius),
        max_dist=1000.0, ratio=0.9, **{k: t(v) for k, v in kw.items()})
    assert _assert_same_match(got, ref).sum() > 20
    # a scalar radius
    ref = jm.search_by_projection(
        jnp.asarray(pred), jnp.asarray(md), jnp.asarray(vm), jnp.asarray(kuv),
        jnp.asarray(kd), jnp.asarray(vk), radius=10.0)
    got = tm.search_by_projection(t(pred), t(md), t(vm), t(kuv), t(kd), t(vk),
                                  radius=10.0)
    _assert_same_match(got, ref)


def test_fuse_project_batched_matches_jax(rng):
    from xfeatslam_tpu.ops import lie as jl

    M, N, Nn = 120, 100, 3
    pos = np.stack([rng.uniform(-1, 1, M), rng.uniform(-1, 1, M),
                    rng.uniform(2, 5, M)], -1).astype(np.float32)
    desc = unit(rng.standard_normal((M, 64)).astype(np.float32))
    fx, fy, cx, cy = 517.3, 516.5, 318.6, 255.3
    Rs, ts, kuv, kd = [], [], [], []
    for _ in range(Nn):
        R, tt = (np.asarray(x) for x in jl.se3_exp(jnp.asarray(
            rng.normal(0, 0.05, 6).astype(np.float32))))
        Xc = pos @ R.T + tt
        uv = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx,
                       fy * Xc[:, 1] / Xc[:, 2] + cy], -1)
        sel = rng.permutation(M)[:N]
        Rs.append(R)
        ts.append(tt)
        kuv.append(uv[sel] + rng.normal(0, 1, (N, 2)))
        kd.append(unit(desc[sel] + 0.2 * rng.standard_normal((N, 64))))
    Rs, ts = np.stack(Rs), np.stack(ts)
    kuv = np.stack(kuv).astype(np.float32)
    kd = np.stack(kd).astype(np.float32)
    vk = rng.uniform(size=(Nn, N)) > 0.05
    alive = rng.uniform(size=M) > 0.05
    args = (pos, desc, alive, Rs, ts, kuv, kd, vk)
    ref = jm.fuse_project_batched(*map(jnp.asarray, args), fx, fy, cx, cy,
                                  radius=8.0, max_dist=1000.0)
    got = tm.fuse_project_batched(*map(t, args), fx, fy, cx, cy, radius=8.0,
                                  max_dist=1000.0)
    assert got.idx.shape == (Nn, M)
    assert _assert_same_match(got, ref).sum() > 30


def test_search_window_and_match_general_match_jax(rng):
    pred, md, vm, kuv, kd, vk = _scene(rng)
    ref = jm.search_window(jnp.asarray(pred), jnp.asarray(md), jnp.asarray(vm),
                           jnp.asarray(kuv), jnp.asarray(kd), jnp.asarray(vk),
                           radius=12.0, max_dist=1000.0)
    got = tm.search_window(t(pred), t(md), t(vm), t(kuv), t(kd), t(vk),
                           radius=12.0, max_dist=1000.0)
    assert _assert_same_match(got, ref).sum() > 20
    pair_mask = rng.uniform(size=(len(md), len(kd))) > 0.3
    for pm in (None, pair_mask):
        ref = jm.match_general(jnp.asarray(md), jnp.asarray(vm), jnp.asarray(kd),
                               jnp.asarray(vk), max_dist=1000.0, ratio=0.9,
                               pair_mask=None if pm is None else jnp.asarray(pm))
        got = tm.match_general(t(md), t(vm), t(kd), t(vk), max_dist=1000.0,
                               ratio=0.9, pair_mask=None if pm is None else t(pm))
        assert _assert_same_match(got, ref).sum() > 10


@pytest.mark.parametrize("binary", [True, False])
def test_stereo_match_rows_matches_jax(rng, binary):
    N, D = 160, 64
    kl = np.stack([rng.uniform(100, 600, N), rng.uniform(0, 480, N)],
                  -1).astype(np.float32)
    disp = rng.uniform(1, 100, N).astype(np.float32)
    perm = rng.permutation(N)
    kr = (kl - np.stack([disp, rng.normal(0, 0.5, N)], -1))[perm].astype(
        np.float32)
    if binary:
        dl = (rng.uniform(size=(N, D)) > 0.5).astype(np.float32)
        dr = dl[perm].copy()
        flip = rng.uniform(size=dr.shape) < 0.05
        dr[flip] = 1.0 - dr[flip]
        kw = dict(max_dist=75.0)
    else:
        dl = unit(rng.standard_normal((N, D)).astype(np.float32))
        dr = unit(dl[perm] + 0.05 * rng.standard_normal((N, D)).astype(
            np.float32))
        kw = dict(max_dist=200.0)
    ol = rng.integers(0, 2, N).astype(np.int32)
    orr = ol[perm]
    vl, vr = rng.uniform(size=N) > 0.05, rng.uniform(size=N) > 0.05
    args = (kl, dl, vl, ol, kr, dr, vr, orr)
    ref, rdisp = jm.stereo_match_rows(*map(jnp.asarray, args), binary=binary,
                                      **kw)
    got, gdisp = tm.stereo_match_rows(*map(t, args), binary=binary, **kw)
    assert _assert_same_match(got, ref).sum() > 50
    np.testing.assert_allclose(gdisp.numpy(), np.asarray(rdisp), atol=1e-4)


def test_rotation_consistency_filter_matches_jax(rng):
    n = 200
    ang_a = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    idx = rng.permutation(n)
    ang_b = (ang_a[np.argsort(idx)] - 0.3).astype(np.float32)
    ang_b[rng.uniform(size=n) < 0.3] = rng.uniform(0, 2 * np.pi)
    mask = rng.uniform(size=n) > 0.1
    ref = jm.rotation_consistency_filter(ang_a, ang_b, idx, mask)
    got = tm.rotation_consistency_filter(ang_a, ang_b, idx, mask)
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < mask.sum()
    zeros = np.zeros(n, np.float32)
    np.testing.assert_array_equal(
        tm.rotation_consistency_filter(zeros, zeros, idx, mask), mask)

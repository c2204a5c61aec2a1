"""The port's ORB backend (``xfeatslam_tpu_torch/models/orb.py``) against
the JAX package's ``xfeatslam_tpu/models/orb.py`` on the same seeded
images: a rendered room frame at 288x384 and a smoothed-noise image at
480x640.

Bars: level 0 exact (FAST scores and the 3x3 suppression at both
thresholds; the candidates' xy, scores, validity and order). Levels >= 1
are resized by the port's ``resize_bilinear`` (JAX's weights and order;
up to 2.3e-4 of 255 from ``jax.image.resize``, where XLA's own code
rounds a weight or sums a dot product in another order), so a FAST
comparison on those values could flip: per-level keypoint Jaccard >= 0.99,
keypoints compared as pixels of their level (measured: 1.0 at every level
of both images, candidates and the extractor's selections). The orientation moments and the blur at
rtol 1e-5 (atol 1e-5 of the map's largest value: the sums run in another
order); on JAX's keypoints the angles within 5e-7 rad at level 0 (exact
integer sums; XLA's atan2 and torch's part by an ulp) and at levels >= 1 within 1e-4 rad, or 2 / (|m10| + |m01|) where the
moments are small (their float32 sums of 961 terms differ by ~1 between the
two orders: measured 5.0e-4 rad on the noise image), and >= 99.99% of the
descriptor bits equal (measured 99.997%). The quadtree exactly as the
JAX package's native build (not its Python fallback, which picks other
keypoints on ties). The extractor end to end: the same keypoints at level
0 (positions and scores equal), per-level Jaccard as above, >= 99.99% of
the bits of the shared keypoints (measured 99.9988%)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# both packages resolve the BRIEF pattern when imported
os.environ["XFEATSLAM_BRIEF_PATTERN"] = "gaussian"

import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu import native as jnative  # noqa: E402
from xfeatslam_tpu.models import orb as jo  # noqa: E402
from xfeatslam_tpu_torch.models import orb as to  # noqa: E402
from xfeatslam_tpu_torch.utils import synthetic  # noqa: E402

N_FEATURES = 1000
LEVEL_JACCARD = 0.99
BIT_AGREEMENT = 0.9999


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noise_image(hw, seed):
    """Smoothed uniform noise in [0, 255], integer-valued (a camera image)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, hw).astype(np.float32)
    for _ in range(2):
        x = (x + np.roll(x, 1, 0) + np.roll(x, 1, 1)
             + np.roll(x, -1, 0) + np.roll(x, -1, 1)) / 5.0
    x = (x - x.min()) / (x.max() - x.min()) * 255.0
    return np.round(x).astype(np.uint8)


IMAGES = {
    "room_288x384": lambda: synthetic.make_sequence(
        n_frames=1, hw=(288, 384))["images"][0],
    "noise_480x640": lambda: _noise_image((480, 640), 3),
}


@pytest.fixture(scope="module", params=sorted(IMAGES))
def case(request):
    """One image through both packages' stages and extractors."""
    img = IMAGES[request.param]()
    x = img.astype(np.float32)
    ex = to.ORBExtractor(nfeatures=N_FEATURES, device="cpu")
    sizes, caps, mins = ex.geometry(*img.shape)
    jc = [tuple(np.asarray(a) for a in lvl) for lvl in jo.orb_candidates(
        jnp.asarray(x), sizes, caps, mins, jnp.float32(20.0),
        jnp.float32(7.0))]
    tc = [tuple(a.numpy() for a in lvl) for lvl in to.orb_candidates(
        torch.from_numpy(x), sizes, caps, mins, 20.0, 7.0)[0]]
    return {"name": request.param, "img": img, "x": x, "sizes": sizes,
            "jax_cands": jc, "port_cands": tc,
            "jax_out": jo.ORBExtractor(nfeatures=N_FEATURES)(img),
            "port_out": ex(img)}


def test_patterns_agree():
    np.testing.assert_array_equal(to._PATTERN, jo._PATTERN)
    assert to._PATTERN.shape == (256, 4)


@pytest.mark.parametrize("thr", [20.0, 7.0])
def test_fast_and_nms_level0_exact(case, thr):
    x = case["x"]
    sj = np.asarray(jo.fast_score_map(jnp.asarray(x), jnp.float32(thr)))
    st = to.fast_score_map(torch.from_numpy(x), thr).numpy()
    np.testing.assert_array_equal(st, sj)
    assert (sj > 0).sum() > 100
    mj = np.asarray(jo.nms3_mask(jnp.asarray(sj)))
    mt = to.nms3_mask(torch.from_numpy(sj.copy())).numpy()
    np.testing.assert_array_equal(mt, mj)


def test_candidates_level0_exact_with_order(case):
    (xj, sj, vj), (xt, st, vt) = case["jax_cands"][0], case["port_cands"][0]
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(xt, xj)
    # integer scores tie often: the order among ties is the JAX one
    assert len(np.unique(sj[vj])) < vj.sum()


def _pix(xy, valid):
    """Keypoints as pixels: the sub-pixel offset follows the FAST response,
    which the resized levels move by up to 3e-5."""
    return {tuple(p) for p in np.round(xy[valid]).astype(np.int64)}


def _jaccard(a, b):
    return len(a & b) / max(len(a | b), 1)


def test_candidates_levels_jaccard(case):
    for lvl in range(1, len(case["sizes"])):
        (xj, _, vj), (xt, _, vt) = (case["jax_cands"][lvl],
                                    case["port_cands"][lvl])
        j = _jaccard(_pix(xj, vj), _pix(xt, vt))
        assert j >= LEVEL_JACCARD, (case["name"], lvl, j)


def test_orientation_and_blur(case):
    x = case["x"]
    for lvl, (h, w) in enumerate(case["sizes"][:3]):
        xt = to._level_image(torch.from_numpy(x), lvl, h, w)
        xn = xt.numpy()
        jm = [np.asarray(a) for a in jo.orientation_maps(jnp.asarray(xn))]
        tm = [a.numpy() for a in to.orientation_maps(xt)]
        for a, b in zip(tm, jm):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max())
        jb = np.asarray(jo.blur7(jnp.asarray(xn)))
        np.testing.assert_allclose(to.blur7(xt).numpy(), jb, rtol=1e-5,
                                   atol=1e-5 * np.abs(jb).max())


def test_describe_on_jax_keypoints(case):
    x = case["x"]
    n_bits = n_same = 0
    for lvl, (h, w) in enumerate(case["sizes"]):
        xy, _, va = case["jax_cands"][lvl]
        xt = to._level_image(torch.from_numpy(x), lvl, h, w)
        xn = xt.numpy()
        m10, m01 = jo.orientation_maps(jnp.asarray(xn))
        dj, aj = jo.describe(jo.blur7(jnp.asarray(xn)), m10, m01,
                             jnp.asarray(xy), jnp.asarray(va), xy.shape[0])
        t10, t01 = to.orientation_maps(xt)
        dt, at = to.describe(to.blur7(xt), t10, t01,
                             torch.from_numpy(xy.copy()),
                             torch.from_numpy(va.copy()))
        dj, aj, dt, at = (np.asarray(dj), np.asarray(aj), dt.numpy(),
                          at.numpy())
        xi = np.clip(xy[:, 0].astype(np.int32), 0, w - 1)
        yi = np.clip(xy[:, 1].astype(np.int32), 0, h - 1)
        mag = (np.abs(np.asarray(m10)[yi, xi])
               + np.abs(np.asarray(m01)[yi, xi]))
        d = np.abs(np.angle(np.exp(1j * (at - aj))))
        if lvl == 0:
            # integer images: the moments are exact sums, and the two
            # atan2 implementations part by an ulp at most
            assert d[va].max() <= 5e-7, d[va].max()
        else:
            # the moments' float32 sums differ by ~1 (of ~3e5): 1e-4 rad
            # where the moment is large, 2/|m| where it is not
            bar = np.maximum(1e-4, 2.0 / np.maximum(mag, 1.0))
            assert (d[va] <= bar[va]).all(), (lvl, (d - bar)[va].max())
        n_bits += dj[va].size
        n_same += int((dj[va] == dt[va]).sum())
        # invalid rows are zero in both
        assert not dt[~va].any() and not dj[~va].any()
    assert n_same >= BIT_AGREEMENT * n_bits, n_same / n_bits


def _quadtree_draw(rng):
    n = int(rng.integers(50, 3001))
    x0, y0, x1, y1 = 19.0, 19.0, 621.0, 461.0
    xy = rng.uniform((x0, y0), (x1, y1), (n, 2)).astype(np.float32)
    if rng.random() < 0.5:
        xy = np.round(xy * 2) / 2  # a half-pixel grid: points on split lines
    # some points exactly on the bounds
    k = max(1, n // 20)
    xy[:k, 0] = rng.choice([x0, x1], k)
    xy[k:2 * k, 1] = rng.choice([y0, y1], k)
    scores = rng.integers(1, 60, n).astype(np.float32)  # many ties
    return xy.astype(np.float32), scores, int(rng.integers(20, 401)), (
        x0, y0, x1, y1)


def test_quadtree_matches_native():
    """200 draws, n in 50-3000 over 640x480, integer scores, half on a
    half-pixel grid, points on the bounds: the port's build against the
    JAX package's native one, index for index."""
    rng = np.random.default_rng(11)
    assert jnative.get_lib() is not None, "the JAX native quadtree did not build"
    for i in range(200):
        xy, sc, n_target, bounds = _quadtree_draw(rng)
        want = jnative.quadtree_select(xy, sc, n_target, bounds)
        got = to.distribute_quadtree(xy, sc, n_target, bounds)
        np.testing.assert_array_equal(got, want, err_msg=f"draw {i}")
    # fewer points than the budget: all of them
    np.testing.assert_array_equal(
        to.distribute_quadtree(xy[:5], sc[:5], 10, bounds), np.arange(5))


def test_extractor_end_to_end(case):
    oj, ot = case["jax_out"], case["port_out"]
    for k in ("kpts", "scores", "desc", "valid", "octave", "angle"):
        assert ot[k].shape == oj[k].shape and ot[k].dtype == oj[k].dtype, k
    assert ot["valid"].sum() >= 0.9 * oj["valid"].sum() > 0
    vj, vt = oj["valid"][0], ot["valid"][0]

    def keyed(o, v):
        """(octave, pixel at that level) -> row."""
        octv = o["octave"][0][v]
        xy = o["kpts"][0][v] / 1.2 ** octv[:, None]
        return {(int(oc), tuple(np.round(p).astype(np.int64))): i
                for i, (p, oc) in enumerate(zip(xy, octv))}

    kj, kt = keyed(oj, vj), keyed(ot, vt)
    for lvl in range(len(case["sizes"])):
        a = {k for k in kj if k[0] == lvl}
        b = {k for k in kt if k[0] == lvl}
        if lvl == 0:
            assert a == b
            # and their sub-pixel positions, scores and angles
            for key in ("kpts", "scores"):
                np.testing.assert_array_equal(
                    ot[key][0][vt][[kt[k] for k in sorted(a)]],
                    oj[key][0][vj][[kj[k] for k in sorted(a)]])
        else:
            assert _jaccard(a, b) >= LEVEL_JACCARD, (lvl, _jaccard(a, b))
    shared = sorted(set(kj) & set(kt))
    dj = oj["desc"][0][vj][[kj[k] for k in shared]]
    dt = ot["desc"][0][vt][[kt[k] for k in shared]]
    assert (dj == dt).mean() >= BIT_AGREEMENT
    # the host's final order is by score, as numpy sorts it
    assert np.all(np.diff(ot["scores"][0][vt]) <= 0)


def test_orb_is_binary_and_on_level_grid(case):
    o = case["port_out"]
    v = o["valid"][0]
    assert set(np.unique(o["desc"][0][v])) <= {0.0, 1.0}
    assert o["octave"][0][v].max() < to.N_LEVELS
    assert not o["desc"][0][~v].any()

"""The plain twins of the ORB kernels (``ops/cuda_kernels.orb_fast_plain``
and ``orb_describe_plain``, which the CPU runs and ``chip_smoke.py`` holds
``csrc/orb_fast.cu`` and ``csrc/orb_describe.cu`` to on the card) against
the JAX package's ``fast_score_map`` / ``nms3_mask`` and
``orientation_maps`` / ``blur7`` / ``describe``, on levels 0-2 of a
rendered 384x288 frame (each level image the port's, handed to both
packages). ``orb_fast`` takes the level-0 image and the level sizes and
returns the levels as one flat buffer (equal to ``models/orb._level_image``
here); ``orb_describe`` takes the level images, keypoints, flags and the
pattern, and blurs at the samples itself.

Bars: level 0 exact (integer pixels: FAST scores, survivors, counts; the
angles within 5e-7 rad, an ulp of atan2 between XLA and torch on equal
moments). Levels 1-2 hold non-integer pixels: the FAST scores within 1e-5
relative (16 terms summed in circle order here, in XLA's order there),
survivors by Jaccard >= 0.95 (tests/test_torch_orb.py's level bar), the
angles within max(1e-4, 2 / (|m10| + |m01|)) rad and >= 99% of the bits,
as there. The wrappers on CPU tensors run the twins and launch nothing."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# both packages resolve the BRIEF pattern when imported
os.environ["XFEATSLAM_BRIEF_PATTERN"] = "gaussian"

import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.models import orb as jo  # noqa: E402
from xfeatslam_tpu_torch.models import orb as to  # noqa: E402
from xfeatslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from xfeatslam_tpu_torch.utils import synthetic  # noqa: E402

HW, LEVELS, THR = (288, 384), 3, (20.0, 7.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jaccard(a, b):
    return (a & b).sum() / max((a | b).sum(), 1)


@pytest.fixture(scope="module")
def levels():
    """Levels 0-2 of a rendered frame, the port's resize, and both
    packages' FAST outputs on them."""
    img = synthetic.make_sequence(n_frames=1, hw=HW)["images"][0]
    ex = to.ORBExtractor(nfeatures=1000, device="cpu")
    sizes = ex.geometry(*img.shape)[0][:LEVELS]
    x0 = torch.from_numpy(img.astype(np.float32))
    ck.reset_launch_counts()
    flat, scores, masked, counts = ck.orb_fast(x0, sizes, *THR, to.EDGE)
    launches = ck.launch_counts()
    xs = ck.level_views(flat, sizes)
    jax_out = []
    for x in xs:
        h, w = x.shape
        s = [np.asarray(jo.fast_score_map(jnp.asarray(x.numpy()),
                                          jnp.float32(t))) for t in THR]
        yy, xx = np.mgrid[0:h, 0:w]
        inb = ((yy >= jo.EDGE) & (yy < h - jo.EDGE) & (xx >= jo.EDGE)
               & (xx < w - jo.EDGE))
        m = [np.asarray(jo.nms3_mask(jnp.asarray(si))) & inb for si in s]
        jax_out.append((np.stack(s), np.stack(m)))
    return dict(x0=x0, sizes=sizes, xs=xs, scores=scores, masked=masked,
                counts=counts, jax=jax_out, launches=launches)


def test_wrapper_on_cpu_runs_the_twin(levels):
    assert set(levels["launches"].values()) == {0}
    xs, x0, sizes = levels["xs"], levels["x0"], levels["sizes"]
    # the levels: level 0 the image, the others resize_bilinear's
    for lvl, (h, w) in enumerate(sizes):
        np.testing.assert_array_equal(
            xs[lvl].numpy(), to._level_image(x0, lvl, h, w).numpy())
    f, s, m, c = ck.orb_fast_plain(x0, sizes, *THR, to.EDGE)
    for a, b in zip([f] + s + m,
                    [torch.cat([x.reshape(-1) for x in xs])]
                    + levels["scores"] + levels["masked"]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert c.dtype == torch.int32 and c.shape == (LEVELS,)
    for lvl, (sc, mk) in enumerate(zip(levels["scores"], levels["masked"])):
        assert sc.shape == mk.shape == (2,) + tuple(xs[lvl].shape)
        # the masked maps are the scores at the survivors, -1 elsewhere
        keep = mk.numpy() >= 0
        np.testing.assert_array_equal(mk.numpy()[keep], sc.numpy()[keep])
        assert (mk.numpy()[~keep] == -1).all()
        assert int(c[lvl]) == keep[0].sum()


def test_orb_fast_level0_exact(levels):
    js, jm = levels["jax"][0]
    np.testing.assert_array_equal(levels["scores"][0].numpy(), js)
    np.testing.assert_array_equal(levels["masked"][0].numpy() >= 0, jm)
    assert int(levels["counts"][0]) == jm[0].sum() > 100


@pytest.mark.parametrize("lvl", [1, 2])
def test_orb_fast_levels(levels, lvl):
    js, jm = levels["jax"][lvl]
    s = levels["scores"][lvl].numpy()
    np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-4)
    m = levels["masked"][lvl].numpy() >= 0
    for t in range(2):
        assert _jaccard(m[t], jm[t]) >= 0.95, (lvl, t)
    assert m[1].sum() >= m[0].sum() > 10


def _describe_case(levels, lvl):
    """Keypoints of the level (its survivors at the minimum threshold, at
    most 300) through both packages' moments and descriptors."""
    x = levels["xs"][lvl]
    ys, xs_ = np.nonzero(levels["masked"][lvl].numpy()[1] >= 0)
    kp = np.stack([xs_, ys], -1)[:300].astype(np.float32) + 0.3
    valid = np.arange(len(kp)) % 7 != 3
    xt, kt, vt = x, torch.from_numpy(kp), torch.from_numpy(valid)
    ck.reset_launch_counts()
    (desc, ang), = ck.orb_describe([xt], [kt], [vt])
    assert set(ck.launch_counts().values()) == {0}
    xj = jnp.asarray(x.numpy())
    m10, m01 = jo.orientation_maps(xj)
    jd, ja = jo.describe(jo.blur7(xj), m10, m01, jnp.asarray(kp),
                         jnp.asarray(valid), len(kp))
    xi = np.clip(kp[:, 0].astype(int), 0, x.shape[1] - 1)
    yi = np.clip(kp[:, 1].astype(int), 0, x.shape[0] - 1)
    mag = np.abs(np.asarray(m10))[yi, xi] + np.abs(np.asarray(m01))[yi, xi]
    return (desc.numpy(), ang.numpy(), np.asarray(jd), np.asarray(ja), valid,
            mag)


def test_orb_describe_level0(levels):
    desc, ang, jd, ja, valid, _ = _describe_case(levels, 0)
    assert len(ang) >= 100
    np.testing.assert_allclose(ang, ja, rtol=0, atol=5e-7)
    assert (desc[~valid] == 0).all()
    assert (desc == jd).mean() >= 0.99


@pytest.mark.parametrize("lvl", [1, 2])
def test_orb_describe_levels(levels, lvl):
    desc, ang, jd, ja, valid, mag = _describe_case(levels, lvl)
    gap = np.abs(np.angle(np.exp(1j * (ang.astype(np.float64) - ja))))
    assert (gap <= np.maximum(1e-4, 2.0 / np.maximum(mag, 1e-9))).all()
    assert (desc[valid] == jd[valid]).mean() >= 0.99
    assert set(np.unique(desc)) <= {0.0, 1.0}

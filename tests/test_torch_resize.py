"""The port's ``ops/image.resize_bilinear`` against ``jax.image.resize(...,
"bilinear")``, which the JAX package calls for the ORB pyramid levels
(``models/orb.py``) and the extractor's resize to a multiple of 32
(``ops/image.resize_bilinear``).

Shapes: the 7 levels above 0 (x1.2) of 640x480, 752x480 and 384x288 as
the ORB extractor sizes them, the extractor's 500x700 -> 480x672
(batched, 3 channels), and one upsample. Bars: bit equality where it is
reached (the upsample of a 2-D image, the extractor's and the upsample's
weights); elsewhere the recorded gap. The port builds JAX's weights with
the float32 operations XLA:CPU compiles them to, but XLA's vectorized loops round a few weights
in other ways at some columns (up to 4.8e-7 apart, measured), and its dot
products sum a few outputs in another order (blocked at some lengths), so
a shrunk image is within 1e-6 of its largest value of JAX's (measured
8.97e-7), and the weights within 5e-7."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu_torch.ops import image as ti  # noqa: E402

SCALE = 1.2
ORB_IMAGES = ((480, 640), (480, 752), (288, 384))
IMAGE_GAP = 1e-6     # of the image's largest value
WEIGHT_GAP = 5e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _levels(H, W):
    """The ORB extractor's level sizes above 0 (``ORBExtractor._level_sizes``)."""
    return [(int(round(H / SCALE ** l)), int(round(W / SCALE ** l)))
            for l in range(1, 8)]


def _jax_resize(x, hw):
    return np.asarray(jax.image.resize(jnp.asarray(x), hw, "bilinear"))


def _port_resize(x, hw):
    t = torch.from_numpy(x)[None, :, :, None]
    return ti.resize_bilinear(t, hw)[0, :, :, 0].numpy()


def _jax_weights(n_in, n_out):
    """The weights of one axis as jax.image.resize applies them: an identity
    image resized along its rows only gives them exactly (each output is
    one weight times 1, plus zeros)."""
    return _jax_resize(np.eye(n_in, dtype=np.float32), (n_out, n_in)).T


LEVEL_CASES = [(src, dst) for src in ORB_IMAGES for dst in _levels(*src)]


@pytest.mark.parametrize("src,dst", LEVEL_CASES,
                         ids=[f"{s[1]}x{s[0]}-level{i % 7 + 1}"
                              for i, (s, _) in enumerate(LEVEL_CASES)])
def test_orb_levels_match_jax(src, dst):
    """A camera image (integers 0-255, as the ORB extractor feeds it)."""
    rng = np.random.default_rng(hash(dst) % 2 ** 32)
    x = rng.integers(0, 256, size=src).astype(np.float32)
    got, ref = _port_resize(x, dst), _jax_resize(x, dst)
    assert got.shape == ref.shape == dst and got.dtype == np.float32
    gap = np.abs(got - ref).max()
    assert gap <= IMAGE_GAP * 255.0, gap


def test_extractor_resize_matches_jax():
    """The extractor's resize to a multiple of 32, batched with channels,
    on [0, 1] images: (2, 500, 700, 3) -> (2, 480, 672, 3)."""
    rng = np.random.default_rng(5)
    x = (rng.integers(0, 256, size=(2, 500, 700, 3)) / 255.0).astype(
        np.float32)
    got = ti.resize_bilinear(torch.from_numpy(x), (480, 672)).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 480, 672, 3),
                                      "bilinear"))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= IMAGE_GAP, np.abs(got - ref).max()


def test_upsample_is_bit_exact():
    """An image upsampled as the ORB levels are resized (one 2-D image):
    the same bits as JAX's."""
    rng = np.random.default_rng(6)
    x = rng.uniform(size=(48, 64)).astype(np.float32)
    np.testing.assert_array_equal(_port_resize(x, (96, 128)),
                                  _jax_resize(x, (96, 128)))


@pytest.mark.parametrize("n_in,sizes", [
    (480, [h for h, _ in _levels(480, 640)]),
    (640, [w for _, w in _levels(480, 640)]),
    (752, [w for _, w in _levels(480, 752)]),
    (288, [h for h, _ in _levels(288, 384)]),
    (384, [w for _, w in _levels(288, 384)]),
    (700, [672]),
    (500, [480]),
    (48, [96]),
])
def test_weights_match_jax(n_in, sizes):
    """Each axis's weight matrix: within 5e-7 of JAX's; the extractor's and
    the upsample's bit for bit."""
    for n_out in sizes:
        got = ti.resize_weights(n_in, n_out).numpy()
        ref = _jax_weights(n_in, n_out)
        assert got.shape == ref.shape == (n_in, n_out)
        if n_in in (700, 500, 48):
            np.testing.assert_array_equal(got, ref)
        assert np.abs(got - ref).max() <= WEIGHT_GAP, (n_out,
                                                       np.abs(got - ref).max())


def test_taps_are_cached_per_size_and_device():
    """The ORB stages resize the same sizes every frame: the taps are made
    once per (in, out) size and device, and reused (so a captured graph
    never builds them)."""
    ti._TAPS.clear()
    x = torch.rand(1, 30, 40, 1)
    a = ti.resize_bilinear(x, (25, 33))
    assert set(ti._TAPS) == {(30, 25, "cpu"), (40, 33, "cpu")}
    held = {k: v[0].data_ptr() for k, v in ti._TAPS.items()}
    b = ti.resize_bilinear(x, (25, 33))
    assert {k: v[0].data_ptr() for k, v in ti._TAPS.items()} == held
    assert torch.equal(a, b)

"""What ``csrc/orb_fast.cu`` is handed to build the ORB pyramid, and the
describe stage's blur, held on the CPU (the kernels themselves run only on
the card, where ``chip_smoke.py`` holds them to their plain twins).

(a) The tap tables and axis order that ``ops/cuda_kernels.orb_fast_tables``
hands the kernel, applied in the kernel's order by a numpy emulation (per
output the first tap's product rounded to float32, then at each further
tap the float64 sum of the exact product and the float32 accumulator,
rounded once to float32; the first axis, a float32 intermediate, the
second axis), equal ``image.resize_bilinear`` bit for bit at every
resized level of 640x480, 752x480, 384x288 and a portrait 120x96 frame
(whose levels resize W first), on the halo's rows and columns too: a
halo index -4..-1 or h..h+3 reads the taps of the wrapped level index
moved by the input's size (the kernel's unwrapped input space) and the
input at the wrapped index. The input regions the kernel copies for each
tile fit the work area the host sized.

(b) ``models/orb.blur7`` (a float64 convolution rounded once to float32,
the value ``csrc/orb_describe.cu`` computes at the samples) equals a
numpy float64 7x7 sum rounded once to float32 bit for bit on an integer
frame, and stays within rtol 1e-5 of the JAX package's float32 blur at
levels 0-2.

(c) The kernel's rounding of a tap's float64 sum to float32 in double
arithmetic (``round_float``: plus and minus 1.5 * 2^(E + 29)) equals the
conversion, on random values, float32 midpoints and their neighbours."""

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
from xfeatslam_tpu_torch.ops import image  # noqa: E402
from xfeatslam_tpu_torch.utils import synthetic  # noqa: E402

HALO = 4
SHAPES = [(480, 640), (480, 752), (288, 384), (120, 96)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(hw, seed):
    """Integer-valued smoothed noise in [0, 255] (a camera frame)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, hw)
    x = (x + np.roll(x, 1, 0) + np.roll(x, 1, 1)) / 3.0
    return np.round(x).astype(np.float32)


def _sizes(H0, W0):
    """The extractor's level sizes, or for a small frame the 1.2x pyramid's
    first levels."""
    ex = to.ORBExtractor(device="cpu")
    sizes = ex.geometry(H0, W0)[0]
    if len(sizes) < 3:
        sizes = tuple((round(H0 / 1.2 ** i), round(W0 / 1.2 ** i))
                      for i in range(4))
    return sizes


def _chain(x, start, count, weight, n_in, axis):
    """One resize axis over the halo indices of one level, as the kernel
    applies it: ``start`` is each output's first tap in the unwrapped
    input space, the input read at its index modulo ``n_in``; x float32,
    the taps along ``axis``."""
    acc = None
    for t in range(weight.shape[1]):
        live = t < count
        idx = np.where(live, start + t, start) % n_in
        xt = np.take(x, idx, axis=axis).astype(np.float64)
        shape = [1, 1]
        shape[axis] = -1
        wt = weight[:, t].astype(np.float64).reshape(shape)
        if acc is None:
            acc = (wt * xt).astype(np.float32)
        else:
            nxt = (acc.astype(np.float64) + wt * xt).astype(np.float32)
            acc = np.where(live.reshape(shape), nxt, acc)
    return acc


def _halo(n_out, n_in, arrays):
    """Per halo index -4 .. n_out + 3: its level index (modulo n_out) and
    its taps' first input in the unwrapped input space."""
    start, count, weight = arrays
    u = np.arange(-HALO, n_out + HALO)
    lvl = u % n_out
    k = (u - lvl) // n_out
    return lvl, start[lvl] + k * n_in, count[lvl], weight[lvl]


@pytest.mark.parametrize("hw", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_tables_reproduce_resize(hw):
    H0, W0 = hw
    img = _frame(hw, seed=H0 + W0)
    sizes = _sizes(H0, W0)
    tables, _ = ck.orb_fast_tables(H0, W0, sizes, "cpu")
    orders = []
    for lvl, ((h, w), (h_first, rows, cols)) in enumerate(zip(sizes, tables)):
        if lvl == 0:
            continue
        orders.append(h_first)
        ref = image.resize_bilinear(torch.from_numpy(img)[None, :, :, None],
                                    (h, w))[0, :, :, 0].numpy()
        # the tables on the device are the numpy ones
        for dev_t, np_t in zip(rows + cols, ck.orb_axis_arrays(H0, h)
                               + ck.orb_axis_arrays(W0, w)):
            np.testing.assert_array_equal(dev_t.numpy(), np_t)
        ry, rs, rc, rw = _halo(h, H0, ck.orb_axis_arrays(H0, h))
        cx, cs_, cc, cw = _halo(w, W0, ck.orb_axis_arrays(W0, w))
        if h_first:
            tmp = _chain(img, rs, rc, rw, H0, 0)        # (h + 8, W0)
            out = _chain(tmp, cs_, cc, cw, W0, 1)       # (h + 8, w + 8)
        else:
            tmp = _chain(img, cs_, cc, cw, W0, 1)       # (H0, w + 8)
            out = _chain(tmp, rs, rc, rw, H0, 0)
        np.testing.assert_array_equal(out, ref[np.ix_(ry, cx)],
                                      err_msg=f"level {lvl} {(h, w)}")
    # landscape frames resize H first at every level, the portrait one W
    # first: both of the kernel's orders are held
    assert all(orders) if W0 > H0 else not any(orders)


@pytest.mark.parametrize("hw", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tile_regions_fit_the_work_area(hw):
    """Every tile's input region (rows x columns of the unwrapped spans
    its halo's taps cover) and intermediate fit the work area
    ``orb_fast_tables`` sizes, for each geometry above; the kernel traps
    otherwise."""
    TW, TH = ck.ORB_FAST_TILE
    PH, PW = TH + 2 * HALO, TW + 2 * HALO
    H0, W0 = hw
    sizes = _sizes(H0, W0)
    tables, work = ck.orb_fast_tables(H0, W0, sizes, "cpu")
    assert work >= 2 * (TH + 2) * (TW + 2)
    for (h, w), (h_first, rows, _) in zip(sizes[1:], tables[1:]):
        spans = []
        for n_out, n_in, t in ((h, H0, TH), (w, W0, TW)):
            start, count, _ = ck.orb_axis_arrays(n_in, n_out)
            most = 0
            for o in range(0, n_out, t):
                u = np.arange(o - HALO, o + t + HALO)
                lvl = u % n_out
                su = start[lvl] + (u - lvl) // n_out * n_in
                most = max(most, int((su + count[lvl] - 1).max()
                                     - su.min() + 1))
            spans.append(most)
        nr, nc = spans
        need = nr * nc + (PH * nc if h_first else nr * PW)
        assert need <= work, (H0, W0, (h, w), need, work)


def _blur_numpy(x):
    """The 7x7 Gaussian of ``models/orb._gauss_kernel7`` by a float64 sum
    over the window (zero padding), rounded once to float32."""
    k = to._gauss_kernel7().astype(np.float64)
    h, w = x.shape
    pad = np.zeros((h + 6, w + 6))
    pad[3:-3, 3:-3] = x
    acc = np.zeros((h, w))
    for dy in range(7):
        for dx in range(7):
            acc += k[dy, dx] * pad[dy:dy + h, dx:dx + w]
    return acc.astype(np.float32)


@pytest.fixture(scope="module")
def room_levels():
    img = synthetic.make_sequence(n_frames=1, hw=(288, 384))["images"][0]
    x0 = torch.from_numpy(img.astype(np.float32))
    sizes = _sizes(288, 384)[:3]
    return [to._level_image(x0, lvl, h, w) for lvl, (h, w) in
            enumerate(sizes)]


def test_blur7_is_the_rounded_float64_sum(room_levels):
    x = room_levels[0]
    assert (x.numpy() == np.round(x.numpy())).all()
    np.testing.assert_array_equal(to.blur7(x).numpy(),
                                  _blur_numpy(x.numpy()))


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_blur7_against_jax(room_levels, lvl):
    xn = room_levels[lvl].numpy()
    jb = np.asarray(jo.blur7(jnp.asarray(xn)))
    np.testing.assert_allclose(to.blur7(room_levels[lvl]).numpy(), jb,
                               rtol=1e-5, atol=1e-5 * np.abs(jb).max())


def _round_float(s):
    """``csrc/orb_fast.cu``'s round_float in numpy float64: s plus and
    minus 1.5 * 2^(E + 29), E the exponent of s, for s in float32's normal
    range or 0; the conversion below it."""
    bits = s.view(np.uint64)
    e = (bits >> np.uint64(52)) & np.uint64(0x7ff)
    c = ((e + np.uint64(29)) << np.uint64(52)
         | np.uint64(1) << np.uint64(51)).view(np.float64)
    fast = (s + c) - c
    slow = s.astype(np.float32).astype(np.float64)
    return np.where((e < 0x381) & (s != 0), slow, fast)


def test_round_float_is_the_conversion():
    """The kernel's rounding of a tap's float64 sum to float32 without the
    two conversions equals the conversion: on random values across the
    binades, the float32 midpoints and their neighbours, and values below
    float32's normal range."""
    rng = np.random.default_rng(0)
    f = rng.uniform(0, 256, 200_000).astype(np.float32)
    up = np.nextafter(f, np.float32(np.inf))
    mid = (f.astype(np.float64) + up.astype(np.float64)) / 2
    s = np.concatenate([
        rng.uniform(0, 300, 200_000),
        np.ldexp(rng.uniform(-1, 1, 200_000), rng.integers(-140, 40,
                                                           200_000)),
        mid, np.nextafter(mid, np.inf), np.nextafter(mid, -np.inf), -mid,
        [0.0, -0.0, 1e-40, -3e-39],
    ])
    want = s.astype(np.float32).astype(np.float64)
    np.testing.assert_array_equal(_round_float(s), want)

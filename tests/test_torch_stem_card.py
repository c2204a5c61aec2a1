"""The network's stem kernel (``ops/cuda_kernels.xfeat_stem``) against its
plain route on a card: both outputs and their memory formats at the cells'
shapes (640x480 at batch 3, KITTI's 1216x352 at batch 2), a frame of one
tile (32x32), one whose last tiles lie half outside (64x96), a constant
frame (variance 0, so rstd = 1/sqrt(eps)) and a 0/1 checkerboard (every
border and padding fault shows); two launches a call; the float32 forward
takes it and a CUDA graph replays it bit for bit. Skips without a card.

On the card: ``python -m pytest --noconftest tests/test_torch_stem_card.py``
(the tests' conftest imports JAX, which that machine lacks)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xfeatslam_tpu_torch.models import weights as tw  # noqa: E402
from xfeatslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "weights", "xfeat_synthetic.npz")
# float32 sums of up to 72 terms taken in another order than cuDNN's, over
# four layers, and the statistics in float64 against the plain route's
# float32: ~1e-6 of the maps' scale; the bar is 10x that
TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return tw.load_npz(NPZ, device="cuda")


def frames(kind, B, H, W, seed=0):
    """(B, H, W, 1) float32 frames on the card."""
    if kind == "constant":
        return torch.full((B, H, W, 1), 100 / 255, device="cuda")
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    if kind == "checkerboard":
        f = np.broadcast_to(((yy + xx) % 2)[None, ..., None], (B, H, W, 1))
        return torch.from_numpy(np.ascontiguousarray(f)).cuda()
    rng = np.random.default_rng(seed)
    out = []
    for i in range(B):
        img = (0.5 + 0.3 * np.sin(xx / 21 + i) * np.cos(yy / 17 - i)
               + 0.05 * rng.standard_normal((H, W)))
        for _ in range(40):
            cy, cx = rng.uniform(0, H), rng.uniform(0, W)
            img += 0.4 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 25.0)
        out.append(np.clip(img, 0, 1))
    return torch.from_numpy(np.stack(out).astype(np.float32)[..., None]).cuda()


def _stems(model, x):
    ck.reset_launch_counts()
    with torch.no_grad():
        got = ck.xfeat_stem(x, model.block1, model.skip1_conv)
        torch.cuda.synchronize()
        launches = ck.xfeat_stem.launches
        want = ck.xfeat_stem_plain(x, model.block1, model.skip1_conv)
    return got, want, launches


@pytest.mark.card
@pytest.mark.parametrize("kind, B, H, W", [
    ("natural", 3, 480, 640), ("natural", 2, 352, 1216),
    ("natural", 1, 32, 32), ("natural", 2, 64, 96),
    ("checkerboard", 1, 480, 640)])
def test_stem_kernel_matches_the_plain_route(model, kind, B, H, W):
    got, want, launches = _stems(model, frames(kind, B, H, W))
    assert launches == 2
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.stride() == b.stride()
        assert bool(torch.isfinite(a).all())
        err = float((a - b).abs().max())
        assert err <= TOL * (1.0 + float(b.abs().max())), err


@pytest.mark.card
def test_stem_kernel_on_a_constant_frame(model):
    """The kernel's float64 mean of a constant frame is the value itself, so
    its normalized frame is 0 and block1 sees zeros (the plain route's
    float32 mean is off by ulps there, which rstd = 316 magnifies)."""
    x = frames("constant", 1, 480, 640)
    (xs, unf), _, launches = _stems(model, x)
    assert launches == 2
    assert bool((unf == 0).all())
    with torch.no_grad():
        zs, _ = ck.xfeat_stem_plain(torch.zeros_like(x), model.block1,
                                    model.skip1_conv)
    err = float((xs - zs).abs().max())
    assert err <= TOL * (1.0 + float(zs.abs().max())), err


@pytest.mark.card
def test_forward_takes_the_kernel_and_a_graph_replays_it(model):
    x = frames("natural", 2, 480, 640, seed=3)
    ck.reset_launch_counts()
    with torch.no_grad():
        want = model(x)
        torch.cuda.synchronize()
        assert ck.xfeat_stem.launches == 2
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            model(x)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            got = model(x)
        g.replay()
        torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)

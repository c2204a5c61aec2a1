"""The PyTorch port's XFeat network and weight IO against the JAX package,
on the same inputs (made with numpy from a seed) and the same weights
(carried across with ``from_jax_params``). Float32 on the CPU; the
tolerances are the golden ones of tests/test_xfeat_golden.py."""

import copy
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# float32 parity: no TF32 in convolutions or matmuls, should a GPU be used
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

import jax.numpy as jnp  # noqa: E402

from xfeatslam_tpu.models import weights as jw  # noqa: E402
from xfeatslam_tpu.models import xfeat as jx  # noqa: E402
from xfeatslam_tpu_torch.models import weights as tw  # noqa: E402
from xfeatslam_tpu_torch.models import xfeat as tx  # noqa: E402
from xfeatslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

import torch_xfeat_ref as tref  # noqa: E402

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "weights", "xfeat_synthetic.npz")


def blob_images(rng, B, H, W, n_blobs=15):
    """Smooth pattern plus Gaussian blobs, (B,H,W,1) float32 in [0,1]."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for i in range(B):
        img = 0.5 + 0.3 * np.sin(xx / 21 + i) * np.cos(yy / 17 - i)
        for _ in range(n_blobs):
            cy, cx = rng.uniform(8, H - 8), rng.uniform(8, W - 8)
            img += 0.4 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 25.0)
        out.append(np.clip(img, 0, 1).astype(np.float32))
    return np.stack(out)[..., None]


@pytest.fixture(scope="module")
def jax_params():
    return jw.load_npz(NPZ)


@pytest.fixture(scope="module")
def model(jax_params):
    return tw.from_jax_params(jax_params, device="cpu")


@pytest.mark.parametrize("hw", [(96, 128), (128, 160)])
def test_forward_matches_jax(model, jax_params, hw):
    rng = np.random.default_rng(1)
    x = blob_images(rng, 2, *hw)
    fj, lj, hj = (np.asarray(a) for a in jx.forward(jax_params, jnp.asarray(x)))
    with torch.no_grad():
        ft, lt, ht = (a.numpy() for a in model(torch.from_numpy(x)))
    H8, W8 = hw[0] // 8, hw[1] // 8
    assert ft.shape == (2, H8, W8, 64) and lt.shape == (2, H8, W8, 65)
    assert ht.shape == (2, H8, W8, 1)
    np.testing.assert_allclose(ft, fj, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(lt, lj, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(ht, hj, atol=1e-4)


def test_forward_outputs_are_nhwc_views_of_channels_last(model):
    x = torch.from_numpy(blob_images(np.random.default_rng(2), 1, 64, 96))
    with torch.no_grad():
        for out in model(x):
            assert out.is_contiguous()


@pytest.fixture(scope="module")
def torch_ref_model():
    torch.manual_seed(7)
    m = tref.TorchXFeat().eval()
    tref.randomize_bn_stats(m, seed=3)
    return m


def test_from_torch_state_dict_matches_jax(torch_ref_model):
    sd = tref.state_dict_for_converter(torch_ref_model)
    pj = jw.from_torch_state_dict(sd)
    pt = tw.from_torch_state_dict(sd)
    for path in tw._paths():
        a, b = tw._node(pj, path), tw._node(pt, path)
        np.testing.assert_allclose(b["w"], np.asarray(a["w"]), atol=1e-6,
                                   err_msg=str(path))
        np.testing.assert_allclose(b["b"], np.asarray(a["b"]), atol=1e-6,
                                   err_msg=str(path))


def test_port_forward_matches_torch_reference(torch_ref_model):
    """The folded port model against the unfolded reference network."""
    model = tw.from_jax_params(
        tw.from_torch_state_dict(tref.state_dict_for_converter(torch_ref_model)),
        device="cpu")
    x = blob_images(np.random.default_rng(3), 1, 96, 128)
    with torch.no_grad():
        f_r, l_r, h_r = torch_ref_model(torch.from_numpy(x).permute(0, 3, 1, 2))
        f_p, l_p, h_p = model(torch.from_numpy(x))
    np.testing.assert_allclose(f_p.numpy(), f_r.permute(0, 2, 3, 1).numpy(),
                               atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(l_p.numpy(), l_r.permute(0, 2, 3, 1).numpy(),
                               atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(h_p.numpy(), h_r.permute(0, 2, 3, 1).numpy(),
                               atol=1e-4)


def test_fine_matcher_mlp_matches_jax(model, jax_params):
    x = np.random.default_rng(4).standard_normal((32, 128)).astype(np.float32)
    yj = np.asarray(jx.fine_matcher_mlp(jax_params, jnp.asarray(x)))
    with torch.no_grad():
        yt = tx.fine_matcher_mlp(model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, yj, atol=2e-3, rtol=1e-3)


def test_instance_norm_and_unfold2d_match_jax():
    x = np.random.default_rng(5).uniform(size=(2, 32, 48, 1)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_allclose(
        tx.instance_norm(xt).permute(0, 2, 3, 1).numpy(),
        np.asarray(jx.instance_norm(jnp.asarray(x))), atol=1e-5)
    np.testing.assert_array_equal(
        tx.unfold2d(xt, 8).permute(0, 2, 3, 1).numpy(),
        np.asarray(jx.unfold2d(jnp.asarray(x), 8)))


def test_npz_round_trip(model, tmp_path):
    path = str(tmp_path / "w.npz")
    tw.save_npz(path, model)
    back = tw.load_npz_params(path)
    ref = jw.load_npz(NPZ)
    for p in tw._paths():
        np.testing.assert_array_equal(tw._node(back, p)["w"],
                                      np.asarray(tw._node(ref, p)["w"]))
        np.testing.assert_array_equal(tw._node(back, p)["b"],
                                      np.asarray(tw._node(ref, p)["b"]))


def test_init_params_analytic_head_matches_jax():
    import jax

    pj = jax.jit(jx.init_params)(jax.random.PRNGKey(0))  # jit: 2x faster
    pt = tx.init_params(0)
    for i in range(3):
        np.testing.assert_array_equal(pt["keypoint_head"][i]["w"],
                                      np.asarray(pj["keypoint_head"][i]["w"]))
        np.testing.assert_array_equal(pt["keypoint_head"][i]["b"],
                                      np.asarray(pj["keypoint_head"][i]["b"]))
    np.testing.assert_allclose(pt["keypoint_final"]["w"],
                               np.asarray(pj["keypoint_final"]["w"]), atol=1e-7)
    for p in tw._paths():
        assert tw._node(pt, p)["w"].shape == np.asarray(tw._node(pj, p)["w"]).shape


def test_bf16_compute_keeps_heads_float32(model):
    """bf16 convs: heads still come out float32 and the heatmap stays
    within bf16's ~3 significant digits of the float32 one."""
    x = torch.from_numpy(blob_images(np.random.default_rng(6), 1, 64, 96))
    with torch.no_grad():
        f32 = model(x)
        b16 = model(x, compute_dtype=torch.bfloat16)
    for a, b in zip(f32, b16):
        assert b.dtype == torch.float32 and torch.isfinite(b).all()
    np.testing.assert_allclose(b16[2].numpy(), f32[2].numpy(), atol=5e-2)


# ---------------------------------------------------------------------------
# The stem: ops/cuda_kernels.xfeat_stem on a card, xfeat_stem_plain here


def _stem_ops(x, model, dt):
    """The stem as ``XFeat.forward`` ran it op by op before it had a kernel
    (x already in the weights' dtype)."""
    F = torch.nn.functional
    x = x.mean(dim=-1, keepdim=True).permute(0, 3, 1, 2)
    x = tx.instance_norm(x).contiguous(memory_format=torch.channels_last)
    x1 = tx._basic_stack(x, model.block1, dt)
    skip = tx._conv(F.avg_pool2d(x, 4, 4), model.skip1_conv, dt, out_dt=dt)
    return x1 + skip, tx.unfold2d(x if dt == torch.float32 else x.to(dt), 8)


@pytest.mark.parametrize("dt", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("B, H, W", [(2, 64, 96), (1, 480, 640)])
def test_stem_plain_is_the_ops_it_replaced(model, dt, B, H, W):
    """``xfeat_stem_plain`` gives the old sequence's outputs bit for bit, in
    the same memory formats, in each dtype the forward computes in."""
    m = copy.deepcopy(model).double() if dt == "float64" else model
    dt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    x = torch.from_numpy(blob_images(np.random.default_rng(7), B, H, W))
    x = x.to(m.block1[0].weight.dtype)
    with torch.no_grad():
        got = ck.xfeat_stem_plain(x, m.block1, m.skip1_conv, dt)
        want = _stem_ops(x, m, dt)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.stride() == w.stride()
        assert torch.equal(g, w)


def test_stem_outputs_have_the_layouts_block2_and_the_keypoint_head_take(
        model):
    """``block2``'s input (B, 24, H/4, W/4) is channels-last, (B, H/4, W/4,
    24) in memory, the layout the kernel writes. The keypoint head's input
    (B, 64, H/8, W/8) is what ``F.pixel_unshuffle`` gives on the device:
    channels-last here; contiguous on a card, which the kernel writes and
    tests/test_torch_stem_card.py holds to the plain route's strides."""
    B, H, W = 2, 64, 96
    x = torch.from_numpy(blob_images(np.random.default_rng(8), B, H, W))
    with torch.no_grad():
        xs, unf = ck.xfeat_stem_plain(x, model.block1, model.skip1_conv)
    assert xs.shape == (B, 24, H // 4, W // 4)
    assert xs.stride() == torch.empty(B, H // 4, W // 4, 24).permute(
        0, 3, 1, 2).stride()
    assert unf.shape == (B, 64, H // 8, W // 8)
    assert unf.stride() == torch.empty(B, H // 8, W // 8, 64).permute(
        0, 3, 1, 2).stride()


class _IdentitySplit:
    """A ``model_split`` that gathers nothing (one model rank)."""

    @staticmethod
    def enter(t):
        return t

    @staticmethod
    def leave(t):
        return t


@pytest.mark.parametrize("route", ["cpu", "float64", "bfloat16", "grad",
                                   "model_split", "rgb"])
def test_stem_dispatch_takes_the_plain_route(model, route):
    """Only a float32 inference pass over gray frames on a card takes the
    kernel: the predicate, asked about a card's input, says so for the
    shipped model and refuses float64 weights, bf16 compute, a pass that
    autograd records, a partitioned conv and three-channel frames. Here
    every route runs the plain ops and launches nothing."""
    m, dt, C = model, torch.float32, 1
    if route == "float64":
        m = copy.deepcopy(model).double()
    elif route == "bfloat16":
        dt = torch.bfloat16
    elif route == "grad":
        m = copy.deepcopy(model).requires_grad_(True)
    elif route == "model_split":
        m = copy.deepcopy(model)
        m.block1[1].model_split = _IdentitySplit()
    elif route == "rgb":
        C = 3
    x = torch.from_numpy(blob_images(np.random.default_rng(9), 2, 64, 96))
    x = x.repeat(1, 1, 1, C)
    card_x = SimpleNamespace(is_cuda=True, shape=tuple(x.shape),
                             requires_grad=False)
    with torch.set_grad_enabled(route == "grad"):
        assert m._stem_on_kernel(card_x, dt) is (route == "cpu")
        ck.reset_launch_counts()
        out = m(x.to(m.block1[0].weight.dtype), compute_dtype=dt)
    assert ck.xfeat_stem.launches == 0
    assert all(bool(torch.isfinite(o).all()) for o in out)
    if route == "grad":
        # the same trainable model under no_grad records nothing: kernel
        with torch.no_grad():
            assert m._stem_on_kernel(card_x, dt)


def test_stem_wrapper_refuses_cpu_tensors(model):
    """The kernel's wrapper runs on a card only: the forward's predicate
    owns the route, and the CPU takes the plain version, which is the
    model's own op sequence."""
    x = torch.from_numpy(blob_images(np.random.default_rng(10), 2, 64, 96))
    ck.reset_launch_counts()
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            ck.xfeat_stem(x, model.block1, model.skip1_conv)
        got = ck.xfeat_stem_plain(x, model.block1, model.skip1_conv)
        want = tx.stem_plain(x, model.block1, model.skip1_conv)
    assert ck.xfeat_stem.launches == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w) and g.stride() == w.stride()

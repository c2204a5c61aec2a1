"""The plain reference against the port's CPU path at a small size: the
network's outputs, the keypoints, descriptors and matches."""

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import xfeat as ref
from benchmark.traffic import render
from xfeatslam_tpu_torch.models import weights as wio
from xfeatslam_tpu_torch.ops import image as image_ops
from xfeatslam_tpu_torch.parallel import batched

from .tiny import tiny


def _frames(spec, seed=3):
    return render.render_pool(spec.cfg, spec.traffic, seed, "cpu")


def test_forward_matches_the_port():
    spec = tiny("offline.tum1.b256", hw=(96, 128))
    frames = _frames(spec)[:2]
    net = ref.Network(str(harness.WEIGHTS), "cpu")
    model = wio.load_npz(str(harness.WEIGHTS), "cpu")
    x = frames.float() / 255.0
    f_ref, l_ref, h_ref = net.forward(x)
    f, l, h = model(x)
    for a, b in ((f_ref, f), (l_ref, l), (h_ref, h)):
        b = b.permute(0, 3, 1, 2)
        scale = float(a.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * scale


def test_resize_matches_the_port():
    # the port computes its weights with XLA:CPU's float32 steps, which
    # land within ~5e-6 of the exact weights' result on [0, 1] inputs
    x = torch.rand(2, 70, 100, 1, generator=torch.Generator().manual_seed(0))
    a = ref.resize(x, (64, 96))
    b = image_ops.resize_bilinear(x, (64, 96))
    assert float((a - b).abs().max()) < 1e-5


def test_extract_matches_the_port():
    spec = tiny("offline.tum1.b256", hw=(96, 128), K=128)
    frames = _frames(spec)[:4]
    net = ref.Network(str(harness.WEIGHTS), "cpu")
    mine = ref.extract(net, frames, spec.cfg)
    model = wio.load_npz(str(harness.WEIGHTS), "cpu")
    x = frames.float() / 255.0
    out = batched.extract_batch(model, x, 128)
    res = batched.match_consecutive(out["desc"], out["valid"])
    assert torch.equal(mine["valid"].sum(1), out["valid"].sum(1))
    # the same keypoints (the order of equal scores aside), each with the
    # same descriptor, and the same matches between them
    for b in range(4):
        slot = {tuple(p): i for i, p in enumerate(out["kpts"][b].tolist())}
        mine_to_port = {}
        for i in torch.nonzero(mine["valid"][b])[:, 0].tolist():
            j = slot[tuple(mine["kpts"][b, i].tolist())]
            mine_to_port[i] = j
            assert out["valid"][b, j]
            d = (mine["desc"][b, i] - out["desc"][b, j]).abs().max()
            assert float(d) < 1e-5
        if b == 0:
            continue
        prev = {tuple(p): i for i, p in
                enumerate(out["kpts"][b - 1].tolist())}
        m_pairs = {(prev[tuple(mine["kpts"][b - 1, i].tolist())],
                    mine_to_port[int(mine["match_idx"][b - 1, i])])
                   for i in torch.nonzero(mine["match_mask"][b - 1])[:, 0]
                   .tolist()}
        p_pairs = {(i, int(res.idx[b - 1, i])) for i in
                   torch.nonzero(res.mask[b - 1])[:, 0].tolist()}
        assert m_pairs == p_pairs


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-10,
                      3.14159265], dtype=torch.float32)
    y = ref.round_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0  # a tie goes to even
    assert y[2] == 1.0 + 2**-9
    assert y[3] == -1.0 - 2**-10
    assert abs(float(y[4]) - 3.14159265) < 2**-10 * 4
    assert int((y.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert np.isfinite(y.numpy()).all()

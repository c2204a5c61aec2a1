"""The torch renderer against the port's numpy ``RoomScene`` on the same
seed and poses, and the pool's properties."""

import numpy as np
import torch

from benchmark.traffic import render
from xfeatslam_tpu_torch.utils import synthetic

from .tiny import tiny


def test_renderer_matches_roomscene():
    seed = 2**31 + 12345
    K = np.array([[517.306408, 0, 318.64304], [0, 516.469215, 255.313989],
                  [0, 0, 1]], np.float32)
    R, t = render.orbit_poses(3, 1, 0.15, 0.3, 0.3, 0.12, 0.05)
    scene = synthetic.RoomScene(seed=seed)
    mine = render.Scene(seed, "cpu").render(
        K, torch.from_numpy(R), torch.from_numpy(t), (240, 320)).numpy()
    for i in range(3):
        img, _ = scene.render(K, R[i], t[i], (240, 320))
        d = np.abs(img.astype(int) - mine[i].astype(int))
        assert d.max() <= 1
        assert (d > 0).mean() < 1e-3


def test_pool_is_seeded_and_closed():
    spec = tiny("offline.tum1.b256", hw=(64, 96), batch=8)
    a = render.render_pool(spec.cfg, spec.traffic, 7, "cpu")
    b = render.render_pool(spec.cfg, spec.traffic, 7, "cpu")
    c = render.render_pool(spec.cfg, spec.traffic, 2**31 + 7, "cpu")
    assert a.shape == (16, 64, 96, 1) and a.dtype == torch.uint8
    assert torch.equal(a, b) and not torch.equal(a, c)
    R, t = render.trajectory(spec.traffic, 16, 7)
    # the step across the wrap is a step like the others
    C = np.stack([-r.T @ v for r, v in zip(R, t)])
    steps = np.linalg.norm(np.diff(np.concatenate([C, C[:1]]), axis=0), axis=1)
    assert steps.max() < 2.0 * np.median(steps)


def test_every_seed_gives_the_same_sizes():
    spec = tiny("offline.kitti.b256")
    for seed in (0, 1, 2**31 + 1):
        pool = render.render_pool(spec.cfg, spec.traffic, seed, "cpu")
        assert pool.shape == (8, 70, 100, 1)

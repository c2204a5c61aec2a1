"""The control, the plain reference put in the program's place with its
conv and matmul operands rounded to TF32, fails the cell's limits; the
program's CPU path at the same size passes them (the chip's readings, on
the cell's own size, are in PERF.md)."""

import pytest
import torch

from benchmark import harness, judge
from benchmark.reference import xfeat as ref
from benchmark.traffic import render

from .tiny import tiny


@pytest.mark.parametrize("cell", ["offline.tum1.b256", "offline.kitti.b256"])
def test_control_fails_program_passes(cell):
    spec = tiny(cell, hw=(160, 224) if "tum1" in cell else (188, 310),
                K=256)
    dev = torch.device("cpu")
    harness.start(spec, dev)
    pool = render.render_pool(spec.cfg, spec.traffic, 2**31 + 5, dev)
    frames = pool[:spec.traffic["batch"]]
    net = ref.Network(str(harness.WEIGHTS), dev)
    sess = harness.Session(spec, dev)
    prog = judge.judge(net, frames, sess.run_batch(frames), spec.cfg)
    ok, checks = harness.check(spec, prog)
    assert ok, checks
    ctl = judge.judge(net, frames, ref.extract(net, frames, spec.cfg,
                                               tf32=True), spec.cfg)
    ok, checks = harness.check(spec, ctl)
    assert not ok, checks

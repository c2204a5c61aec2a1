#!/usr/bin/env python3
"""Hold the port's mesh across several CUDA cards (NCCL) against one card.

    torchrun --nproc-per-node=4 mesh_cards.py            # a rank per card
    torchrun --nproc-per-node=4 mesh_cards.py --device cpu   # gloo ranks

Every rank makes the same inputs from seeds: 16 rendered view pairs at
128x160 (``tools/train_xfeat.render_pair_pool``, whose valid pixels differ
from pair to pair), the shipped weights, and chip_smoke.py's 32 frames at
640x480. On the (data, model) mesh of all ranks (``make_mesh()``: (2, 2)
for 4) it takes one ``make_train_step`` step on the 16 pairs, a
``make_pool_trainer`` run of 2 steps with augmentation (one step a call),
and runs ``make_sharded_pipeline`` (K=1000) in float32 and bf16.

Then rank 0 holds the mesh to one card at the bars of
tests/test_torch_mesh.py, which it imports from tests/torch_mesh_ranks.py.
Each training step is held against one card's step from the state the
mesh's step started from (weights, Adam's moments, the generator): the
loss within 1e-4 relative, the gradients within 1e-3 of each leaf's max
abs, and every weight within test_parallel's bars but those whose gradient
lay within 1e-6 of its leaf's max of zero (Adam's normalized step takes its
sign from rounding there), held within 2 lr. The pool run's mean loss is
also held within 1e-4 of one card's own 2-step run, and every rank's
weights equal rank 0's to 1e-6. The pipeline is held bit for bit to one
card doing each data rank's work (its frames at its batch size), and in
float32 to one card's whole batch at 1e-5 with equal match masks; cuDNN
picks its algorithms by batch size, so bf16 is only reported against the
whole batch. Prints each figure, the card's name and power limit, and
exits 1 if a bar is missed.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.abspath(__file__))
LR, STEPS, K = 2e-3, 2, 1000


def flat(params):
    from xfeatslam_tpu_torch.models import weights

    return {f"{weights._prefix(p)}.{k}": np.array(weights._node(params, p)[k])
            for p in weights._paths() for k in ("w", "b")}


def moments(net, opt):
    """Adam's state of each parameter of ``net``, copied and whole
    (gathered over the mesh's "model" axis where a layer is split: a
    collective)."""
    from xfeatslam_tpu_torch.models import weights

    out = {}
    for path in weights._paths():
        layer = weights._node(net, path)
        for attr in ("weight", "bias"):
            out[f"{weights._prefix(path)}.{attr}"] = {
                k: v.clone() if k == "step" else
                weights._whole(layer, v).clone()
                for k, v in opt.opt.state[getattr(layer, attr)].items()}
    return out


def load_moments(net, opt, state, count):
    """Give ``opt``, built over the whole ``net``, the state ``state``
    (``moments``) that it has after ``count`` steps."""
    from xfeatslam_tpu_torch.models import weights

    for path in weights._paths():
        layer = weights._node(net, path)
        for attr in ("weight", "bias"):
            opt.opt.state[getattr(layer, attr)] = {
                k: v.clone() for k, v in
                state[f"{weights._prefix(path)}.{attr}"].items()}
    opt.count = count


def spread(flat_params, dev):
    """The largest difference of this rank's weights from rank 0's."""
    x = torch.cat([torch.from_numpy(v.ravel())
                   for v in flat_params.values()]).to(dev)
    x0 = x.clone()
    dist.broadcast(x0, src=0)
    return float((x - x0).abs().max())


def held_step(name, on_mesh, on_one):
    """A training step on the mesh against one card's step from the same
    state, each (loss, weights, gradients), at test_torch_mesh's bars.
    Prints the figures; returns whether every bar was met."""
    from torch_mesh_ranks import GRAD_GAP, LOSS_RTOL, grad_gap, weights_off

    (ls, ps, gs), (l1, p1, g1) = on_mesh[:3], on_one[:3]
    rel = abs(ls - l1) / abs(l1)
    unexplained, off, beyond, worst = weights_off(ps, p1, [g1], LR)
    gap, leaf = grad_gap(gs, g1)
    print(f"{name}: loss {ls!r} on the mesh, {l1!r} on one card (rel "
          f"{rel:.3e}); gradients' gap over the leaf's max {gap:.3e} "
          f"({leaf}); weights off test_parallel's bars {off} (not at a "
          f"near-zero gradient {unexplained}, beyond 2 lr {beyond}), max "
          f"gap {worst:.3e}")
    return (rel <= LOSS_RTOL and gap <= GRAD_GAP and unexplained == 0
            and beyond == 0)


def held_training(sharded, one, from_mesh, spreads):
    """The mesh's train step against one card's, each pool step against
    one card's from the mesh's state before it (``from_mesh``), the pool
    run's mean loss against one card's own run, and every rank's weights
    equal. Returns the names that missed."""
    from torch_mesh_ranks import LOSS_RTOL

    failed = []
    if not held_step("make_train_step", sharded[0], one[0]):
        failed.append("make_train_step")
    for s, (step, ref) in enumerate(zip(sharded[1], from_mesh)):
        if not held_step(f"make_pool_trainer step {s + 1}", step, ref):
            failed.append(f"make_pool_trainer step {s + 1}")
    ls, l1 = (float(np.mean([st[0] for st in run[1]]))
              for run in (sharded, one))
    rel = abs(ls - l1) / abs(l1)
    print(f"make_pool_trainer, {STEPS} steps: mean loss {ls!r} on the mesh, "
          f"{l1!r} on one card's own run (rel {rel:.3e}); ranks' spread "
          f"{[f'{sp:.3e}' for sp in spreads]}")
    if not rel <= LOSS_RTOL:
        failed.append("make_pool_trainer")
    if not max(spreads) <= 1e-6:
        failed.append("ranks' spread")
    return failed


def held_pipeline(pipe, pipe1, frames, model, mesh):
    """The mesh's pipeline bit for bit against one card doing each data
    rank's work (its frames extracted at its batch size; every pair
    matched), and its agreement with one card extracting the whole batch
    (float32: keypoints within 1e-5, match masks equal). Returns the
    names that missed."""
    from chip_smoke import jaccard, pair_set, pixel_set
    from xfeatslam_tpu_torch.parallel import batched

    failed = []
    d = mesh.shape["data"]
    for dt in (torch.float32, torch.bfloat16):
        outs = [batched.extract_batch(model, part, K, dt)
                for part in frames.chunk(d)]
        ref = {k: torch.cat([o[k] for o in outs])
               for k in ("kpts", "desc", "valid")}
        r = batched.match_consecutive(ref["desc"], ref["valid"])
        same = [bool(torch.equal(x, y)) for x, y in zip(
            pipe[dt], (ref["kpts"], ref["desc"], ref["valid"], r.idx,
                       r.mask))]
        a, b = ([t.cpu().numpy() for t in run] for run in (pipe[dt],
                                                            pipe1[dt]))
        kerr = float(np.abs(a[0] - b[0]).max())
        kj = min(jaccard(pixel_set(a[0][i], a[2][i]),
                         pixel_set(b[0][i], b[2][i]))
                 for i in range(len(a[0])))
        pj = min(jaccard(pair_set(a[0], a[3], i), pair_set(b[0], b[3], i))
                 for i in range(len(a[3])))
        print(f"make_sharded_pipeline {dt}: kpts, desc, valid, idx, mask "
              f"bit-identical to one card doing each data rank's work: "
              f"{same}; against one card's whole batch: kpts max gap "
              f"{kerr:.3e}, desc max gap "
              f"{float(np.abs(a[1] - b[1]).max()):.3e}, keypoint Jaccard "
              f"min {kj:.6f}, matched-pair Jaccard min {pj:.6f}, match "
              f"masks agree {float((a[4] == b[4]).mean()):.6f}")
        if not all(same) or (dt == torch.float32 and (
                kerr > 1e-5 or not (a[4] == b[4]).all())):
            failed.append(f"pipeline {dt}")
    return failed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu for gloo ranks (default: each rank's card)")
    args = ap.parse_args()
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    from chip_smoke import card_line, make_images
    from xfeatslam_tpu_torch import resolve_device
    from xfeatslam_tpu_torch.models import weights
    from xfeatslam_tpu_torch.parallel import batched, train
    from xfeatslam_tpu_torch.parallel.mesh import make_mesh
    from xfeatslam_tpu_torch.tools.train_xfeat import render_pair_pool

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        if int(os.environ.get("LOCAL_RANK", 0)) == 0:
            from xfeatslam_tpu_torch import _build
            _build.build()  # the other ranks load what it built
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    t_run = time.perf_counter()
    mesh = make_mesh(device=dev)
    dev = mesh.device
    lead = mesh.rank == 0
    if lead:
        print(card_line())
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
              f"{dist.get_world_size()} ranks, backend "
              f"{dist.get_backend()}, {mesh}")
    npz = os.path.join(REPO, "weights", "xfeat_synthetic.npz")
    pool = {k: torch.from_numpy(v).to(dev) for k, v in render_pair_pool(
        np.random.default_rng(0), n_scenes=1, hw=(128, 160),
        pairs_per_scene=16).items()}
    n = len(pool["img_a"])
    idx = torch.from_numpy(np.random.default_rng(1).integers(
        0, n, (STEPS, n))).to(dev)
    frames = torch.from_numpy(make_images(32)).to(dev)
    model = weights.load_npz(npz, device=dev)

    def trained(m):
        """On mesh ``m`` (None: this device alone), one train step on the
        16 pairs, then the 2-step pool run with augmentation, one step a
        call: the step's (loss, weights, gradients) and each pool step's
        (loss, weights, gradients, the state it started from: weights,
        Adam's state and the generator's)."""
        init_fn, step_fn = train.make_train_step(train.adam(LR), mesh=m)
        net, opt = init_fn(weights.trainable(npz, device=dev))
        net, opt, loss, _ = step_fn(net, opt, pool)
        step = (float(loss), flat(weights.to_params(net)),
                flat(weights.grads_to_params(net)))
        init_fn, run_fn = train.make_pool_trainer(
            train.adam(LR), steps_per_call=1, augment=True, mesh=m)
        net, opt = init_fn(weights.trainable(npz, device=dev))
        gen = torch.Generator(device=dev).manual_seed(3)
        steps = []
        for s in range(STEPS):
            start = (copy.deepcopy(weights.to_params(net)),
                     moments(net, opt), gen.get_state())
            net, opt, loss, _ = run_fn(net, opt, pool, idx[s:s + 1], gen)
            steps.append((float(loss), flat(weights.to_params(net)),
                          flat(weights.grads_to_params(net)), start))
        return step, steps

    def pool_step_from(start, s):
        """One card's pool step ``s`` from the state ``start``."""
        params, state, gen_state = start
        init_fn, run_fn = train.make_pool_trainer(
            train.adam(LR), steps_per_call=1, augment=True)
        net, opt = init_fn(weights.trainable(params, device=dev))
        load_moments(net, opt, state, s)
        gen = torch.Generator(device=dev)
        gen.set_state(gen_state)
        net, opt, loss, _ = run_fn(net, opt, pool, idx[s:s + 1], gen)
        return (float(loss), flat(weights.to_params(net)),
                flat(weights.grads_to_params(net)))

    def piped(m):
        return {dt: batched.make_sharded_pipeline(
            m, model, num_keypoints=K, compute_dtype=dt)(frames)
            for dt in (torch.float32, torch.bfloat16)}

    t0 = time.perf_counter()
    sharded, pipe = trained(mesh), piped(mesh)
    spreads = [spread(sharded[0][1], dev), spread(sharded[1][-1][1], dev)]
    mesh_s = time.perf_counter() - t0
    failed = []
    if lead:
        t0 = time.perf_counter()
        one, pipe1 = trained(None), piped(make_mesh(1, device=dev))
        from_mesh = [pool_step_from(st[3], s)
                     for s, st in enumerate(sharded[1])]
        print(f"mesh runs {mesh_s:.2f} s, one device "
              f"{time.perf_counter() - t0:.2f} s")
        failed += held_training(sharded, one, from_mesh, spreads)
        failed += held_pipeline(pipe, pipe1, frames, model, mesh)
        print(f"mesh_cards: {time.perf_counter() - t_run:.1f} s; "
              + ("FAILED: " + ", ".join(failed) if failed else "OK"))
    ok = torch.tensor([0 if failed else 1], device=dev)
    dist.broadcast(ok, src=0)
    dist.destroy_process_group()
    return 0 if int(ok) else 1


if __name__ == "__main__":
    sys.exit(main())

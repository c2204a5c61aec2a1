"""One rank of ``tests/test_torch_mesh.py``'s job: the port's mesh, the data-
and tensor-parallel training step, the pool trainer and the sharded
pipeline on a (4, 2) mesh of gloo ranks on the CPU. It imports no JAX.

    python tests/torch_mesh_ranks.py RANK WORLD DIR

reads DIR/inputs.npz (the test's weights, batches, pool and frames),
meets the other ranks through a file in DIR and writes DIR/rank<RANK>.npz.

It also holds the bars that a training step on the mesh is held to against
one device, which the test and ``mesh_cards.py`` (the mesh on several
cards) share: ``weights_off`` and ``grad_gap``.
"""

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from xfeatslam_tpu_torch.models import weights  # noqa: E402
from xfeatslam_tpu_torch.parallel import batched, train  # noqa: E402
from xfeatslam_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402

K = 128
LR = 1e-3

# test_parallel's bars for a step on the mesh against one device: the loss
# relative, each weight absolute and relative
LOSS_RTOL, ATOL, RTOL = 1e-4, 5e-5, 5e-4
# a gradient within this share of its leaf's max abs is zero up to
# rounding: Adam's normalized step, lr * g / (|g| + 1e-8), takes its sign
# and size from that rounding, so such a weight is held within 2 lr a step
NEAR_ZERO = 1e-6
# the mesh's gradients against one device's from the same weights, over
# each leaf's max abs
GRAD_GAP = 1e-3


def weights_off(got, want, grads, lr):
    """How the weights ``got`` after ``len(grads)`` steps on the mesh miss
    one device's ``want`` ({name: array} both), given one device's
    gradients at each step: (the weights off test_parallel's bars whose
    gradient was at no step within ``NEAR_ZERO`` of zero, the weights off
    them in all, the weights more than 2 lr a step away, the largest gap).
    A step on the mesh is held by the first and third being 0."""
    unexplained = off_all = beyond = 0
    worst = 0.0
    for k, w in want.items():
        err = np.abs(got[k] - w)
        near_zero = np.zeros(w.shape, bool)
        for g in grads:
            near_zero |= np.abs(g[k]) <= NEAR_ZERO * np.abs(g[k]).max()
        off = ~(err <= ATOL + RTOL * np.abs(w))
        unexplained += int((off & ~near_zero).sum())
        off_all += int(off.sum())
        beyond += int((~(err <= 2 * lr * len(grads))).sum())
        worst = max(worst, float(err.max()))
    return unexplained, off_all, beyond, worst


def grad_gap(got, want):
    """The mesh's gradients ``got`` against one device's ``want`` from the
    same weights ({name: array} both): the largest gap over its leaf's max
    abs, and that leaf. A step on the mesh is held by a gap within
    ``GRAD_GAP``."""
    worst = (0.0, None)
    for k, v in want.items():
        gap = float(np.abs(got[k] - v).max()) / max(float(np.abs(v).max()),
                                                     1e-30)
        if not gap <= worst[0]:  # a NaN gap is the worst
            worst = (gap if gap == gap else float("inf"), k)
    return worst


def flat(params, prefix):
    """A JAX-layout pytree as npz entries ``prefix/name.i.w``, copied (on
    the CPU ``to_params`` shares the parameters' memory)."""
    out = {}
    for p in weights._paths():
        node = weights._node(params, p)
        for k in ("w", "b"):
            out[f"{prefix}/{weights._prefix(p)}.{k}"] = np.array(node[k])
    return out


def spread(params):
    """The largest difference of this rank's pytree from rank 0's."""
    x = torch.cat([torch.from_numpy(np.ravel(v)) for v in
                   flat(params, "").values()])
    x0 = x.clone()
    dist.broadcast(x0, src=0)
    return float((x - x0).abs().max())


def main(rank, world, root):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(root, 'rendezvous')}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    with np.load(os.path.join(root, "inputs.npz")) as f:
        data = dict(f)
    params = weights.load_npz_params(os.path.join(root, "params.npz"))
    out = {}

    # ---- (a) the mesh ----
    mesh = mesh_lib.make_mesh(device="cpu")
    out["shape"] = np.array([mesh.shape["data"], mesh.shape["model"]])
    out["coords"] = np.array(mesh.coords)
    r = torch.tensor([rank])
    out["data_peers"] = mesh_lib.all_gather(r, mesh.data_group, 4).numpy()
    out["model_peers"] = mesh_lib.all_gather(r, mesh.model_group, 2).numpy()
    one = mesh_lib.make_mesh(1, device="cpu")
    out["one"] = np.array([one.size, *one.coords, one.data_group is None])
    x = torch.arange(8.0)
    out["one_shard"] = one.shard_batch(x).numpy()
    out["shard"] = mesh.shard_batch(x).numpy()
    out["gathered"] = mesh.gather_batch(mesh.shard_batch(x)).numpy()
    for name, fn in (("bad_n", lambda: mesh_lib.make_mesh(4, device="cpu")),
                     ("bad_b", lambda: mesh.shard_batch(torch.zeros(6)))):
        try:
            fn()
            out[name] = "no error"
        except ValueError as e:
            out[name] = str(e)

    # ---- (b, c) one step on the mesh, two batches ----
    for case in ("identity", "unequal"):
        batch = {k: torch.from_numpy(data[f"{case}/{k}"])
                 for k in ("img_a", "img_b", "corr_px", "px_valid")}
        init_fn, step_fn = train.make_train_step(train.adam(LR), mesh=mesh)
        model = weights.trainable(params, device="cpu")
        whole = {n: p.shape[0] for n, p in model.named_parameters()}
        model, opt = init_fn(model)
        if case == "identity":
            # each parameter this rank holds part of: its rows of the whole
            rows = {n: (p.shape[0], whole[n])
                    for n, p in model.named_parameters()
                    if p.shape[0] != whole[n]}
            out["split_names"] = np.array(sorted(rows))
            out["split_rows"] = np.array([rows[n] for n in sorted(rows)])
            out.update(flat(weights.to_params(model), "round_trip"))
        model, opt, loss, aux = step_fn(model, opt, batch)
        p = weights.to_params(model)
        out[f"{case}/loss"] = float(loss)
        out[f"{case}/aux"] = np.array([float(aux[k]) for k in
                                       ("nce", "kp", "rel", "loc")])
        out[f"{case}/spread"] = spread(p)
        g = weights.grads_to_params(model)
        if rank == 0:
            out.update(flat(p, f"{case}/params"))
            out.update(flat(g, f"{case}/grads"))

    # strict refuses a block5 of 127 channels; without strict it stays whole
    bad = nn.Module()
    bad.block5 = nn.ModuleList([nn.Conv2d(64, 127, 3)])
    try:
        train.param_shardings(mesh, bad, strict=True)
        out["strict"] = "no error"
    except ValueError as e:
        out["strict"] = str(e)
    out["lenient"] = train.param_shardings(mesh, bad)[
        "block5.0.weight"].axis or "whole"

    # ---- (d) the pool trainer: two steps with augmentation ----
    pool = {k: torch.from_numpy(data[f"pool/{k}"])
            for k in ("img_a", "img_b", "corr_px", "px_valid")}
    init_fn, run_fn = train.make_pool_trainer(
        train.adam(LR), steps_per_call=2, augment=True, mesh=mesh)
    model, opt = init_fn(weights.trainable(params, device="cpu"))
    model, opt, loss, aux = run_fn(model, opt, pool,
                                   torch.from_numpy(data["pool/idx"]),
                                   torch.Generator().manual_seed(3))
    p = weights.to_params(model)
    out["pool/loss"] = float(loss)
    out["pool/spread"] = spread(p)
    if rank == 0:
        out.update(flat(p, "pool/params"))

    # ---- (e) the sharded pipeline, float32 and bf16 ----
    model = weights.from_jax_params(params, device="cpu")
    frames = torch.from_numpy(data["frames"])
    for dt in ("float32", "bfloat16"):
        pipe = batched.make_sharded_pipeline(mesh, model, num_keypoints=K,
                                             compute_dtype=getattr(torch, dt))
        for k, v in zip(("kpts", "desc", "valid", "idx", "mask"),
                        pipe(frames)):
            out[f"pipe_{dt}/{k}"] = (v.float() if v.is_floating_point()
                                     else v).numpy()

    np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

"""Self-supervised XFeat training on rendered view pairs, with the port.

Twin of ``tools/train_xfeat.py``: the same flags, pair renderer and loss
(``parallel/train.py``), on the GPU unless ``--device cpu`` is given. It
derives weights in the framework with true cross-view supervision:
descriptor InfoNCE at depth-projected correspondences, a cross-view
teacher for the keypoint head and agreement regression for reliability,
over procedurally rendered room-scene view pairs (baseline, yaw, pitch,
roll and forward motion) with an occlusion check against the second
view's depth. ``--init`` warm-starts from an npz; checkpoints are written
in the JAX package's npz layout, so either package loads them.

    python -m xfeatslam_tpu_torch.tools.train_xfeat --steps 2000 \\
        --out weights/xfeat_synthetic.npz

Like the JAX tool it trains over every device it is given, on a (data,
model) mesh (``parallel/mesh.make_mesh``): one process trains alone; under
``torchrun --nproc-per-node=N`` each rank takes its card (NCCL, or gloo
with ``--device cpu``), the batch goes over the data ranks and the wide
layers over the model ranks, and only rank 0 prints and writes the
checkpoint.

    torchrun --nproc-per-node=4 -m xfeatslam_tpu_torch.tools.train_xfeat \\
        --steps 2000 --batch 16 --out weights/xfeat_synthetic.npz
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _rot(w):
    """Rodrigues: (3,) axis-angle -> (3,3)."""
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3, dtype=np.float32)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * Kx
            + (1 - np.cos(th)) * (Kx @ Kx)).astype(np.float32)


def dense_correspondence(depth_a, depth_b, R_ab, t_ab, K):
    """Dense A->B pixel map from A's depth and the relative pose, with an
    occlusion check against B's rendered depth. Returns (corr (H,W,2)
    float32 x,y in B; valid (H,W) bool)."""
    H, W = depth_a.shape
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    z = depth_a
    ok = z > 0
    X = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], -1)
    Xb = X @ R_ab.T + t_ab
    zb = Xb[..., 2]
    ok &= zb > 0.05
    zs = np.maximum(zb, 1e-6)
    ub = fx * Xb[..., 0] / zs + cx
    vb = fy * Xb[..., 1] / zs + cy
    ok &= (ub >= 1) & (ub < W - 1) & (vb >= 1) & (vb < H - 1)
    # occlusion: the projected depth must match B's surface depth
    ui = np.clip(ub, 0, W - 1).astype(int)
    vi = np.clip(vb, 0, H - 1).astype(int)
    ok &= np.abs(depth_b[vi, ui] - zb) < 0.05 * np.maximum(zb, 1.0)
    corr = np.stack([ub, vb], -1).astype(np.float32)
    corr[~ok] = 0.0
    return corr, ok


def _rand_homography(rng, hw, max_rot=0.45, scale_rng=(0.75, 1.3),
                     max_persp=4e-4, max_shift=10.0):
    """Random center-anchored homography: rotation, anisotropic scale,
    perspective and translation. Returns (3,3) float64 H mapping A->B."""
    H_, W_ = hw
    th = rng.uniform(-max_rot, max_rot)
    sx = rng.uniform(*scale_rng)
    sy = rng.uniform(*scale_rng)
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    S = np.diag([sx, sy, 1.0])
    P = np.eye(3)
    P[2, 0] = rng.uniform(-max_persp, max_persp)
    P[2, 1] = rng.uniform(-max_persp, max_persp)
    T1 = np.eye(3)
    T1[0, 2], T1[1, 2] = -W_ / 2, -H_ / 2
    T2 = np.eye(3)
    T2[0, 2] = W_ / 2 + rng.uniform(-max_shift, max_shift)
    T2[1, 2] = H_ / 2 + rng.uniform(-max_shift, max_shift)
    return T2 @ P @ S @ R @ T1


def _bilinear(img, x, y):
    H_, W_ = img.shape
    x0 = np.clip(np.floor(x).astype(int), 0, W_ - 2)
    y0 = np.clip(np.floor(y).astype(int), 0, H_ - 2)
    wx = np.clip(x - x0, 0, 1)
    wy = np.clip(y - y0, 0, 1)
    return (img[y0, x0] * (1 - wx) * (1 - wy)
            + img[y0, x0 + 1] * wx * (1 - wy)
            + img[y0 + 1, x0] * (1 - wx) * wy
            + img[y0 + 1, x0 + 1] * wx * wy)


def homography_pair(rng, img_a):
    """Warp a rendered view by a random homography: exact dense
    correspondence, no occlusion; stronger in-plane rotation and scale
    change than the orbit renderer's viewpoint changes."""
    H_, W_ = img_a.shape
    Hm = _rand_homography(rng, (H_, W_))
    Hi = np.linalg.inv(Hm)
    u, v = np.meshgrid(np.arange(W_, dtype=np.float64),
                       np.arange(H_, dtype=np.float64))
    # img_b(x) = img_a(H^-1 x)
    den = Hi[2, 0] * u + Hi[2, 1] * v + Hi[2, 2]
    xs = (Hi[0, 0] * u + Hi[0, 1] * v + Hi[0, 2]) / den
    ys = (Hi[1, 0] * u + Hi[1, 1] * v + Hi[1, 2]) / den
    img_b = _bilinear(img_a.astype(np.float32), xs, ys)
    src_ok = (xs >= 0) & (xs < W_ - 1) & (ys >= 0) & (ys < H_ - 1)
    img_b = np.where(src_ok, img_b, 0.0)
    # corr: the A -> B forward map
    den_f = Hm[2, 0] * u + Hm[2, 1] * v + Hm[2, 2]
    ub = (Hm[0, 0] * u + Hm[0, 1] * v + Hm[0, 2]) / den_f
    vb = (Hm[1, 0] * u + Hm[1, 1] * v + Hm[1, 2]) / den_f
    ok = (ub >= 1) & (ub < W_ - 1) & (vb >= 1) & (vb < H_ - 1)
    corr = np.stack([ub, vb], -1).astype(np.float32)
    corr[~ok] = 0.0
    return img_b.astype(np.float32), corr, ok


def render_pair_pool(rng, n_scenes=6, hw=(128, 160), pairs_per_scene=28,
                     f=130.0, homog_per_scene=0):
    """Render a pool of view pairs with ground-truth correspondence:
    img_a, img_b (N,H,W,1) float32 [0,1], corr_px (N,H,W,2), px_valid
    (N,H,W). Pairs with less than 30% covisibility are dropped."""
    from ..utils import synthetic

    K = np.array([[f, 0, hw[1] / 2], [0, f, hw[0] / 2], [0, 0, 1]],
                 np.float32)
    img_a, img_b, corr, valid = [], [], [], []
    for s in range(n_scenes):
        scene = synthetic.RoomScene(seed=100 + s)
        base = synthetic.orbit_trajectory(pairs_per_scene, radius=0.3,
                                          forward_per_frame=0.01)
        for _ in range(homog_per_scene):
            Rh, th = base[int(rng.integers(0, len(base)))]
            a_img, _ = scene.render(K, Rh, th, hw)
            a = a_img.astype(np.float32) / 255.0
            b, c, ok = homography_pair(rng, a)
            if ok.mean() < 0.3:
                continue
            img_a.append(a)
            img_b.append(b)
            corr.append(c)
            valid.append(ok)
        for (Ra, ta) in base:
            # view B: translated, rotated (yaw, pitch, roll), scale change
            dt_c = np.array([rng.uniform(-0.25, 0.25),
                             rng.uniform(-0.12, 0.12),
                             rng.uniform(-0.35, 0.35)], np.float32)
            w = np.array([rng.normal(0, 0.05), rng.normal(0, 0.07),
                          rng.normal(0, 0.10)], np.float32)
            dR = _rot(w)
            Rb = (dR @ Ra).astype(np.float32)
            # camera centres: C_b = C_a + R_wc_a @ dt_c (moved in A's frame)
            Ca = -Ra.T @ ta
            Cb = Ca + Ra.T @ dt_c
            tb = (-Rb @ Cb).astype(np.float32)
            a_img, a_dep = scene.render(K, Ra, ta, hw)
            b_img, b_dep = scene.render(K, Rb, tb, hw)
            R_ab = Rb @ Ra.T
            t_ab = tb - R_ab @ ta
            c, ok = dense_correspondence(a_dep, b_dep, R_ab, t_ab, K)
            if ok.mean() < 0.3:
                continue  # too little covisibility to supervise
            img_a.append(a_img.astype(np.float32) / 255.0)
            img_b.append(b_img.astype(np.float32) / 255.0)
            corr.append(c)
            valid.append(ok)
    return {
        "img_a": np.stack(img_a)[..., None],
        "img_b": np.stack(img_b)[..., None],
        "corr_px": np.stack(corr),
        "px_valid": np.stack(valid),
    }


def parser():
    ap = argparse.ArgumentParser(
        prog="python -m xfeatslam_tpu_torch.tools.train_xfeat",
        description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--scenes", type=int, default=6)
    ap.add_argument("--pairs-per-scene", type=int, default=28)
    ap.add_argument("--hw", type=int, nargs=2, default=(128, 160),
                    help="crop size of the rendered training pairs; larger "
                    "crops raise correspondence-supervision fidelity at "
                    "render/step cost")
    ap.add_argument("--out", default="weights/xfeat_synthetic.npz")
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--init", default=None,
                    help="warm-start weights npz (e.g. the shipped ones)")
    ap.add_argument("--homog-per-scene", type=int, default=0,
                    help="additional homography-warped pairs per scene")
    ap.add_argument("--kp-teacher", default="contrast",
                    choices=["contrast", "peak"])
    ap.add_argument("--response", default="contrast5",
                    choices=["contrast5", "shitomasi"],
                    help="analytic response the peak teacher distills")
    ap.add_argument("--sigma", type=float, default=0.7,
                    help="peak-teacher Gaussian std (px)")
    ap.add_argument("--loc-weight", type=float, default=0.0,
                    help="cross-view localization-agreement loss weight "
                    "(trains the within-cell soft-argmax peak of view A, "
                    "warped through the GT correspondence, to coincide "
                    "with view B's peak)")
    ap.add_argument("--aug", action="store_true",
                    help="photometric augmentation of network inputs")
    ap.add_argument("--steps-per-call", type=int, default=16,
                    help="optimizer steps per trainer call over the pool on "
                    "the device (one read of the losses per call)")
    ap.add_argument("--cosine", action="store_true",
                    help="5%% warmup + cosine decay to lr/20 over --steps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def main(argv=None):
    """Train as the flags say; returns the trained model (in place on its
    device)."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.hw[0] % 32 or args.hw[1] % 32:
        ap.error(f"--hw {args.hw[0]} {args.hw[1]}: the XFeat forward needs "
                 "H and W to be multiples of 32 (fail fast here, not after "
                 "the pool render)")

    import torch
    import torch.distributed as dist

    from .. import resolve_device
    from ..models import weights as wio
    from ..parallel import mesh as mesh_lib, train
    from . import float32_math

    float32_math()
    dev = resolve_device(args.device)
    # under torchrun: join its ranks, each on its own card
    joined = (int(os.environ.get("WORLD_SIZE", "1")) > 1
              and not dist.is_initialized())
    if joined:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    mesh = mesh_lib.make_mesh(device=dev)
    dev = mesh.device
    lead = mesh.rank == 0
    say = print if lead else (lambda *a, **kw: None)  # rank 0 speaks

    def save(path, model):
        params = wio.to_params(model)  # every rank: it gathers the layers
        if lead:
            wio.save_npz(path, params)

    say("device:", dev, torch.cuda.get_device_name(dev)
        if dev.type == "cuda" else "", f"mesh {mesh.shape}", flush=True)
    rng = np.random.default_rng(0)
    say("rendering training pair pool...", flush=True)
    pool = render_pair_pool(rng, n_scenes=args.scenes,
                            pairs_per_scene=args.pairs_per_scene,
                            hw=tuple(args.hw),
                            homog_per_scene=args.homog_per_scene,
                            # keep the FOV of the default 128x160 crops
                            f=130.0 * args.hw[1] / 160.0)
    n_pool = len(pool["img_a"])
    say(f"pool: {n_pool} pairs of {pool['img_a'].shape[1:3]}", flush=True)

    lr = (train.warmup_cosine_schedule(args.lr, args.steps) if args.cosine
          else args.lr)
    loss_kw = dict(kp_teacher=args.kp_teacher, response=args.response,
                   sigma=args.sigma, loc_weight=args.loc_weight)
    S = max(args.steps_per_call, 1)
    init_fn, run_fn = train.make_pool_trainer(
        train.adam(lr), steps_per_call=S, augment=args.aug, mesh=mesh,
        **loss_kw)
    model, opt = init_fn(wio.trainable(args.init or 0, device=dev))
    pool_dev = {k: torch.from_numpy(v).to(dev) for k, v in pool.items()}
    gen = torch.Generator(device=dev).manual_seed(1)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    t0 = time.time()
    n_calls = -(-args.steps // S)
    for call in range(n_calls):
        step = call * S
        idx = torch.from_numpy(rng.integers(0, n_pool, (S, args.batch))).to(dev)
        model, opt, loss, aux = run_fn(model, opt, pool_dev, idx, gen)
        if call % max(1, 50 // S) == 0:
            extra = (f" loc={float(aux['loc']):.3f}"
                     if float(args.loc_weight) > 0 else "")
            say(f"step {step}: loss={float(loss):.4f} "
                f"nce={float(aux['nce']):.3f} kp={float(aux['kp']):.3f} "
                f"rel={float(aux['rel']):.3f}{extra} "
                f"({(time.time()-t0)/max(step+S,1):.3f}s/step)", flush=True)
        if step and args.save_every and step % args.save_every < S:
            save(args.out, model)
            say(f"saved {args.out} at step {step}", flush=True)
    save(args.out, model)
    say(f"done: {args.out}", flush=True)
    if joined:
        dist.destroy_process_group()
    return model


if __name__ == "__main__":
    main()

"""Per-stage device times of the port's batched extract + match path.

Twin of ``tools/profile_pipeline.py``. Each stage is timed by CUDA events
around ``--iters`` back-to-back calls after warm-up calls (host timers with
``--device cpu``): the forward, the ``detect_candidates`` kernel, the top-k,
the ``keypoint_desc`` kernel, the whole selection (``select_keypoints``),
the matcher (``match_consecutive``) and the end-to-end path. The input is a
copy of ``bench.make_images`` at 480x640 (random images at other sizes) and
the shipped weights. Float32 unless ``--dtype bfloat16``.

    python -m xfeatslam_tpu_torch.tools.profile_pipeline [--batch 256]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def conv_flops(hw):
    """Analytic FLOPs per frame of the XFeat conv stack at input ``hw``."""
    H, W = hw
    f = 0
    # (Hout, Wout, cin, cout, k)
    layers = [
        (H, W, 1, 4, 3), (H // 2, W // 2, 4, 8, 3),
        (H // 2, W // 2, 8, 8, 3), (H // 4, W // 4, 8, 24, 3),  # block1
        (H // 4, W // 4, 1, 24, 1),  # skip1
        (H // 4, W // 4, 24, 24, 3), (H // 4, W // 4, 24, 24, 3),  # block2
        (H // 8, W // 8, 24, 64, 3), (H // 8, W // 8, 64, 64, 3),
        (H // 8, W // 8, 64, 64, 1),  # block3
        (H // 16, W // 16, 64, 64, 3), (H // 16, W // 16, 64, 64, 3),
        (H // 16, W // 16, 64, 64, 3),  # block4
        (H // 32, W // 32, 64, 128, 3), (H // 32, W // 32, 128, 128, 3),
        (H // 32, W // 32, 128, 128, 3), (H // 32, W // 32, 128, 64, 1),  # b5
        (H // 8, W // 8, 64, 64, 3), (H // 8, W // 8, 64, 64, 3),
        (H // 8, W // 8, 64, 64, 1),  # fusion
        (H // 8, W // 8, 64, 64, 1), (H // 8, W // 8, 64, 64, 1),
        (H // 8, W // 8, 64, 1, 1),  # heatmap head
        (H // 8, W // 8, 64, 64, 1), (H // 8, W // 8, 64, 64, 1),
        (H // 8, W // 8, 64, 64, 1), (H // 8, W // 8, 64, 65, 1),  # kp head
    ]
    for (h, w, ci, co, k) in layers:
        f += 2 * h * w * ci * co * k * k
    return f


def make_images(n, hw=(480, 640)):
    """A copy of bench.make_images: smooth pattern plus 40 Gaussian blobs,
    (n, H, W, 1) float32 in [0, 1]."""
    H, W = hw
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    imgs = []
    for i in range(n):
        img = 0.5 + 0.3 * np.sin(xx / 21 + i) * np.cos(yy / 17 - i)
        for _ in range(40):
            cy, cx = rng.uniform(20, H - 20), rng.uniform(20, W - 20)
            img += 0.4 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 25.0)
        imgs.append(np.clip(img, 0, 1).astype(np.float32))
    return np.stack(imgs)[..., None]


def stage_ms(fn, device, iters=20, warmup=3):
    """Milliseconds per call of ``fn``: CUDA events around ``iters`` calls
    on a GPU, the host clock (with a synchronize) otherwise."""
    import torch

    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def profile(batch=256, hw=(480, 640), kpts=1000, dtype="float32",
            device=None, iters=20):
    """The stage times of one batch: a list of (stage, ms per batch,
    note)."""
    import torch

    from .. import resolve_device
    from ..models import weights as wio
    from ..models.xfeat import init_params
    from ..ops import cuda_kernels as ck
    from ..ops import detect
    from ..parallel import batched

    dev = resolve_device(device)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    H, W = hw
    B, K = batch, kpts
    if (H, W) == (480, 640):
        x = torch.from_numpy(make_images(B, hw)).to(dev)
    else:
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.random((B, H, W, 1), np.float32)).to(dev)
    # the shipped weights: detect's candidates follow trained weights'
    # sparsity
    weights = os.path.join(_REPO, "weights", "xfeat_synthetic.npz")
    model = (wio.load_npz(weights, dev) if os.path.exists(weights)
             else wio.from_jax_params(init_params(0), dev))

    def ms(fn):
        return stage_ms(fn, dev, iters=iters)

    with torch.no_grad():
        t_fwd = ms(lambda: model(x, compute_dtype=dt))
        feats, logits, heat = model(x, compute_dtype=dt)
        logits, heat = logits.contiguous(), heat.contiguous()
        H8, W8 = feats.shape[1:3]
        flat = feats.reshape(B, H8 * W8, -1).contiguous()
        t_cand = ms(lambda: ck.detect_candidates(logits, heat))
        vals, aux = ck.detect_candidates(logits, heat)
        t_topk = ms(lambda: torch.topk(vals.reshape(B, -1), K, dim=1))
        scores, sel = torch.topk(vals.reshape(B, -1), K, dim=1)
        t_kd = ms(lambda: ck.keypoint_desc(flat, scores, sel, aux, W8, False))
        t_det = ms(lambda: detect.select_keypoints(feats, logits, heat, K))
        out = detect.select_keypoints(feats, logits, heat, K)
        t_match = ms(lambda: batched.match_consecutive(out["desc"],
                                                       out["valid"]))

        def pipe():
            o = batched.extract_batch(model, x, K, dt)
            return batched.match_consecutive(o["desc"], o["valid"])

        t_pipe = ms(pipe)
    fl = conv_flops((H, W)) * B
    return [
        ("forward (CNN)", t_fwd, f"{fl / t_fwd / 1e9:.2f} TFLOP/s"),
        ("  detect_candidates", t_cand, "kernel"),
        ("  top-K", t_topk, "torch.topk"),
        ("  keypoint_desc", t_kd, "kernel"),
        ("detect (select)", t_det, ""),
        ("match consecutive", t_match, "kernel"),
        ("end-to-end pipeline", t_pipe, f"{B / t_pipe * 1e3:.1f} fps"),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m xfeatslam_tpu_torch.tools.profile_pipeline",
        description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--hw", type=int, nargs=2, default=[480, 640])
    ap.add_argument("--kpts", type=int, default=1000)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.hw[0] % 32 or args.hw[1] % 32:
        ap.error("--hw: H and W must be multiples of 32")
    from . import float32_math

    float32_math()
    B = args.batch
    print(f"batch={B} hw={args.hw[0]}x{args.hw[1]} K={args.kpts} "
          f"dtype={args.dtype}")
    rows = profile(B, tuple(args.hw), args.kpts, args.dtype, args.device,
                   args.iters)
    print(f"{'stage':24s} {'ms/batch':>10s} {'ms/frame':>10s}  note")
    for name, t, note in rows:
        print(f"{name:24s} {t:10.3f} {t / B:10.4f}  {note}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU.

Usage: python3 chip_smoke.py [--batch N]   (from the repository root, one
CUDA card; the batch defaults to 32)

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
     TF32 off for float32 parity;
  2. build every CUDA kernel of ``xfeatslam_tpu_torch/csrc`` with nvcc;
  3. the main path once with the launch counters zeroed just before:
     ``extract_batch`` + ``match_consecutive`` on a batch of frames at 640x480,
     K=1000, float32, the shipped weights; every kernel must have launched;
  4. each kernel against its plain PyTorch version on the tensors of that
     run, and the whole path against the plain path on the same card;
  5. ``XFeatExtractor()`` on one 500x700 uint8 frame (resize, sub-pixel
     selection, coordinate rescale);
  6. CUDA-event timings of the forward, each kernel and its plain version,
     the top-k, a PyTorch yardstick call where one computes the same
     function, the stages of one batch and the end-to-end frame rate.

Prints ``kernels: {...}`` with the main run's launch counts, one JSON line
``{"kernels": [...]}`` with each kernel's numbers, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
no CUDA device is available or the package is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
H, W, K = 480, 640, 1000
# NVIDIA H100 SXM data sheet: HBM bandwidth and the float32 rate of the
# CUDA cores (no tensor cores), both at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# float ops per pixel of the detect post-processing, counted from the
# algorithm at its least: softmax ~6 (per logit: scale, max, sub, exp, sum,
# div), separable 5x5 NMS 10, reliability bilinear ~8, score 2, 3x3
# soft-argmax with quantize and pack ~25, per-cell top-9 selection ~18.
DETECT_OPS_PER_PIXEL = 70
KERNEL_SOURCES = {
    "detect_candidates": ("xfeatslam_tpu_torch/csrc/detect_candidates.cu",
                          "xfeatslam_tpu/ops/pallas_kernels.py:375"),
    "bilinear_desc_sample": ("xfeatslam_tpu_torch/csrc/desc_sample.cu",
                             "xfeatslam_tpu/ops/pallas_kernels.py:505"),
    "mutual_nn_pairs": ("xfeatslam_tpu_torch/csrc/mnn_pairs.cu",
                        "xfeatslam_tpu/ops/pallas_kernels.py:596"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def make_images(n):
    """A copy of bench.make_images: smooth pattern plus 40 Gaussian blobs."""
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


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops):
    """The least time for the work: bytes over HBM rate or float32 ops over
    the CUDA-core peak, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def plain_kernels(ck):
    """Route the wrappers to their plain versions, for the plain path."""
    names = ("detect_candidates", "bilinear_desc_sample", "mutual_nn_pairs")
    saved = {n: getattr(ck, n) for n in names}
    try:
        for n in names:
            setattr(ck, n, getattr(ck, n + "_plain"))
        yield
    finally:
        for n, f in saved.items():
            setattr(ck, n, f)


def jaccard(a, b):
    return len(a & b) / max(len(a | b), 1)


def pixel_set(kpts, valid):
    return {tuple(p) for p in kpts[valid].round().astype(np.int64)}


def pair_set(kpts, idx, b):
    return {(tuple(kpts[b, i].round().astype(np.int64)),
             tuple(kpts[b + 1, j].round().astype(np.int64)))
            for i, j in enumerate(idx[b]) if j >= 0}


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    if smi.returncode != 0 or not smi.stdout.strip():
        return f"nvidia-smi failed: {smi.stderr.strip()}"
    return smi.stdout.strip().splitlines()[0]


def compare_detect(ck, logits, heat, nc, label):
    """detect_candidates kernel vs plain: same survivor mask and channels
    on >= 99.99% of slots, vals within 1e-6 where both are survivors."""
    vk, ak = ck.detect_candidates(logits, heat, nc=nc)
    vp, ap = ck.detect_candidates_plain(logits, heat, nc=nc)
    sk, sp = vk > 0, vp > 0
    both = sk & sp
    check(bool(both.any()), f"detect [{label}]: no survivor to compare")
    mask_agree = float((sk == sp).float().mean())
    err = float((vk - vp).abs()[both].max())
    ch_agree = float(((ak[both].int() >> 18) == (ap[both].int() >> 18))
                     .float().mean())
    print(f"detect [{label}]: survivor mask agreement {mask_agree:.6f}, vals "
          f"max abs err {err:.3e}, channel agreement {ch_agree:.6f} over "
          f"{int(both.sum())} survivors")
    check(mask_agree >= 0.9999, f"detect [{label}]: survivor masks disagree")
    check(err <= 1e-6, f"detect [{label}]: vals differ by more than 1e-6")
    check(ch_agree >= 0.9999, f"detect [{label}]: candidate channels disagree")
    return {"max_abs_err": err}


def compare_desc(ck, feats_flat, idx4, w4, label):
    """bilinear_desc_sample kernel vs plain: rows with a nonzero weight
    within 1e-5, rows without exactly zero."""
    dk = ck.bilinear_desc_sample(feats_flat, idx4, w4)
    dp = ck.bilinear_desc_sample_plain(feats_flat, idx4, w4)
    v = (w4 != 0).any(-1)
    err = float((dk - dp).abs()[v].max())
    print(f"desc [{label}]: max abs err {err:.3e} over {int(v.sum())} rows")
    check(err <= 1e-5, f"desc [{label}]: rows differ by more than 1e-5")
    check(bool((dk[~v] == 0).all()), f"desc [{label}]: zero-weight rows not zero")
    return {"max_abs_err": err}


def compare_mnn(ck, args, label):
    """mutual_nn_pairs kernel vs plain: best column equal on >= 99.9% of
    valid rows, best distance within 1e-3 where they agree, column best
    equal on >= 99.9% of valid columns."""
    mk = ck.mutual_nn_pairs(*args)
    mp = ck.mutual_nn_pairs_plain(*args)
    va, vb = args[2], args[3]
    idx_agree = float((mk[2] == mp[2])[va].float().mean())
    col_agree = float((mk[3] == mp[3])[vb].float().mean())
    same = va & (mk[2] == mp[2]) & torch.isfinite(mp[0])
    err = float((mk[0] - mp[0]).abs()[same].max())
    print(f"mnn [{label}]: idx agreement {idx_agree:.6f} on valid rows, column "
          f"best agreement {col_agree:.6f}, best-distance max abs err {err:.3e}")
    check(idx_agree >= 0.999, f"mnn [{label}]: best columns disagree")
    check(col_agree >= 0.999, f"mnn [{label}]: column best rows disagree")
    check(err <= 1e-3, f"mnn [{label}]: distances differ by more than 1e-3")
    return {"max_abs_err": err}


def odd_shape_checks(ck, detect, dev):
    """The kernels against their plain versions off the main path's shapes:
    dense random survivors, a ragged last detect strip, nc=5, keypoints out
    of bounds, K and N != M not multiples of any tile, a pair with no valid
    column."""
    rng = np.random.default_rng(1)

    def t(a):
        return torch.tensor(a, device=dev)

    B, H8, W8 = 2, 13, 120  # 960 px wide: 2-row strips, the last one ragged
    logits = t((rng.standard_normal((B, H8, W8, 65)) * 3).astype(np.float32))
    heat = t(rng.uniform(size=(B, H8, W8, 1)).astype(np.float32))
    for nc in (5, 9):
        compare_detect(ck, logits, heat, nc, f"random {B}x{H8}x{W8}, nc={nc}")

    Kq = 37
    kpts = np.stack([rng.uniform(-3, W8 * 8 + 2, (B, Kq)),
                     rng.uniform(-3, H8 * 8 + 2, (B, Kq))], -1)
    idx4, w4 = detect.desc_taps(t(kpts.astype(np.float32)),
                                t(rng.uniform(size=(B, Kq)) > 0.2), H8, W8)
    feats = t(rng.standard_normal((B, H8 * W8, 64)).astype(np.float32))
    compare_desc(ck, feats, idx4, w4, f"random K={Kq}, out-of-bounds taps")

    P, N, M = 3, 300, 257
    a = rng.standard_normal((P, N, 64)).astype(np.float32)
    b = rng.standard_normal((P, M, 64)).astype(np.float32)
    b[:, :120] = a[:, :120] + 0.05 * rng.standard_normal((P, 120, 64))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    vb = rng.uniform(size=(P, M)) > 0.1
    vb[0] = False
    compare_mnn(ck, (t(a), t(b), t(rng.uniform(size=(P, N)) > 0.1), t(vb)),
                f"random {P}x{N}x{M}, one pair without valid columns")


def run(batch: int):
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    sys.path.insert(0, REPO)
    from xfeatslam_tpu_torch import _build
    from xfeatslam_tpu_torch.models import weights
    from xfeatslam_tpu_torch.models.extractor import XFeatExtractor
    from xfeatslam_tpu_torch.ops import cuda_kernels as ck
    from xfeatslam_tpu_torch.ops import detect
    from xfeatslam_tpu_torch.parallel import batched

    # ---- build ----
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(_build.KERNELS)} "
          f"kernels (parallel nvcc, sm_90a)")

    dev = torch.device("cuda")
    model = weights.load_npz(os.path.join(REPO, "weights", "xfeat_synthetic.npz"))
    t0 = time.perf_counter()
    images = torch.from_numpy(make_images(batch)).to(dev)
    print(f"images: {tuple(images.shape)} made in "
          f"{time.perf_counter() - t0:.2f} s")

    def main_path():
        o = batched.extract_batch(model, images, K)
        return o, batched.match_consecutive(o["desc"], o["valid"])

    # ---- the main path, counted ----
    ck.reset_launch_counts()
    out, res = main_path()
    torch.cuda.synchronize()
    launches = ck.launch_counts()
    print("kernels: " + json.dumps(launches))
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    check(out["kpts"].shape == (batch, K, 2) and out["desc"].shape == (batch, K, 64),
          "main path output shapes")
    for k in ("kpts", "scores", "desc"):
        check(bool(torch.isfinite(out[k]).all()), f"non-finite {k}")
    check(res.idx.shape == (batch - 1, K), "match output shape")
    nvalid = out["valid"].sum(1)
    check(bool((nvalid > 0).all()), "a frame has no keypoint")
    print(f"main path: valid keypoints per frame min {int(nvalid.min())} "
          f"max {int(nvalid.max())}; matches per pair mean "
          f"{float(res.mask.sum(1).float().mean()):.1f}")

    # ---- kernels against their plain versions, on the main path's tensors ----
    with torch.no_grad():
        feats, logits, heat = model(images)
    logits, heat = logits.contiguous(), heat.contiguous()
    B, H8, W8, _ = feats.shape
    feats_flat = feats.reshape(B, H8 * W8, 64).contiguous()

    report = {
        "detect_candidates": compare_detect(ck, logits, heat, 9, "main path"),
    }
    vk, ak = ck.detect_candidates(logits, heat)
    idx4, w4 = detect.desc_taps(out["kpts"], out["valid"], H8, W8)
    report["bilinear_desc_sample"] = compare_desc(ck, feats_flat, idx4, w4,
                                                  "main path")
    desc, valid = out["desc"], out["valid"]
    args = (desc[:-1], desc[1:], valid[:-1], valid[1:])
    report["mutual_nn_pairs"] = compare_mnn(ck, args, "main path")
    odd_shape_checks(ck, detect, dev)

    # ---- the whole path against the plain path on the same card ----
    with plain_kernels(ck):
        out_p = batched.extract_batch(model, images, K)
        res_p = batched.match_consecutive(out_p["desc"], out_p["valid"])
    mask_agree = float((res.mask == res_p.mask).float().mean())
    check(mask_agree >= 0.999, "match masks disagree with the plain path")
    kk, kp = out["kpts"].cpu().numpy(), out_p["kpts"].cpu().numpy()
    vk_, vp_ = out["valid"].cpu().numpy(), out_p["valid"].cpu().numpy()
    check((vk_.sum(1) == vp_.sum(1)).all(), "valid counts differ from the plain path")
    kj = min(jaccard(pixel_set(kk[b], vk_[b]), pixel_set(kp[b], vp_[b]))
             for b in range(batch))
    ik, ip = res.idx.cpu().numpy(), res_p.idx.cpu().numpy()
    pj = min(jaccard(pair_set(kk, ik, b), pair_set(kp, ip, b))
             for b in range(batch - 1))
    print(f"path vs plain path: keypoint Jaccard min {kj:.6f}, matched-pair "
          f"Jaccard min {pj:.6f}, match mask agreement {mask_agree:.6f}")
    check(kj >= 0.999, "keypoint sets differ from the plain path")
    check(pj >= 0.995, "matched pairs differ from the plain path")

    # ---- the SLAM extractor facade on a frame that needs resizing ----
    frame = (make_images(1)[0, :, :, 0] * 255).astype(np.uint8)
    frame = np.pad(frame, ((10, 10), (30, 30)), mode="reflect")[:500, :700]
    ex = XFeatExtractor()
    fo = ex(frame)
    check(fo["kpts"].shape == (1, 1000, 2) and fo["desc"].shape == (1, 1000, 64),
          "extractor output shapes")
    kv = fo["kpts"][0][fo["valid"][0]]
    check(len(kv) > 0, "extractor found no keypoint")
    lo, hi = kv.min(0), kv.max(0)
    # a border pixel's sub-pixel offset may reach one (resized) pixel out
    check(lo.min() >= -1.1 and hi[0] <= 700 and hi[1] <= 500,
          "extractor coordinates outside the frame")
    print(f"extractor: 500x700 frame -> {len(kv)} valid keypoints, x in "
          f"[{lo[0]:.3f}, {hi[0]:.3f}], y in [{lo[1]:.3f}, {hi[1]:.3f}]")

    # ---- timings ----
    P = batch - 1
    times = {}
    times["forward"] = cuda_ms(lambda: model(images))
    times["detect"] = cuda_ms(lambda: ck.detect_candidates(logits, heat))
    times["detect_plain"] = cuda_ms(lambda: ck.detect_candidates_plain(logits, heat))
    times["topk_decode"] = cuda_ms(lambda: detect._candidates_topk(vk, ak, K, W8))
    times["desc_taps"] = cuda_ms(lambda: detect.desc_taps(out["kpts"], out["valid"],
                                                          H8, W8))
    times["desc"] = cuda_ms(lambda: ck.bilinear_desc_sample(feats_flat, idx4, w4))
    times["desc_plain"] = cuda_ms(
        lambda: ck.bilinear_desc_sample_plain(feats_flat, idx4, w4))
    fn = torch.nn.functional.normalize(feats, dim=-1).permute(0, 3, 1, 2)
    grid = torch.stack([out["kpts"][..., 0] / (W - 1) * 2 - 1,
                        out["kpts"][..., 1] / (H - 1) * 2 - 1], -1)[:, :, None]
    times["desc_library"] = cuda_ms(lambda: torch.nn.functional.grid_sample(
        fn, grid, mode="bilinear", align_corners=False))
    times["mnn"] = cuda_ms(lambda: ck.mutual_nn_pairs(*args))
    times["mnn_plain"] = cuda_ms(lambda: ck.mutual_nn_pairs_plain(*args))
    times["mnn_library"] = cuda_ms(lambda: torch.bmm(desc[:-1],
                                                     desc[1:].transpose(1, 2)))
    times["extract"] = cuda_ms(lambda: batched.extract_batch(model, images, K),
                               iters=10)
    times["match"] = cuda_ms(
        lambda: batched.match_consecutive(out["desc"], out["valid"]))
    times["end_to_end"] = cuda_ms(main_path, iters=10)
    print("stage ms at batch %d: %s" % (batch, json.dumps(
        {k: round(v, 4) for k, v in times.items()})))
    print(f"end to end: {batch / times['end_to_end'] * 1e3:.1f} frames/s "
          f"({times['end_to_end']:.3f} ms per batch of {batch})")

    # ---- bounds from this run's inputs ----
    nz = w4 != 0
    grid_rows = idx4.long() + (torch.arange(B, device=dev) * H8 * W8)[:, None, None]
    touched = int(torch.unique(grid_rows[nz]).numel())
    nvb = valid[1:].sum(1).double()
    bounds = {
        "detect_candidates": bound_ms(
            (logits.numel() + heat.numel() + vk.numel() + ak.numel()) * 4,
            DETECT_OPS_PER_PIXEL * B * H * W),
        "bilinear_desc_sample": bound_ms(
            touched * 64 * 4 + (idx4.numel() + w4.numel() + B * K * 64) * 4,
            int(nz.sum()) * 64 * 4 + B * K * 64 * 3),
        # one similarity matrix over the valid columns gives both passes
        "mutual_nn_pairs": bound_ms(
            2 * P * K * 64 * 4 + 2 * P * K + 4 * P * K * 4,
            float(2 * 64 * K * nvb.sum())),
    }
    timed = {"detect_candidates": ("detect", "detect_plain", None),
             "bilinear_desc_sample": ("desc", "desc_plain", "desc_library"),
             "mutual_nn_pairs": ("mnn", "mnn_plain", "mnn_library")}
    rows_out = []
    for name, (t_k, t_p, t_l) in timed.items():
        src, rep = KERNEL_SOURCES[name]
        b_ms, b_by = bounds[name]
        rows_out.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name],
            "max_abs_err": report[name]["max_abs_err"],
            "ms": times[t_k], "plain_ms": times[t_p],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": times[t_l] if t_l else None,
        })
    print(json.dumps({"kernels": rows_out}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32,
                    help="frames per batch of the main path (default 32)")
    args = ap.parse_args()
    if args.batch < 2:
        ap.error("--batch must be at least 2 (frames are matched in pairs)")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA device", file=sys.stderr)
        return 1
    try:
        run(args.batch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

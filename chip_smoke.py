#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU.

Usage: python3 chip_smoke.py [--batch N]   (from the repository root, one
CUDA card; the batch defaults to 32)

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
     TF32 off for float32 parity;
  2. build every CUDA kernel of ``xfeatslam_tpu_torch/csrc`` with nvcc;
  3. the batched path once with the launch counters zeroed just before:
     ``extract_batch`` + ``match_consecutive`` on a batch of frames at 640x480,
     K=1000, float32, the shipped weights; each of its kernels
     (``detect_candidates``, ``keypoint_desc``, ``mutual_nn_pairs``) must
     have launched exactly once;
  4. each kernel against its plain PyTorch version on the tensors of that
     run and at odd shapes: ``detect_candidates`` bit for bit on every slot,
     also on frame 0 alone (batch 1), at a ragged strip, a width that is no
     multiple of the column split and on a lattice of 4-9 survivors per
     cell, each with its launch's grid; ``keypoint_desc`` with ``subpixel``
     both ways; the descriptors-at-keypoints path
     (``detect.sample_descriptors``, ``bilinear_desc_sample``), counted; one
     call of the extraction wrappers under
     ``torch.cuda.set_sync_debug_mode("error")``; the two matcher kernels
     also on inputs full of exact ties (duplicated columns, duplicated
     rows, valid all-zero rows, prefix masks, all-valid masks), where the
     first index must win, at
     P=31 and P=1, M=4096, N=1 and M=1, each with its launch's CTA count;
     one call of each matcher wrapper under
     ``torch.cuda.set_sync_debug_mode("error")``; the whole path against the
     plain path on the same card;
  5. ``XFeatExtractor()`` on one 500x700 uint8 frame (resize, sub-pixel
     selection, coordinate rescale);
  6. the single-pair matcher path, counted: ``match_consecutive(fused=False)``
     (``match_mutual_nn`` pair by pair through ``similarity_top2``) against the
     batched matcher; ``match_mutual_nn`` fused against unfused; the kernel
     against its plain version on frames 0 and 1 and at odd shapes;
  7. the online RGB-D frame step: 6 synthetic frames at 640x480 (TUM1
     intrinsics), a map back-projected from frame 0 (stage 1: M1=1000
     slots, stage 2: a 4096-row local map), ``xfeat_rgbd_frame_step`` on
     frames 1-5, counted per frame, held to the ground truth (< 1 cm) and to
     the plain-kernel path; the same frames by replay of the step's CUDA
     graph (``track_step.RgbdFrameStepGraph``), bit for bit against the
     eager step, with one ``detect_candidates`` and one ``keypoint_desc``
     recorded at capture; the monocular configuration once; no host sync
     inside a step (``torch.cuda.set_sync_debug_mode``);
  8. the RGB-D SLAM host, counted: ``System.track_rgbd`` (no loop closing)
     on 40 rendered frames at 640x480, K=1000, the shipped weights, held to
     the JAX package's 40-frame bars (every frame OK, camera centre within
     3 cm everywhere and 1 cm at the median), at least 30 frames through
     the captured step; the host wall time per frame, the ``track`` and
     ``backend`` spans, local BA per round, the map's size;
  9. CUDA-event timings of the forward, each kernel and its plain version
     (detect also at batch 1), the top-k, a PyTorch yardstick call where one
     computes the same function, the stages of one batch
     (``match_consecutive`` both ways) and the end-to-end frame rate; the
     kernels', the top-k's and the matchers' yardsticks' device time alone,
     by CUDA-graph replay; the frame step per frame eager and by graph
     replay, its parts, its host wall time and its CUDA kernel count
     (``torch.profiler``).

Prints ``kernels: {...}`` with each path's launch counts, one JSON line
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
import warnings

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
    "keypoint_desc": ("xfeatslam_tpu_torch/csrc/desc_sample.cu",
                      "xfeatslam_tpu/ops/pallas_kernels.py:505"),
    "mutual_nn_pairs": ("xfeatslam_tpu_torch/csrc/mnn_pairs.cu",
                        "xfeatslam_tpu/ops/pallas_kernels.py:596"),
    "similarity_top2": ("xfeatslam_tpu_torch/csrc/mnn_pairs.cu",
                        "xfeatslam_tpu/ops/pallas_kernels.py:84"),
}
# the kernels each path must launch
BATCHED_KERNELS = {"detect_candidates": 1, "keypoint_desc": 1,
                   "mutual_nn_pairs": 1}
FRAME_STEP_KERNELS = ("detect_candidates", "keypoint_desc")
# the online frame step: TrackerConfig's XFeat defaults (slam/tracking.py)
# and the local-map bucket
M1, M2 = 1000, 4096
BF, DEPTH_EDGE_REL, INV_SIGMA2 = 40.0, 0.05, 1.0
RADIUS_MOTION, RADIUS_LOCAL, TH_HIGH, RATIO = 15.0, 10.0, 1000.0, 0.9
WIDEN_BELOW, SCALE_FACTOR = 20, 1.2
N_FRAMES = 6
# frames of the SLAM phase (the 40-frame bars of the JAX package's
# test_slam_integration.py)
SLAM_FRAMES, SLAM_MIN_CAPTURED = 40, 30


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


def graph_ms(fn, calls=20, replays=10):
    """Device time of one call of ``fn`` in ms, with no host cost in it:
    ``calls`` calls captured in a CUDA graph, replayed ``replays`` times
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def bound_ms(nbytes, flops):
    """The least time for the work: bytes over HBM rate or float32 ops over
    the CUDA-core peak, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def plain_kernels(ck):
    """Route the wrappers to their plain versions, for the plain path."""
    names = tuple(KERNEL_SOURCES)
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


def detect_note(ck, B, H8, W8):
    ctas, S, parts = ck.detect_grid(
        B, H8, W8, torch.cuda.get_device_properties(0).multi_processor_count)
    return f"{ctas} CTAs of {S} cell rows x {-(-W8 // parts)} cell columns"


def compare_detect(ck, logits, heat, nc, label):
    """detect_candidates kernel vs plain on every slot: vals equal, aux
    equal (channel and both quantized offsets), so the survivor mask too;
    the whole tensors must be bit-identical."""
    vk, ak = ck.detect_candidates(logits, heat, nc=nc)
    vp, ap = ck.detect_candidates_plain(logits, heat, nc=nc)
    sk, sp = vk > -1, vp > -1
    check(bool(sp.any()), f"detect [{label}]: no survivor to compare")
    mask_agree = float((sk == sp).float().mean())
    err = float((vk - vp).abs().max())
    aux_agree = float((ak == ap).float().mean())
    per_cell = (vp > -1).sum(2).max()
    print(f"detect [{label}; {detect_note(ck, *logits.shape[:3])}]: on all "
          f"{vk.numel()} slots survivor mask agreement {mask_agree:.6f}, vals "
          f"max abs err {err:.3e}, aux agreement {aux_agree:.6f}; "
          f"{int(sp.sum())} survivors, at most {int(per_cell)} in a cell")
    check(torch.equal(vk, vp) and torch.equal(ak, ap),
          f"detect [{label}]: candidates differ from the plain version")
    return {"max_abs_err": err}


def compare_kpdesc(ck, feats_flat, vals, aux, k, subpixel, label):
    """keypoint_desc kernel vs plain on the top-k of the candidates ``vals``:
    kpts within 1e-6, desc within 1e-5 on valid rows, invalid rows exactly
    zero."""
    B, H8, _, W8 = vals.shape
    scores, sel = torch.topk(vals.reshape(B, -1), k, dim=1)
    kk, dk = ck.keypoint_desc(feats_flat, scores, sel, aux, W8, subpixel)
    kp, dp = ck.keypoint_desc_plain(feats_flat, scores, sel, aux, W8, subpixel)
    v = scores > 0
    check(bool(v.any()), f"kpdesc [{label}]: no valid keypoint")
    kerr = float((kk - kp).abs().max())
    derr = float((dk - dp).abs()[v].max())
    print(f"kpdesc [{label}, subpixel={subpixel}]: kpts max abs err "
          f"{kerr:.3e} ({'bit-identical' if torch.equal(kk, kp) else 'not bit-identical'}), "
          f"desc max abs err {derr:.3e} over {int(v.sum())} valid of "
          f"{v.numel()} rows")
    check(kerr <= 1e-6, f"kpdesc [{label}]: kpts differ by more than 1e-6")
    check(derr <= 1e-5, f"kpdesc [{label}]: desc differ by more than 1e-5")
    check(bool((dk[~v] == 0).all()), f"kpdesc [{label}]: invalid rows not zero")
    return {"max_abs_err": max(kerr, derr)}


def lattice_inputs(rng, B, H8, W8):
    """Peaks on a lattice of pitch 3 px (each the 5x5 maximum), so cells
    hold 4-9 survivors: arg-max rounds past 4 and the rank fill both run.
    Every other cell's peaks have equal logits (exact score ties, ordered
    by aux), the rest jittered ones."""
    logits = np.full((B, H8, W8, 65), -8.0, np.float32)
    y, x = np.mgrid[0:H8 * 8:3, 0:W8 * 8:3]
    cy, cx, ch = y // 8, x // 8, (y % 8) * 8 + x % 8
    peak = np.where((cy + cx) % 2 == 0, 4.0,
                    4.0 + rng.uniform(0, 1, (B,) + y.shape)).astype(np.float32)
    for b in range(B):
        logits[b, cy, cx, ch] = peak[b]
    heat = rng.uniform(0.2, 1.0, (B, H8, W8, 1)).astype(np.float32)
    return logits, heat


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


def max_err(k, p, where):
    """Largest |k - p| over ``where`` (0 if it is empty)."""
    return float((k - p).abs()[where].max()) if bool(where.any()) else 0.0


def grid_note(ck, P, N):
    ctas, rows = ck.matcher_grid(P, N)
    return f"{ctas} CTAs of {rows} rows"


def compare_mnn(ck, args, label, exact=False):
    """mutual_nn_pairs kernel vs plain: best column equal on >= 99.9% of
    valid rows, best distance within 1e-3 where they agree, column best
    equal on >= 99.9% of valid columns; with ``exact``, idx equal on every
    row and col_best on every column."""
    mk = ck.mutual_nn_pairs(*args)
    mp = ck.mutual_nn_pairs_plain(*args)
    va, vb = args[2], args[3]
    rows = torch.ones_like(va) if exact else va
    cols = torch.ones_like(vb) if exact else vb

    def agreement(k, p, where):
        return float((k == p)[where].float().mean()) if where.any() else 1.0

    idx_agree = agreement(mk[2], mp[2], rows)
    col_agree = agreement(mk[3], mp[3], cols)
    same = rows & (mk[2] == mp[2]) & torch.isfinite(mp[0])
    err = max(max_err(mk[0], mp[0], same),
              max_err(mk[1], mp[1], same & torch.isfinite(mp[1])))
    inf_same = bool(all((torch.isinf(k) == torch.isinf(q)).all()
                        for k, q in zip(mk[:2], mp[:2])))
    need = 1.0 if exact else 0.999
    print(f"mnn [{label}; {grid_note(ck, va.shape[0], va.shape[1])}]: idx "
          f"agreement {idx_agree:.6f} on {'all' if exact else 'valid'} rows, "
          f"column best agreement {col_agree:.6f}, distance max abs err "
          f"{err:.3e}")
    check(idx_agree >= need, f"mnn [{label}]: best columns disagree")
    check(col_agree >= need, f"mnn [{label}]: column best rows disagree")
    check(err <= 1e-3, f"mnn [{label}]: distances differ by more than 1e-3")
    check(inf_same, f"mnn [{label}]: rows without a valid column differ")
    return {"max_abs_err": err}


def odd_shape_checks(ck, detect, dev):
    """The kernels against their plain versions off the main path's shapes:
    dense random survivors, a ragged last detect strip, nc=5, batch 1, a
    width that is not a multiple of the column split, a lattice of
    survivors (4-9 per cell), keypoints out of bounds, K and N != M not
    multiples of any tile, a pair with no valid column."""
    rng = np.random.default_rng(1)

    def t(a):
        return torch.tensor(a, device=dev)

    # ragged last strips and column parts in each tile size (2x8 cells up
    # to batch 6 here, 16x16 at 16x60x83)
    for B, H8, W8 in ((2, 13, 120), (1, 13, 83), (1, 60, 80), (16, 60, 83)):
        logits = t((rng.standard_normal((B, H8, W8, 65)) * 3).astype(np.float32))
        heat = t(rng.uniform(size=(B, H8, W8, 1)).astype(np.float32))
        for nc in ((5, 9) if B == 2 else (9,)):
            compare_detect(ck, logits, heat, nc, f"random {B}x{H8}x{W8}, nc={nc}")
        feats = t(rng.standard_normal((B, H8 * W8, 64)).astype(np.float32))
        vals, aux = ck.detect_candidates(logits, heat)
        for subpixel in (False, True):
            compare_kpdesc(ck, feats, vals, aux, 1000, subpixel,
                           f"random {B}x{H8}x{W8}, K=1000")
    for B, H8, W8 in ((32, 60, 80), (1, 13, 83)):
        logits, heat = (t(a) for a in lattice_inputs(rng, B, H8, W8))
        compare_detect(ck, logits, heat, 9, f"lattice {B}x{H8}x{W8}")

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


TIE_CASES = ("duplicate columns", "duplicate rows", "zero rows",
             "prefix masks", "all valid")


def tie_banks(rng, case, P, N, M):
    """Descriptor banks of small multiples of 1/8: every similarity is exact
    in float32 whatever the order of the sum, so equal similarities are
    equal in every implementation, and ties are common. ``case`` plants
    more: b's second half repeating its first (row ties across columns),
    a's second half repeating its first (column-best ties across rows, in
    other CTAs), a valid all-zero row in a and in b (all its similarities
    0), masks that are prefixes (as select_keypoints leaves them), or all
    valid."""
    a = (rng.integers(-2, 3, (P, N, 64)) / 8).astype(np.float32)
    b = (rng.integers(-2, 3, (P, M, 64)) / 8).astype(np.float32)
    va = rng.uniform(size=(P, N)) > 0.2
    vb = rng.uniform(size=(P, M)) > 0.2
    if case == "duplicate columns":
        h = M // 2
        b[:, h:2 * h] = b[:, :h]
    elif case == "duplicate rows":
        h = N // 2
        a[:, h:2 * h] = a[:, :h]
    elif case == "zero rows":
        a[:, N // 3] = 0
        va[:, N // 3] = True
        b[:, M // 3] = 0
        vb[:, M // 3] = True
    elif case == "prefix masks":
        va = np.arange(N) < rng.integers(0, N + 1, (P, 1))
        vb = np.arange(M) < rng.integers(0, M + 1, (P, 1))
    elif case == "all valid":
        va[:], vb[:] = True, True
    return a, b, va, vb


def matcher_checks(ck, dev, main_args):
    """The two matcher kernels against their plain versions on exact ties
    (the first index must win on every row and column) at the main path's
    P=31 and at P=1, at M=4096, and at N=1 and M=1; then one call of each
    wrapper under set_sync_debug_mode("error")."""
    rng = np.random.default_rng(3)

    def t(*xs):
        return tuple(torch.tensor(x, device=dev) for x in xs)

    for case in TIE_CASES:
        for P in (31, 1):
            compare_mnn(ck, t(*tie_banks(rng, case, P, K, K)),
                        f"ties: {case}, P={P}, N=M={K}", exact=True)
        a, b, _, vb = tie_banks(rng, case, 1, K, K)
        compare_top2(ck, *t(a[0], b[0], vb[0]),
                     f"ties: {case}, N=M={K}", exact=True)
    for P, N, M in ((2, K, 4096), (3, 1, 1), (2, 1, K), (2, K, 1)):
        for case in ("duplicate columns", "all valid"):
            args = t(*tie_banks(rng, case, P, N, M))
            compare_mnn(ck, args, f"ties: {case}, P={P}, N={N}, M={M}",
                        exact=True)
            compare_top2(ck, args[0][0], args[1][0], args[3][0],
                         f"ties: {case}, N={N}, M={M}", exact=True)

    a0, b0, vb0 = main_args[0][0], main_args[1][0], main_args[3][0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ck.mutual_nn_pairs(*main_args)
        ck.similarity_top2(a0, b0, vb0)
    except RuntimeError as e:
        raise SmokeFailure(f"a matcher wrapper synchronized: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("matcher wrappers under set_sync_debug_mode('error'): no "
          "synchronizing call")


def extract_sync_check(ck, logits, heat, feats_flat, vals, aux):
    """One call of each extraction wrapper (and the top-k between them)
    under set_sync_debug_mode("error")."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ck.detect_candidates(logits, heat)
        scores, sel = torch.topk(vals.reshape(vals.shape[0], -1), K, dim=1)
        ck.keypoint_desc(feats_flat, scores, sel, aux, aux.shape[3], True)
    except RuntimeError as e:
        raise SmokeFailure(f"an extraction wrapper synchronized: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("detect_candidates, torch.topk and keypoint_desc under "
          "set_sync_debug_mode('error'): no synchronizing call")


def path_counts(ck, label, expect):
    """Read the launch counts of the path just driven and check that each
    kernel of ``expect`` launched (``expect`` maps a name to an exact count
    or None for "at least once") and no other did."""
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    print(f"kernels [{label}]: " + json.dumps(counts))
    for name, n in counts.items():
        if name not in expect:
            check(n == 0, f"{label}: kernel {name} launched off its path")
        elif expect[name] is None:
            check(n > 0, f"{label}: kernel {name} was not launched")
        else:
            check(n == expect[name], f"{label}: kernel {name} launched {n} "
                  f"times, expected {expect[name]}")
    return counts


def compare_top2(ck, a, b, vb, label, exact=False):
    """similarity_top2 kernel vs plain: best column equal on >= 99.9% of
    rows (every row with ``exact``); s1 and s2 within 1e-6 where the best
    columns agree; rows without a valid column exactly -inf with column
    0."""
    sk = ck.similarity_top2(a, b, vb)
    sp = ck.similarity_top2_plain(a, b, vb)
    agree = sk[2] == sp[2]
    idx_agree = float(agree.float().mean())
    err = 0.0
    for k, p in zip(sk[:2], sp[:2]):
        fin = agree & torch.isfinite(p)
        if bool(fin.any()):
            err = max(err, float((k - p).abs()[fin].max()))
        check(bool((k[~torch.isfinite(p)] == p[~torch.isfinite(p)]).all()),
              f"top2 [{label}]: -inf rows differ")
    none = torch.isneginf(sp[0])
    check(bool((sk[2][none] == 0).all()), f"top2 [{label}]: empty rows' index")
    print(f"top2 [{label}; {grid_note(ck, 1, a.shape[0])}]: idx agreement "
          f"{idx_agree:.6f}, similarity max abs err {err:.3e}, "
          f"{int(none.sum())} rows without a valid column")
    check(idx_agree >= (1.0 if exact else 0.999),
          f"top2 [{label}]: best columns disagree")
    check(err <= 1e-6, f"top2 [{label}]: similarities differ by more than 1e-6")
    return {"max_abs_err": err}


def single_pair_phase(ck, matching, batched, desc, valid, res_batched, dev):
    """The single-pair matcher path (kernel 4): counted, against the batched
    matcher and the unfused route, and the kernel against its plain version
    on the main path's frames 0 and 1 and at odd shapes."""
    B = desc.shape[0]
    ck.reset_launch_counts()
    res_pp = batched.match_consecutive(desc, valid, fused=False)
    launches = path_counts(ck, "match_consecutive(fused=False)",
                           {"similarity_top2": 2 * (B - 1)})
    idx_agree = float((res_pp.idx == res_batched.idx).float().mean())
    mask_agree = float((res_pp.mask == res_batched.mask).float().mean())
    print(f"per-pair vs pair-batched matcher: idx agreement {idx_agree:.6f}, "
          f"mask agreement {mask_agree:.6f}, matches per pair mean "
          f"{float(res_pp.mask.sum(1).float().mean()):.1f}")
    check(idx_agree >= 0.999 and mask_agree >= 0.999,
          "match_consecutive(fused=False) disagrees with the batched matcher")

    kw = dict(max_dist=matching.TH_LOW * 6, ratio=0.95)
    rf = matching.match_mutual_nn(desc[0], desc[1], valid[0], valid[1],
                                  fused=True, **kw)
    ru = matching.match_mutual_nn(desc[0], desc[1], valid[0], valid[1],
                                  fused=False, **kw)
    idx_agree = float((rf.idx == ru.idx).float().mean())
    mask_agree = float((rf.mask == ru.mask).float().mean())
    print(f"match_mutual_nn fused vs unfused (frames 0,1): idx agreement "
          f"{idx_agree:.6f}, mask agreement {mask_agree:.6f}, "
          f"{int(rf.mask.sum())} matches")
    check(idx_agree >= 0.999 and mask_agree >= 0.999,
          "match_mutual_nn's routes disagree")
    check(bool(torch.isinf(rf.dist[~valid[0]]).all()),
          "fused route: invalid rows' distance is not inf")

    report = compare_top2(ck, desc[0], desc[1], valid[1], "frames 0,1")
    rng = np.random.default_rng(2)
    N, M = 333, 257
    a = rng.standard_normal((N, 64)).astype(np.float32)
    b = rng.standard_normal((M, 64)).astype(np.float32)
    b[:100] = a[:100] + 0.05 * rng.standard_normal((100, 64))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    vb = rng.uniform(size=M) > 0.1
    a_t, b_t = torch.tensor(a, device=dev), torch.tensor(b, device=dev)
    compare_top2(ck, a_t, b_t, torch.tensor(vb, device=dev),
                 f"random {N}x{M}, masked columns")
    compare_top2(ck, a_t, b_t, torch.zeros(M, dtype=torch.bool, device=dev),
                 f"random {N}x{M}, no valid column")
    return launches, report


def build_map(o, depth, R, t, cam):
    """Frame 0's valid keypoints with depth, back-projected with the true
    pose (numpy): even ones fill stage 1's M1 slots, odd ones a local map
    padded to M2 rows under ids stage 1 does not hold. Keypoints on a depth
    silhouette (3x3 max - min above DEPTH_EDGE_REL of the depth, the frame
    step's own gate) get no map point."""
    kp, desc, val = (o[k][0].cpu().numpy() for k in ("kpts", "desc", "valid"))
    xi = np.clip(np.round(kp[:, 0]).astype(int), 0, W - 1)
    yi = np.clip(np.round(kp[:, 1]).astype(int), 0, H - 1)
    z = depth[yi, xi]
    nbrs = np.stack([depth[np.clip(yi + dy, 0, H - 1), np.clip(xi + dx, 0, W - 1)]
                     for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    z = np.where((nbrs.max(0) - nbrs.min(0) > DEPTH_EDGE_REL * z)
                 | (nbrs.min(0) <= 0), 0.0, z)
    Xc = np.stack([(kp[:, 0] - cam.cx) / cam.fx * z,
                   (kp[:, 1] - cam.cy) / cam.fy * z, z], -1)
    Xw = ((Xc - t) @ R).astype(np.float32)
    sel = np.nonzero(val & (z > 0))[0]
    s1, s2 = sel[0::2], sel[1::2]

    def pad(x, n, fill=0):
        out = np.full((n,) + x.shape[1:], fill, x.dtype)
        out[: len(x)] = x
        return out

    arrays = (pad(Xw[s1], M1), pad(desc[s1], M1),
              pad(np.ones(len(s1), bool), M1, False),
              np.zeros(M1, np.float32), np.zeros(M1, np.int32),
              pad(np.arange(len(s1), dtype=np.int32), M1, -1),
              pad(Xw[s2], M2), pad(desc[s2], M2),
              pad(np.ones(len(s2), bool), M2, False),
              np.zeros(M2, np.float32), np.zeros(M2, np.int32),
              pad(np.arange(len(s2), dtype=np.int32) + M1, M2, -1),
              np.full(M2, 10.0, np.float32))
    return arrays, len(s1), len(s2)


def center_err(R, t, pose):
    """Distance between the estimated and the true camera centre, m."""
    R, t = R.cpu().numpy(), t.cpu().numpy()
    Rg, tg = pose
    return float(np.linalg.norm(-R.T @ t + Rg.T @ tg))


def frame_step_phase(model, ck, dev):
    """The online RGB-D frame step on frames 1-5 of a synthetic sequence,
    counted per frame, against the truth and the plain-kernel path; the
    monocular configuration; no host sync inside a step; timings."""
    from xfeatslam_tpu_torch.models.extractor import extract_fn
    from xfeatslam_tpu_torch.ops import camera
    from xfeatslam_tpu_torch.ops import image as image_ops
    from xfeatslam_tpu_torch.optim import pose_opt, track_step
    from xfeatslam_tpu_torch.utils import synthetic

    t0 = time.perf_counter()
    seq = synthetic.make_sequence(N_FRAMES, (H, W))
    Km = seq["K"]
    cam = camera.Pinhole.from_list([Km[0, 0], Km[1, 1], Km[0, 2], Km[1, 2]])
    imgs = [image_ops.to_float_image(g, dev) for g in seq["images"]]
    depths = [torch.from_numpy(d).to(dev) for d in seq["depths"]]
    no_depth = torch.zeros((1, 1), device=dev)
    o0 = extract_fn(model, imgs[0], K)
    arrays, n1, n2 = build_map(o0, seq["depths"][0], *seq["poses"][0], cam)
    maps = tuple(torch.from_numpy(x).to(dev) for x in arrays)
    print(f"frame step: {N_FRAMES} frames rendered at {W}x{H} and a map "
          f"built in {time.perf_counter() - t0:.2f} s; stage 1 holds {n1} of "
          f"{M1} slots, the local map {n2} of {M2} rows")

    def step(i, R0, t0, has_depth=True):
        return track_step.xfeat_rgbd_frame_step(
            model, imgs[i], depths[i] if has_depth else no_depth, R0, t0,
            *maps, cam, BF, DEPTH_EDGE_REL, INV_SIGMA2, RADIUS_MOTION,
            RADIUS_LOCAL, TH_HIGH, RATIO, WIDEN_BELOW, SCALE_FACTOR,
            2.0 * cam.cx, 2.0 * cam.cy, num_keypoints=K, n_levels=1,
            has_depth=has_depth)

    Rg0, tg0 = (torch.from_numpy(x).to(dev) for x in seq["poses"][0])
    # ---- frames 1-5, each from the previous estimate, counted ----
    inputs, results, walls = [], [], []
    R, t = Rg0, tg0
    for i in range(1, N_FRAMES):
        ck.reset_launch_counts()
        tw = time.perf_counter()
        out, r1, r2 = step(i, R, t)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - tw)
        path_counts(ck, f"frame step, frame {i}",
                    {name: 1 for name in FRAME_STEP_KERNELS})
        inputs.append((R, t))
        results.append((out, r1, r2))
        R, t = r2.R, r2.t
    errs = []
    for i, (out, r1, r2) in zip(range(1, N_FRAMES), results):
        errs.append(center_err(r2.R, r2.t, seq["poses"][i]))
        print(f"frame {i}: {int(out['valid'].sum())} keypoints, "
              f"{int((out['depth'] > 0).sum())} with depth; stage 1 "
              f"{int(r1.n_matched)} matched / {int(r1.n_inliers)} inliers, "
              f"stage 2 {int(r2.n_matched)} / {int(r2.n_inliers)}; "
              f"translation error {errs[-1] * 1e3:.3f} mm")
        check(int(r1.n_matched) > 0 and int(r2.n_matched) > 0,
              f"frame {i}: a stage bound no match")
        check(errs[-1] < 0.01, f"frame {i}: translation error >= 1 cm")

    # ---- no host sync inside a step ----
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(1, *inputs[0])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # torch's warning for each synchronizing call (its notice that the mode
    # is a prototype is not one)
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    print(f"frame step: {len(syncs)} synchronizing calls inside a step"
          + (f": {syncs[:3]}" if syncs else ""))
    check(not syncs, "the frame step synchronizes with the host")

    # ---- the same frames by CUDA-graph replay, bit for bit ----
    graph = track_step.RgbdFrameStepGraph(model)

    def replay(i, R0, t0):
        return graph(imgs[i], depths[i], R0, t0, *maps, cam, BF,
                     DEPTH_EDGE_REL, INV_SIGMA2, RADIUS_MOTION, RADIUS_LOCAL,
                     TH_HIGH, RATIO, WIDEN_BELOW, SCALE_FACTOR, 2.0 * cam.cx,
                     2.0 * cam.cy, num_keypoints=K, n_levels=1,
                     has_depth=True)

    for i, ((R0, t0), res) in enumerate(zip(inputs, results), 1):
        ck.reset_launch_counts()
        got = track_step.fetch(replay(i, R0, t0))
        counts = path_counts(ck, f"frame step by graph replay, frame {i}", {
            name: None if i == 1 else 1 for name in FRAME_STEP_KERNELS})
        want = track_step.fetch(res)
        differ = [f"{part}.{k}" for part, a, b in zip(("frame", "r1", "r2"),
                                                      want, got)
                  for k, x in (a.items() if isinstance(a, dict)
                               else a._asdict().items())
                  if not np.array_equal(x, (b if isinstance(b, dict)
                                            else b._asdict())[k])]
        print(f"frame {i} by graph replay: bit-identical to the eager step: "
              f"{not differ}" + (f" (differ: {differ})" if differ else "")
              + (f"; launches in the call that captured {counts}"
                 if i == 1 else ""))
        check(not differ, f"frame {i}: graph replay differs from the eager "
              "step")
    captured = graph.captured_launches()
    print(f"frame step graph: kernel launches recorded at capture "
          f"{captured}")
    check(captured == [{name: 1 for name in FRAME_STEP_KERNELS}],
          "the captured frame step does not launch each kernel once")

    # ---- the same frames through the plain kernels ----
    t_dev, slot_agree = 0.0, 1.0
    with plain_kernels(ck):
        for i, ((R0, t0), (_, k1, k2)) in enumerate(zip(inputs, results), 1):
            _, p1, p2 = step(i, R0, t0)
            t_dev = max(t_dev, float((p2.t - k2.t).abs().max()),
                        float((p2.R - k2.R).abs().max()))
            for k, p in ((k1, p1), (k2, p2)):
                slot_agree = min(slot_agree, float(
                    (k.slot_mp == p.slot_mp).float().mean()))
    print(f"frame step vs plain-kernel path: pose max abs difference "
          f"{t_dev:.3e}, slot agreement min {slot_agree:.6f}")
    check(t_dev <= 1e-4, "frame-step poses differ from the plain path")
    check(slot_agree >= 0.99, "frame-step slots differ from the plain path")

    # ---- monocular configuration ----
    _, m1, m2 = step(1, Rg0, tg0, has_depth=False)
    mono_ok = bool(torch.isfinite(m2.R).all() & torch.isfinite(m2.t).all())
    print(f"monocular frame 1: stage 1 {int(m1.n_inliers)} inliers, stage 2 "
          f"{int(m2.n_inliers)} inliers, translation error "
          f"{center_err(m2.R, m2.t, seq['poses'][1]) * 1e3:.3f} mm")
    check(mono_ok and int(m2.n_inliers) >= 20, "monocular frame step failed")

    # ---- timings: the step, its parts, host wall, kernel count ----
    R1, t1 = inputs[0]
    out1, r1_1, _ = results[0]
    times = {"frame_step": cuda_ms(lambda: step(1, R1, t1), iters=5,
                                   warmup=1),
             "frame_step_graph": cuda_ms(lambda: replay(1, R1, t1), iters=20,
                                         warmup=2),
             "extract_b1": cuda_ms(lambda: extract_fn(model, imgs[1], K))}
    walls = []
    for _ in range(10):
        tw = time.perf_counter()
        track_step.fetch(replay(1, R1, t1))
        walls.append(time.perf_counter() - tw)
    times["graph_host_wall_with_fetch"] = float(np.median(walls)) * 1e3
    zeros_k = torch.zeros(K, device=dev)
    isig = zeros_k + INV_SIGMA2
    times["two_stages"] = cuda_ms(lambda: track_step.two_stage_track_step(
        R1, t1, *maps, out1["kpts_un"], out1["desc"], out1["valid"], zeros_k,
        zeros_k.to(torch.int32), out1["ur"], isig, cam, BF, RADIUS_MOTION,
        RADIUS_LOCAL, TH_HIGH, RATIO, WIDEN_BELOW, SCALE_FACTOR, 2.0 * cam.cx,
        2.0 * cam.cy), iters=5, warmup=1)
    slot = r1_1.slot_mp
    edges = (slot >= 0) & out1["valid"]
    Xw = maps[0][slot.long().clamp(min=0)]
    times["pose_optimization"] = cuda_ms(lambda: pose_opt.pose_optimization(
        R1, t1, Xw, out1["kpts_un"], out1["ur"], isig,
        (out1["ur"] > 0) & edges, edges, cam, BF), iters=5, warmup=1)
    times["host_wall_per_frame"] = float(np.mean(walls[1:])) * 1e3

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        step(1, R1, t1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tw
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    launch_calls = sum(1 for e in prof.events()
                       if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                     "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    print(f"frame step under torch.profiler: {len(dev_events)} device events, "
          f"{launch_calls} kernel-launch API calls, device busy "
          f"{busy_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms wall "
          f"({busy_us / 1e6 / wall:.3f}); busy share of the unprofiled step "
          f"{busy_us / 1e3 / times['frame_step']:.3f}")
    ops = sorted(((e.key, e.count) for e in prof.key_averages()
                  if e.key.startswith("aten::")), key=lambda kv: -kv[1])
    print("frame step: ATen ops with the most calls: "
          + json.dumps(dict(ops[:12])))
    print(f"frame step ms at {W}x{H}, K={K}, M1={M1}, M2={M2}, batch 1: "
          + json.dumps({k: round(v, 4) for k, v in times.items()}))


def slam_phase(ck, n_frames):
    """``System.track_rgbd`` (no loop closing) on ``n_frames`` rendered
    frames at 640x480, K=1000, the shipped weights, counted: every frame
    OK, the camera centre within 3 cm of the truth everywhere and 1 cm at
    the median, at least SLAM_MIN_CAPTURED frames through the captured
    step; host wall time per frame, the track and backend spans, local BA
    per round, the map's size."""
    from xfeatslam_tpu_torch.ops.camera import Pinhole
    from xfeatslam_tpu_torch.slam.settings import Settings
    from xfeatslam_tpu_torch.slam.system import Sensor, System
    from xfeatslam_tpu_torch.utils import synthetic

    t0 = time.perf_counter()
    seq = synthetic.make_sequence(n_frames=n_frames)
    Km = seq["K"]
    settings = Settings(
        cam=Pinhole.from_list([Km[0, 0], Km[1, 1], Km[0, 2], Km[1, 2]]),
        bf=40.0, th_depth=3.0, depth_map_factor=1.0, n_features=K)
    system = System(settings, Sensor.RGBD, enable_loop_closing=False)
    print(f"slam: {n_frames} frames rendered at {W}x{H} and the System built "
          f"in {time.perf_counter() - t0:.2f} s")
    ck.reset_launch_counts()
    states, errs, walls = [], [], []
    for i in range(n_frames):
        tw = time.perf_counter()
        state, pose = system.track_rgbd(seq["images"][i], seq["depths"][i],
                                        seq["timestamps"][i])
        walls.append(time.perf_counter() - tw)
        states.append(state.name)
        if pose is not None:
            Rg, tg = seq["poses"][i]
            errs.append(float(np.linalg.norm(-pose[0].T @ pose[1]
                                             + Rg.T @ tg)))
    counts = path_counts(ck, f"System.track_rgbd, {n_frames} frames",
                         {name: None for name in FRAME_STEP_KERNELS})
    stats = system.shutdown()
    errs = np.array(errs)
    print(f"slam: states {states.count('OK')} of {n_frames} OK, camera "
          f"centre error max {errs.max() * 1e3:.3f} mm, median "
          f"{np.median(errs) * 1e3:.3f} mm; {stats['keyframes']} keyframes, "
          f"{stats['map_points']} map points; "
          f"{stats.get('fused_grab', 0)} frames through the captured step; "
          f"launches {counts}")
    check(states == ["OK"] * n_frames, f"slam: a frame was not OK: {states}")
    check(errs.max() < 0.03, "slam: camera centre error >= 3 cm")
    check(np.median(errs) < 0.01, "slam: median camera centre error >= 1 cm")
    check(stats.get("fused_grab", 0) >= SLAM_MIN_CAPTURED,
          "slam: too few frames through the captured step")

    def pct(xs, q):
        return round(float(np.percentile(np.asarray(xs) * 1e3, q)), 4)

    # steady state: frames 2.. (frame 0 initializes the map, frame 1
    # captures the graph)
    spans = system.timer.samples
    ba = system.local_mapping.ba_seconds
    report = {
        "wall_per_frame_ms": {"median": pct(walls[2:], 50),
                              "p90": pct(walls[2:], 90)},
        "track_ms": {"median": pct(spans["track"][2:], 50),
                     "p90": pct(spans["track"][2:], 90)},
        "backend_ms": {"median": pct(spans["backend"][2:], 50),
                       "p90": pct(spans["backend"][2:], 90)},
        # inside track: the host's inputs of the step, then the replay and
        # its one read (the first replay's call captured the graph)
        "track_snapshot_ms": {"median": pct(spans["track.snapshot"][1:], 50),
                              "p90": pct(spans["track.snapshot"][1:], 90)},
        "track_frame_step_ms": {
            "median": pct(spans["track.frame_step"][1:], 50),
            "p90": pct(spans["track.frame_step"][1:], 90)},
        "frame_0_ms": round(walls[0] * 1e3, 4),
        "frame_1_capture_ms": round(walls[1] * 1e3, 4),
        "local_ba_first_stage_ms": [round(s * 1e3, 4) for k, s in ba
                                    if k == "first"],
        "local_ba_tick_ms": [round(s * 1e3, 4) for k, s in ba
                             if k == "tick"],
        "keyframes": stats["keyframes"], "map_points": stats["map_points"],
    }
    print(f"slam timings (host wall, {n_frames} frames at {W}x{H}, K={K}): "
          + json.dumps(report))


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
    from xfeatslam_tpu_torch.ops import detect, matching
    from xfeatslam_tpu_torch.parallel import batched

    # ---- build ----
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(_build.KERNELS)} "
          f"kernel sources (parallel nvcc, sm_90a)")

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
    launches = path_counts(ck, "extract_batch + match_consecutive",
                           BATCHED_KERNELS)
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
    print(f"detect grids: batch {batch} "
          f"{detect_note(ck, batch, H // 8, W // 8)}; batch 1 "
          f"{detect_note(ck, 1, H // 8, W // 8)}")
    print(f"matcher grids: mutual_nn_pairs on the main path (P={batch - 1}, "
          f"N=M={K}) {grid_note(ck, batch - 1, K)}; similarity_top2 at "
          f"N=M={K} {grid_note(ck, 1, K)}")

    # ---- kernels against their plain versions, on the main path's tensors ----
    with torch.no_grad():
        feats, logits, heat = model(images)
    logits, heat = logits.contiguous(), heat.contiguous()
    B, H8, W8, _ = feats.shape
    feats_flat = feats.reshape(B, H8 * W8, 64).contiguous()

    report = {
        "detect_candidates": compare_detect(ck, logits, heat, 9, "main path"),
    }
    l1, h1 = logits[:1].contiguous(), heat[:1].contiguous()
    compare_detect(ck, l1, h1, 9, "main path's frame 0, batch 1")
    vk, ak = ck.detect_candidates(logits, heat)
    report["keypoint_desc"] = {"max_abs_err": max(
        compare_kpdesc(ck, feats_flat, vk, ak, K, sp, "main path")["max_abs_err"]
        for sp in (False, True))}
    idx4, w4 = detect.desc_taps(out["kpts"], out["valid"], H8, W8)
    report["bilinear_desc_sample"] = compare_desc(ck, feats_flat, idx4, w4,
                                                  "main path")
    # the descriptors-at-keypoints path (bilinear_desc_sample), counted
    ck.reset_launch_counts()
    d_s = detect.sample_descriptors(feats, out["kpts"], out["valid"])
    launches["bilinear_desc_sample"] = path_counts(
        ck, "sample_descriptors", {"bilinear_desc_sample": 1})[
            "bilinear_desc_sample"]
    err = float((d_s - out["desc"]).abs().max())
    print(f"sample_descriptors at the main path's keypoints vs its "
          f"descriptors: max abs err {err:.3e}")
    check(err <= 1e-5, "sample_descriptors disagrees with select_keypoints")
    extract_sync_check(ck, l1, h1, feats_flat[:1], vk[:1], ak[:1])
    desc, valid = out["desc"], out["valid"]
    args = (desc[:-1], desc[1:], valid[:-1], valid[1:])
    report["mutual_nn_pairs"] = compare_mnn(ck, args, "main path")
    odd_shape_checks(ck, detect, dev)
    matcher_checks(ck, dev, args)

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

    # ---- the single-pair matcher path (kernel 4) ----
    launches4, report["similarity_top2"] = single_pair_phase(
        ck, matching, batched, desc, valid, res, dev)
    launches["similarity_top2"] = launches4["similarity_top2"]
    print("kernels: " + json.dumps(launches))

    # ---- the online RGB-D frame step ----
    frame_step_phase(model, ck, dev)

    # ---- the RGB-D SLAM host ----
    slam_phase(ck, SLAM_FRAMES)

    # ---- timings ----
    P = batch - 1
    times = {}
    times["forward"] = cuda_ms(lambda: model(images))
    times["detect"] = cuda_ms(lambda: ck.detect_candidates(logits, heat))
    times["detect_b1"] = cuda_ms(lambda: ck.detect_candidates(l1, h1))
    times["detect_plain"] = cuda_ms(lambda: ck.detect_candidates_plain(logits, heat))
    times["topk"] = cuda_ms(lambda: torch.topk(vk.reshape(B, -1), K, dim=1))
    scores_k, sel_k = torch.topk(vk.reshape(B, -1), K, dim=1)
    kd_args = (feats_flat, scores_k, sel_k, ak, W8, False)
    times["kpdesc"] = cuda_ms(lambda: ck.keypoint_desc(*kd_args))
    times["kpdesc_plain"] = cuda_ms(lambda: ck.keypoint_desc_plain(*kd_args))
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
    a0, b0, vb0 = desc[0], desc[1], valid[1]
    times["top2"] = cuda_ms(lambda: ck.similarity_top2(a0, b0, vb0))
    times["top2_plain"] = cuda_ms(lambda: ck.similarity_top2_plain(a0, b0, vb0))
    times["top2_library"] = cuda_ms(lambda: torch.mm(a0, b0.T))
    times["extract"] = cuda_ms(lambda: batched.extract_batch(model, images, K),
                               iters=10)
    times["match"] = cuda_ms(
        lambda: batched.match_consecutive(out["desc"], out["valid"]))
    times["match_per_pair"] = cuda_ms(
        lambda: batched.match_consecutive(out["desc"], out["valid"],
                                          fused=False), iters=5, warmup=1)
    times["end_to_end"] = cuda_ms(main_path, iters=10)
    print("stage ms at batch %d: %s" % (batch, json.dumps(
        {k: round(v, 4) for k, v in times.items()})))
    # the kernels' calls are short enough for host cost to show in the
    # times above; these are device times alone
    device = {
        "detect": graph_ms(lambda: ck.detect_candidates(logits, heat)),
        "detect_b1": graph_ms(lambda: ck.detect_candidates(l1, h1)),
        "topk": graph_ms(lambda: torch.topk(vk.reshape(B, -1), K, dim=1)),
        "kpdesc": graph_ms(lambda: ck.keypoint_desc(*kd_args)),
        "desc": graph_ms(lambda: ck.bilinear_desc_sample(feats_flat, idx4, w4)),
        "mnn": graph_ms(lambda: ck.mutual_nn_pairs(*args)),
        "mnn_library": graph_ms(lambda: torch.bmm(desc[:-1],
                                                  desc[1:].transpose(1, 2))),
        "top2": graph_ms(lambda: ck.similarity_top2(a0, b0, vb0)),
        "top2_library": graph_ms(lambda: torch.mm(a0, b0.T)),
    }
    print("kernel device ms per call (CUDA-graph replay): " + json.dumps(
        {k: round(v, 5) for k, v in device.items()}))
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
        # the touched grid rows, sel (int64), the gathered aux, the scores,
        # the kpts and desc writes; the same sampling work
        "keypoint_desc": bound_ms(
            touched * 64 * 4 + B * K * (8 + 4 + 4 + 2 * 4 + 64 * 4),
            int(nz.sum()) * 64 * 4 + B * K * 64 * 3),
        # one similarity matrix over the valid columns gives both passes
        "mutual_nn_pairs": bound_ms(
            2 * P * K * 64 * 4 + 2 * P * K + 4 * P * K * 4,
            float(2 * 64 * K * nvb.sum())),
        # one pair: both banks and the mask read, three rows written; the
        # similarities over the valid columns
        "similarity_top2": bound_ms(2 * K * 64 * 4 + K + 3 * K * 4,
                                    float(2 * 64 * K * vb0.sum())),
    }
    timed = {"detect_candidates": ("detect", "detect_plain", None),
             "bilinear_desc_sample": ("desc", "desc_plain", "desc_library"),
             "keypoint_desc": ("kpdesc", "kpdesc_plain", None),
             "mutual_nn_pairs": ("mnn", "mnn_plain", "mnn_library"),
             "similarity_top2": ("top2", "top2_plain", "top2_library")}
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

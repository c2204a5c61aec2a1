#!/usr/bin/env python3
"""The extraction kernels timed on one NVIDIA GPU, for comparing checkouts.

Usage: python3 extraction_timing.py [--root DIR] [--save FILE.npz] [--tiles]
                                    [--variants]
       python3 extraction_timing.py --compare A.npz B.npz
(from the repository root, one CUDA card with nvcc)

Imports ``xfeatslam_tpu_torch`` from DIR (default: this checkout; an older
checkout unpacked elsewhere works too), builds its kernels, runs the
shipped-weights forward once on 256 of ``chip_smoke.make_images``'s frames
(640x480) and, on its logits, heat and feats at batch 1, 32 and 256, times
  detect  ``ops/cuda_kernels.detect_candidates``,
  select  ``ops/detect.select_keypoints`` (detect, the top-k and the
          descriptor stage; K=1000),
each back to back by CUDA events (``cuda_ms``) and on the device alone by
CUDA-graph replay (``graph_ms``). ``select - detect`` is the descriptor
stage with its top-k. With ``--save`` it writes the detect candidates at
batch 1 and 32 and select_keypoints' outputs at batch 32 (sub-pixel) to an
npz; ``--compare`` prints how two such files differ, array by array.
With ``--tiles`` (this checkout's detect kernel) it also times detect with
each tile of TILES forced, and with ``--variants`` detect built from
text variants of ``csrc/detect_candidates.cu`` (VARIANTS: register caps,
and removals whose results are wrong and only timed),
each by CUDA-graph replay at the default grid. Prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import chip_smoke  # noqa: E402  (make_images, cuda_ms, graph_ms, card_line)

K = 1000
BATCHES = (1, 32, 256)
# (cell rows, cell columns) per CTA
TILES = ((16, 16), (8, 32), (8, 16), (8, 8), (4, 16), (2, 16), (2, 8))
# (name, [(text in detect_candidates.cu, replacement), ...])
NO_PHASE1 = ("for (int cell = warp; cell < ncell;",
             "for (int cell = warp; cell < 0;")
NO_PHASE2 = ("for (int t0 = 0; t0 < ntask;", "for (int t0 = 0; t0 < 0;")
FAST_EXP = [("expf(x[u][0] - m), e1 = expf(x[u][1] - m)",
             "__expf(x[u][0] - m), e1 = __expf(x[u][1] - m)"),
            ("? expf(x[u][2] - m)", "? __expf(x[u][2] - m)")]
NO_DIVISION = [("prob[r0 * sw + col] = e0 / s;", "prob[r0 * sw + col] = e0 * s;"),
               ("prob[(r0 + 4) * sw + col] = e1 / s;",
                "prob[(r0 + 4) * sw + col] = e1 * s;")]
NO_AUX = ("if (active && (odd || ((hi >> i) & 1) || i * 8 + px < nc)) {",
          "if (false) {")
NO_EXTRACTION = [("for (int r = 0; r < warp_rounds; ++r) {",
                  "for (int r = 0; r < 0; ++r) {"),
                 ("if (active && !odd) {", "if (false) {")]
MIN_BLOCKS = "constexpr int kMinBlocks = 2;"
VARIANTS = (
    ("as is", []),
    ("1 CTA per SM (no register cap)",
     [(MIN_BLOCKS, "constexpr int kMinBlocks = 1;")]),
    ("3 CTAs per SM (<= 40 registers)",
     [(MIN_BLOCKS, "constexpr int kMinBlocks = 3;")]),
    ("2 cells in flight in phase 1", [("constexpr int kInFlight = 4;",
                                       "constexpr int kInFlight = 2;")]),
    ("the aux of every pixel",
     [("if (active && (odd || ((hi >> i) & 1) || i * 8 + px < nc)) {",
       "if (active) {")]),
    ("removal: no halo cells in phase 1",
     [("const int h0 = max(c0 - 1, 0), h1 = min(c1 + 1, H8);",
       "const int h0 = c0, h1 = c1;"),
      ("const int g0 = max(q0 - 1, 0), g1 = min(q1 + 1, W8);",
       "const int g0 = q0, g1 = q1;")]),
    ("removal: phase 1 only", [NO_PHASE2]),
    ("removal: phase 1 only, with the fast exp", [NO_PHASE2] + FAST_EXP),
    ("removal: phase 1 only, products for its divisions",
     [NO_PHASE2] + NO_DIVISION),
    ("removal: no phase 1", [NO_PHASE1]),
    ("removal: no phase 1, no aux", [NO_PHASE1, NO_AUX]),
    ("removal: no phase 1, no extraction", [NO_PHASE1] + NO_EXTRACTION),
    ("removal: no phase 1, no aux, no extraction",
     [NO_PHASE1, NO_AUX] + NO_EXTRACTION),
    ("removal: neither phase (the heat, the row table, the writes)",
     [NO_PHASE1, NO_PHASE2]),
)


def build_variants(src_path, out_dir, flags, nvcc):
    """Compile every variant at once; their detect_candidates entries."""
    with open(src_path) as f:
        src = f.read()
    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for i, (name, subs) in enumerate(VARIANTS):
        v = src
        for old, new in subs:
            if old not in v:
                raise SystemExit(f"extraction_timing: {old!r} is no longer in "
                                 "detect_candidates.cu; update VARIANTS")
            v = v.replace(old, new)
        cu, so = (os.path.join(out_dir, f"v{i}{ext}") for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(v)
        jobs.append((name, so, subprocess.Popen(
            [nvcc, *flags, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    entries = {}
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for variant {name!r}:\n{log}")
        entries[name] = ctypes.CDLL(so).detect_candidates
    return entries


def compare(a_path, b_path):
    a, b = np.load(a_path), np.load(b_path)
    for k in sorted(set(a.files) | set(b.files)):
        if k not in a.files or k not in b.files:
            print(f"{k}: only in one file")
            continue
        x, y = a[k], b[k]
        if x.shape != y.shape:
            print(f"{k}: shapes {x.shape} and {y.shape}")
            continue
        d = np.abs(x.astype(np.float64) - y.astype(np.float64))
        print(f"{k} {x.shape}: bit-identical {np.array_equal(x, y)}, "
              f"{int((x != y).sum())} elements differ, max abs diff "
              f"{d.max():.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--save")
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
        return 0
    if not torch.cuda.is_available():
        print("extraction_timing: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.abspath(args.root))
    from xfeatslam_tpu_torch import _build
    from xfeatslam_tpu_torch.models import weights
    from xfeatslam_tpu_torch.ops import cuda_kernels as ck
    from xfeatslam_tpu_torch.ops import detect

    print(f"package from {os.path.dirname(detect.__file__)}")
    _build.build()
    model = weights.load_npz(os.path.join(HERE, "weights", "xfeat_synthetic.npz"))
    images = torch.from_numpy(chip_smoke.make_images(max(BATCHES))).cuda()
    with torch.no_grad():
        feats, logits, heat = model(images)
    saved = {}
    variants = {}
    if args.variants:
        variants = build_variants(
            os.path.join(_build.SRC_DIR, "detect_candidates.cu"),
            os.path.join(_build.BUILD_DIR, "variants"),
            _build._flags("detect_candidates"), _build.find_nvcc())
        for e in variants.values():
            e.argtypes = ck._ENTRY_POINTS["detect_candidates"][1]
            e.restype = ctypes.c_int
    for B in BATCHES:
        f, lg, ht = (x[:B].contiguous() for x in (feats, logits, heat))

        def det():
            return ck.detect_candidates(lg, ht)

        def sel():
            return detect.select_keypoints(f, lg, ht, K)

        row = {name: (round(chip_smoke.cuda_ms(fn), 5),
                      round(chip_smoke.graph_ms(fn), 5))
               for name, fn in (("detect", det), ("select", sel))}
        print(f"batch {B} ms (cuda_ms, graph_ms): {row}")
        if B in (1, 32):
            v, a = det()
            saved[f"vals_b{B}"], saved[f"aux_b{B}"] = v.cpu().numpy(), a.cpu().numpy()
        if B == 32:
            o = detect.select_keypoints(f, lg, ht, K, subpixel=True)
            for k in ("kpts", "scores", "desc", "valid"):
                saved[f"select_{k}"] = o[k].cpu().numpy()
        ref = det()
        if args.tiles:
            default = ck._DETECT_TILES
            for tile in TILES:
                ck._DETECT_TILES = (tile,)
                ctas = ck.detect_grid(B, *lg.shape[1:3])[0]
                t = chip_smoke.graph_ms(det)
                same = all(torch.equal(x, y) for x, y in zip(det(), ref))
                print(f"  batch {B}, tile {tile[0]}x{tile[1]} cells, {ctas} "
                      f"CTAs: detect graph_ms {t:.5f}, candidates "
                      f"{'equal' if same else 'DIFFERENT'}")
            ck._DETECT_TILES = default
        shipped = ck._entry("detect_candidates")
        for name, e in variants.items():
            ck._entries["detect_candidates"] = e
            t = chip_smoke.graph_ms(det)
            same = all(torch.equal(x, y) for x, y in zip(det(), ref))
            print(f"  batch {B}, variant [{name}]: detect graph_ms {t:.5f}, "
                  f"candidates {'equal' if same else 'DIFFERENT'}")
        ck._entries["detect_candidates"] = shipped
    if args.save:
        np.savez(args.save, **saved)
        print(f"saved {sorted(saved)} to {args.save}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

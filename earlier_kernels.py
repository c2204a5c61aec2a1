#!/usr/bin/env python3
"""This tree's kernels against earlier sources of the same files, on one
NVIDIA GPU, in turns.

Usage: python3 earlier_kernels.py --earlier DIR   (from the repository
root, one CUDA card with nvcc; DIR, a directory that .gitignore lists,
holds earlier commits' sources, e.g. unpacked with ``git show
COMMIT:xfeatslam_tpu_torch/csrc/pose_lm.cu > DIR/pose_lm.cu``: any of
``pose_lm.cu`` and ``local_ba.cu``, whose C entry points take the same
arguments as this tree's, and ``orb_fast.cu`` and ``orb_describe.cu`` of
the earlier design (e.g. commit 5e60de8), whose entries take the level
images (and the blurred levels) instead of the frame)

First prints the card's name and power limit and what ``nvcc -Xptxas -v``
reports for this tree's four kernels (registers, shared memory, stack,
spills), then builds the earlier sources with the same nvcc flags into
``xfeatslam_tpu_torch/_build/earlier/`` and times both versions in turns
(earlier, current, current, earlier) on ``chip_smoke.py``'s inputs:

- with ``pose_lm.cu`` and ``local_ba.cu``, by CUDA-graph replay: the pose
  LM at N=1000 with ~220 valid edges (the frame step's fill) and at
  N=8192 half valid, and a local-BA solve of the full bucket (32 cameras,
  4096 points, 16384 observations) at the schedules (5, 0) and (10, 10),
  and of a problem with more entity blocks than the card has SMs (32
  cameras, 40,000 points) at (5, 0); whether the two versions' BA solves
  are bit-identical and how far their poses lie apart; and the device
  events ``torch.profiler`` records for one call of this tree's pose LM
  and one eager (5, 0) solve of the full bucket;
- with ``orb_fast.cu`` and ``orb_describe.cu``, on the extractor phase's
  rendered 640x480 frame and its keypoints (1000 features), by CUDA-graph
  replay: the candidates stage as the earlier design ran it (each level
  resized by ``image.resize_bilinear``, then the earlier ``orb_fast``)
  against this tree's (``orb_fast`` building the levels), and the describe
  stage as it ran it (the levels resized again and blurred by a float32
  cuDNN convolution, then the earlier ``orb_describe``) against this
  tree's (``orb_describe`` on ``orb_fast``'s levels); whether the
  candidates are equal, and the share of equal descriptor bits (the blur
  is now summed in float64).

Exits non-zero when either version fails to build or launch; a difference
is printed, not held.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from xfeatslam_tpu_torch import _build  # noqa: E402
from xfeatslam_tpu_torch.models import orb  # noqa: E402
from xfeatslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from xfeatslam_tpu_torch.ops.camera import Pinhole  # noqa: E402
from xfeatslam_tpu_torch.optim import local_ba as ba  # noqa: E402

FILES = {"pose_lm": ("pose_lm",),
         "local_ba": ("local_ba", "local_ba_scratch_floats"),
         "orb_fast": ("orb_fast",), "orb_describe": ("orb_describe",)}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the earlier design's ORB entry points: the level images (and the
# blurred levels) as host arrays of device pointers
EARLIER_ARGTYPES = {
    "orb_fast": [_P] * 5 + [_I, _P, _F, _F, _I, _P],
    "orb_describe": [_P] * 9 + [_I, _P, _P],
}


def ptxas_report() -> None:
    """Print ptxas's resource lines for this tree's kernels (built again,
    with -Xptxas -v, into the earlier build directory)."""
    out = os.path.join(_build.BUILD_DIR, "earlier")
    os.makedirs(out, exist_ok=True)
    for name in FILES:
        res = subprocess.run(
            [_build.find_nvcc(), *_build._flags(name), "-Xptxas", "-v", "-o",
             os.path.join(out, f"lib{name}-ptxas.so"),
             str(_build.SRC_DIR / f"{name}.cu")],
            capture_output=True, text=True)
        lines = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
                 if "registers" in ln or "stack frame" in ln]
        print(f"ptxas, this tree's {name}.cu: {lines}")


def build_earlier(src_dir: str) -> dict:
    """{file: loaded library} of the earlier sources in ``src_dir``, built
    at once."""
    out = os.path.join(_build.BUILD_DIR, "earlier")
    os.makedirs(out, exist_ok=True)
    nvcc = _build.find_nvcc()
    jobs = {}
    for name in FILES:
        if not os.path.exists(os.path.join(src_dir, f"{name}.cu")):
            continue
        lib = os.path.join(out, f"lib{name}.so")
        jobs[name] = (lib, subprocess.Popen(
            [nvcc, *_build._flags(name), "-o", lib,
             os.path.join(src_dir, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def entries(lib, name) -> dict:
    """The C entry points of ``name`` in ``lib``, typed as ck types them
    (the earlier ORB entries as they took their arguments)."""
    out = {}
    for fn in FILES[name]:
        f = getattr(lib, fn)
        _, argtypes, *restype = ck._ENTRY_POINTS[fn]
        f.argtypes = EARLIER_ARGTYPES.get(fn, argtypes)
        f.restype = restype[0] if restype else ctypes.c_int
        out[fn] = f
    return out


def device_events(fn) -> list:
    """The names of the device events torch.profiler records for one call
    of ``fn`` (kernels and copies, from the raw kineto records)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name()[:60] for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def replay_ms(fn, runs=5):
    """Median host ms of one replay of a captured call ``fn`` (the call's
    graph already captured), synchronized."""
    ts = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def solver_turns(earlier, current, use, dev) -> dict:
    """The pose LM and the BA solves, earlier and current sources in
    turns (see the module's docstring)."""
    order = (("earlier", earlier), ("current", current),
             ("current", current), ("earlier", earlier))
    cam = Pinhole.from_list([517.3, 516.5, 318.6, 255.3])
    rng = np.random.default_rng(3)
    report = {}
    for label, n, valid in (("N=1000, ~220 valid", 1000, 0.21),
                            ("N=8192, half valid", 8192, 0.5)):
        pargs = cs.pose_problem(rng, cam, n, dev, outlier_frac=0.1,
                                stereo_frac=0.7, valid_frac=valid)
        times = {}
        for tag, which in order:
            use(which)
            times.setdefault(tag, []).append(round(cs.graph_ms(
                lambda: ck.pose_lm(*pargs)), 5))
        use(current)
        report[f"pose_lm {label}, device ms"] = times
    full = cs.full_ba_problem(cam, cs.BF, dev)
    big = cs.full_ba_problem(cam, cs.BF, dev, n_pts=40000)
    for label, prob, si in (("full bucket", full, (5, 0)),
                            ("full bucket", full, (10, 10)),
                            ("40,000 points", big, (5, 0))):
        graphs = {"earlier": ba.LocalBAGraph(dev),
                  "current": ba.LocalBAGraph(dev)}
        results = {}
        times = {}
        for tag, which in order:
            use(which)
            g = graphs[tag]
            results[tag] = tuple(x.clone() for x in g(prob, cam, cs.BF,
                                                       stage_iters=si))
            times.setdefault(tag, []).append(round(replay_ms(
                lambda: g(prob, cam, cs.BF, stage_iters=si)), 4))
        use(current)
        a, b = results["current"], results["earlier"]
        report[f"local_ba {label} {si}, replay ms"] = times
        report[f"local_ba {label} {si}, bit-identical"] = all(
            torch.equal(x, y) for x, y in zip(a, b))
        report[f"local_ba {label} {si}, pose gap"] = max(
            float((a[0] - b[0]).abs().max()), float((a[1] - b[1]).abs().max()))
    report["pose_lm, device events of one call"] = device_events(
        lambda: ck.pose_lm(*pargs))
    report["local_ba full bucket (5, 0) eager, device events"] = device_events(
        lambda: ba.bundle_adjust(full, cam, cs.BF, stage_iters=(5, 0)))
    return report


def earlier_orb_fast(entry, img0, sizes, ini_thr, min_thr, edge):
    """The candidates stage's kernel call in the earlier design: each level
    resized by ``image.resize_bilinear`` (``orb._level_image``), then the
    earlier ``orb_fast`` entry on the level images; the outputs of this
    tree's wrapper (the levels as a list)."""
    levels = [orb._level_image(img0, lvl, h, w)
              for lvl, (h, w) in enumerate(sizes)]
    n = len(levels)
    buf = torch.empty(sum(4 * h * w for h, w in sizes), device=img0.device)
    scores, masked, at = [], [], 0
    for h, w in sizes:
        scores.append(buf[at:at + 2 * h * w].view(2, h, w))
        masked.append(buf[at + 2 * h * w:at + 4 * h * w].view(2, h, w))
        at += 4 * h * w
    counts = torch.zeros(n, dtype=torch.int32, device=img0.device)
    ptrs = [ck._pointers(t) for t in (levels, scores, masked)]
    hs, ws = ck._ints([h for h, _ in sizes]), ck._ints([w for _, w in sizes])
    err = entry(*(ctypes.addressof(p) for p in ptrs), ctypes.addressof(hs),
                ctypes.addressof(ws), n, counts.data_ptr(), float(ini_thr),
                float(min_thr), int(edge),
                torch._C._cuda_getCurrentRawStream(img0.get_device()))
    if err:
        raise RuntimeError(f"the earlier orb_fast failed to launch: {err}")
    return levels, scores, masked, counts


def earlier_describe(entry, img0, sizes, kpts, valid, pattern):
    """The describe stage in the earlier design: the levels resized again,
    each blurred by a float32 cuDNN convolution (TF32 off), then the
    earlier ``orb_describe`` entry on the levels and the blurred
    levels."""
    levels = [orb._level_image(img0, lvl, h, w)
              for lvl, (h, w) in enumerate(sizes)]
    k = orb._constant("gauss7_f32", img0.device,
                      lambda: orb._gauss_kernel7()[None, None])
    blurred = [F.conv2d(x[None, None], k, padding=3)[0, 0] for x in levels]
    descs = [torch.empty((kp.shape[0], 256), device=img0.device)
             for kp in kpts]
    angles = [torch.empty(kp.shape[0], device=img0.device) for kp in kpts]
    ptrs = [ck._pointers(t) for t in (levels, blurred, kpts, valid, descs,
                                      angles)]
    hs, ws, ns = (ck._ints(v) for v in ([h for h, _ in sizes],
                                        [w for _, w in sizes],
                                        [kp.shape[0] for kp in kpts]))
    err = entry(*(ctypes.addressof(p) for p in ptrs), ctypes.addressof(hs),
                ctypes.addressof(ws), ctypes.addressof(ns), len(levels),
                pattern.data_ptr(),
                torch._C._cuda_getCurrentRawStream(img0.get_device()))
    if err:
        raise RuntimeError(f"the earlier orb_describe failed to launch: {err}")
    return list(zip(descs, angles))


def orb_turns(earlier, dev) -> dict:
    """The earlier design's ORB stages against this tree's, in turns, by
    CUDA-graph replay (see the module's docstring)."""
    from xfeatslam_tpu_torch.optim.track_step import fetch
    from xfeatslam_tpu_torch.utils import synthetic

    img = synthetic.make_sequence(n_frames=1)["images"][0]
    ex = orb.ORBExtractor(nfeatures=cs.K)
    sizes, caps, mins = ex.geometry(*img.shape)
    x = torch.from_numpy(img.astype(np.float32)).to(dev)
    cands, levels = orb.orb_candidates(x, sizes, caps, mins, 20.0, 7.0)
    cands = fetch(cands)
    kp, va, _ = ex.select(cands, sizes)
    kp_d, va_d = [k.to(dev) for k in kp], [v.to(dev) for v in va]
    pat = orb._constant("pattern", dev,
                        lambda: orb._PATTERN.astype(np.float32))
    current_fast = ck.orb_fast

    def earlier_fast(img0, sz, ini_thr, min_thr, edge):
        return earlier_orb_fast(earlier["orb_fast"], img0, sz, ini_thr,
                                min_thr, edge)

    stages = {
        "earlier": (lambda: orb.orb_candidates(x, sizes, caps, mins, 20.0,
                                               7.0),
                    lambda: earlier_describe(earlier["orb_describe"], x,
                                             sizes, kp_d, va_d, pat)),
        "current": (lambda: orb.orb_candidates(x, sizes, caps, mins, 20.0,
                                               7.0),
                    lambda: orb.orb_describe_all(levels, sizes, kp_d, va_d)),
    }
    report = {}
    outputs = {}
    for tag in ("earlier", "current", "current", "earlier"):
        ck.orb_fast = earlier_fast if tag == "earlier" else current_fast
        try:
            cand, desc = stages[tag]
            outputs[tag] = (fetch(cand()[0]), fetch(desc()))
            report.setdefault("candidates stage, device ms", {}).setdefault(
                tag, []).append(round(cs.graph_ms(cand), 5))
            report.setdefault("describe stage, device ms", {}).setdefault(
                tag, []).append(round(cs.graph_ms(desc), 5))
        finally:
            ck.orb_fast = current_fast
    (ce, de), (cc, dc) = outputs["earlier"], outputs["current"]
    report["candidates equal"] = all(
        np.array_equal(a, b) for la, lb in zip(ce, cc) for a, b in zip(la, lb))
    bits = [float((a[0] == b[0]).mean()) for a, b in zip(de, dc)]
    report["describe bits equal per level"] = [round(b, 6) for b in bits]
    report["describe max angle gap"] = max(
        float(np.abs(a[1] - b[1]).max()) if a[1].size else 0.0
        for a, b in zip(de, dc))
    report["candidates stage, device events"] = cs.stage_events(
        stages["current"][0])[0]
    report["describe stage, device events"] = cs.stage_events(
        stages["current"][1])[0]
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", required=True,
                    help="directory with earlier sources (pose_lm.cu, "
                         "local_ba.cu, orb_fast.cu, orb_describe.cu)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("earlier_kernels: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    ptxas_report()
    dev = torch.device("cuda")
    _build.build(tuple(FILES))
    current = {}
    for name, fns in FILES.items():
        for fn in fns:
            current[fn] = ck._entry(fn)
    earlier = {}
    for name, lib in build_earlier(args.earlier).items():
        earlier.update(entries(lib, name))
    if not earlier:
        print(f"earlier_kernels: no earlier source in {args.earlier}",
              file=sys.stderr)
        return 1

    def use(which):
        ck._entries.update(which)

    report = {}
    if "pose_lm" in earlier and "local_ba" in earlier:
        report.update(solver_turns(earlier, current, use, dev))
    if "orb_fast" in earlier and "orb_describe" in earlier:
        report.update(orb_turns(earlier, dev))
    for key, value in report.items():
        print(f"{key}: {json.dumps(value)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

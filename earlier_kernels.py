#!/usr/bin/env python3
"""The pose-LM and local-BA kernels of this tree against earlier sources of
the same two files, on one NVIDIA GPU, in turns.

Usage: python3 earlier_kernels.py --earlier DIR   (from the repository
root, one CUDA card with nvcc; DIR holds ``pose_lm.cu`` and
``local_ba.cu`` of an earlier commit, e.g. unpacked with ``git show
COMMIT:xfeatslam_tpu_torch/csrc/pose_lm.cu > DIR/pose_lm.cu`` into a
directory that .gitignore lists)

Builds the earlier sources with the same nvcc flags into
``xfeatslam_tpu_torch/_build/earlier/`` (their C entry points take the
same arguments as this tree's), then times both versions in turns
(earlier, current, current, earlier) by CUDA-graph replay, on
``chip_smoke.py``'s inputs: the pose LM at N=1000 with ~220 valid edges
(the frame step's fill) and at N=8192 half valid, and a local-BA solve of
the full bucket (32 cameras, 4096 points, 16384 observations) at the
schedules (5, 0) and (10, 10), and of a problem with more entity blocks
than the card has SMs (32 cameras, 40,000 points) at (5, 0); and the
device events ``torch.profiler`` records for one call of this tree's
pose LM and one eager (5, 0) solve of the full bucket. Prints the ms of each turn, whether the two
versions' BA solves are bit-identical and how far their poses lie apart,
the card's name and power limit, and, first, what ``nvcc -Xptxas -v``
reports for this tree's two kernels (registers, shared memory, stack,
spills). Exits non-zero when either version fails to build or launch; a
difference is printed, not held.
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

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from xfeatslam_tpu_torch import _build  # noqa: E402
from xfeatslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from xfeatslam_tpu_torch.ops.camera import Pinhole  # noqa: E402
from xfeatslam_tpu_torch.optim import local_ba as ba  # noqa: E402

FILES = {"pose_lm": ("pose_lm",),
         "local_ba": ("local_ba", "local_ba_scratch_floats")}


def ptxas_report() -> None:
    """Print ptxas's resource lines for this tree's two kernels (built
    again, with -Xptxas -v, into the earlier build directory)."""
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
    """{file: loaded library} of the earlier sources, built at once."""
    out = os.path.join(_build.BUILD_DIR, "earlier")
    os.makedirs(out, exist_ok=True)
    nvcc = _build.find_nvcc()
    jobs = {}
    for name in FILES:
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
    """The C entry points of ``name`` in ``lib``, typed as ck types them."""
    out = {}
    for fn in FILES[name]:
        f = getattr(lib, fn)
        _, argtypes, *restype = ck._ENTRY_POINTS[fn]
        f.argtypes = argtypes
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", required=True,
                    help="directory with the earlier pose_lm.cu, local_ba.cu")
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

    def use(which):
        ck._entries.update(which)

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
    for key, value in report.items():
        print(f"{key}: {json.dumps(value)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

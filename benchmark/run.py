"""Run one cell of the benchmark of xfeatslam_tpu_torch and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. The last line of standard output is the result, one JSON
object; the numbers compared with the reference, each beside its limit, are
the last lines of standard error. A cell on several cards starts its ranks
itself, one process a card.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import shutil
import sys
import tempfile
import traceback

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, _ROOT)


def _rank(target, spec, device, rank, world, init, hook, args):
    """A rank other than 0 of a cell on several cards (a spawned process)."""
    try:
        target(spec, *args, device, rank, world, init, hook)
    except BaseException:
        traceback.print_exc()
        raise


def launch(target, spec, args, device="cuda", hook=None):
    """``target(spec, *args, device, rank, world, init_method, hook)`` on
    each of the cell's ranks, rank 0 in this process, the others spawned;
    rank 0's return value. ``hook``, "module:function", is called with each
    rank's session before its set-up goes on (the tests plant faults so)."""
    from benchmark import harness

    world = spec.chips
    if world == 1:
        return target(spec, *args, device, 0, 1, None, hook)
    from xfeatslam_tpu_torch import _build

    if device == "cuda":
        _build.build()  # once, before the ranks, which would race for it
    tmp = tempfile.mkdtemp(prefix="bench-rdv-")
    init = "file://" + os.path.join(tmp, "rendezvous")
    np.full(2, -1, np.int64).tofile(harness.agreement_path(init))
    ctx = mp.get_context("spawn")
    dev = (lambda r: f"cuda:{r}") if device == "cuda" else (lambda r: "cpu")
    procs = [ctx.Process(target=_rank, args=(target, spec, dev(r), r, world,
                                            init, hook, args))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        out = target(spec, *args, dev(0), 0, world, init, hook)
    finally:
        for p in procs:
            p.join(timeout=120)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"a rank exited with {bad}")
    return out


def run(spec, seed, seconds, trace, device="cuda", hook=None):
    """The result of one run of the cell ``spec`` (``harness.cell``)."""
    from benchmark import harness

    return launch(harness.run_rank, spec, (seed, seconds, trace), device,
                  hook)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness

    spec = harness.cell(args.workload)
    chips = spec.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(spec, args.seed, args.seconds, bool(args.trace))
    bad = harness.loaded_forbidden()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

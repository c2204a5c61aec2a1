"""The network's device time on a card, layer by layer.

``XFeat.forward`` runs with each conv (and its ReLU) under a
``record_function`` range named after its module; ``torch.profiler`` then
gives each device kernel to the innermost range whose device span holds its
start. Prints each layer's device ms a forward, the two kernels that take
most of it, and the layers that cuDNN's generic NHWC engine
(``convolve_common_engine_float_NHWC``) and its FFT convolution serve. The
stem runs on its kernel (``ops/cuda_kernels.xfeat_stem``) unless ``--plain``
gives it the plain ops. The frames are ``profile_pipeline.make_images``'s
(two, repeated to the batch) and the weights the shipped ones. Float32 with
TF32 off. The card only.

    python -m xfeatslam_tpu_torch.tools.network_layers [--plain] \\
        [--batch 256] [--hw 480 640] [--reps 3]
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the kernels of cuDNN's that the report follows layer by layer
GENERIC = ("convolve_common_engine_float_NHWC",
           "pointwise_mult_and_sum_complex", "fft")


@contextlib.contextmanager
def layer_ranges(model):
    """Each conv of ``XFeat.forward`` (with its ReLU, where it has one)
    under a range ``layer.<module name>``."""
    from torch.autograd.profiler import record_function

    from ..models import xfeat

    names = {id(m): n for n, m in model.named_modules()}
    conv, stack = xfeat._conv, xfeat._basic_stack

    def named_conv(x, c, *a, **kw):
        with record_function(f"layer.{names[id(c)]}"):
            return conv(x, c, *a, **kw)

    def named_stack(x, convs, *a, **kw):
        for c in convs:
            with record_function(f"layer.{names[id(c)]}"):
                x = stack(x, [c], *a, **kw)
        return x

    # stack's own call of _conv opens a second range of the same name
    # inside the first: its ReLU lies in the outer one
    xfeat._conv, xfeat._basic_stack = named_conv, named_stack
    try:
        yield
    finally:
        xfeat._conv, xfeat._basic_stack = conv, stack


def by_layer(model, x, reps: int, plain: bool) -> dict:
    """Device ms a forward of ``model`` on ``x``, by layer and by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..ops import cuda_kernels as ck

    kernel = ck.xfeat_stem
    if plain:
        ck.xfeat_stem = ck.xfeat_stem_plain
    try:
        with torch.no_grad(), layer_ranges(model):
            for _ in range(2):
                model(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    model(x)
                torch.cuda.synchronize()
    finally:
        ck.xfeat_stem = kernel
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    # the layers' ranges, and the stem's span around block1 and skip1
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                     e.name()[len("layer."):] if e.name() != "xfeat.stem"
                     else "stem (the rest of xfeat.stem)") for e in evs
                    if e.is_user_annotation()
                    and (e.name().startswith("layer.")
                         or e.name() == "xfeat.stem"))
    starts = [r[0] for r in ranges]
    layers, kernels, total = {}, {}, 0.0
    for e in evs:
        if e.is_user_annotation():
            continue
        ms = e.duration_ns() / 1e6 / reps
        total += ms
        i = bisect.bisect_right(starts, e.start_ns()) - 1
        while i >= 0 and e.start_ns() >= ranges[i][1]:
            i -= 1
        layer = ranges[i][2] if i >= 0 else "other (sums, upsample, sigmoid)"
        layers[layer] = layers.get(layer, 0.0) + ms
        kernels[(e.name()[:70], layer)] = kernels.get(
            (e.name()[:70], layer), 0.0) + ms
    generic = {}
    for (name, layer), ms in kernels.items():
        for tag in GENERIC:
            if tag in name:
                g = generic.setdefault(tag, {})
                g[layer] = round(g.get(layer, 0.0) + ms, 4)
    return {"total_ms": total, "layers": layers, "kernels": kernels,
            "generic": generic}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m xfeatslam_tpu_torch.tools.network_layers",
        description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--hw", type=int, nargs=2, default=[480, 640])
    ap.add_argument("--reps", type=int, default=3,
                    help="profiled forwards, after two warm-up ones")
    ap.add_argument("--plain", action="store_true",
                    help="the stem's plain ops instead of its kernel")
    args = ap.parse_args(argv)
    if args.hw[0] % 32 or args.hw[1] % 32:
        ap.error("--hw: H and W must be multiples of 32")
    import torch

    from ..models import weights
    from . import float32_math
    from .profile_pipeline import make_images

    if not torch.cuda.is_available():
        ap.error("needs a CUDA card")
    float32_math()
    model = weights.load_npz(
        os.path.join(_REPO, "weights", "xfeat_synthetic.npz"), device="cuda")
    B, (h, w) = args.batch, args.hw
    x = torch.from_numpy(make_images(2, (h, w))).cuda()
    x = x.repeat((B + 1) // 2, 1, 1, 1)[:B].contiguous()
    route = "plain" if args.plain else "kernel"
    r = by_layer(model, x, args.reps, args.plain)
    total = r["total_ms"]
    print(f"network by layer, {route} stem, {B}x{h}x{w}, device ms a "
          f"forward, {total:.3f} in all:")
    for layer, ms in sorted(r["layers"].items(), key=lambda kv: -kv[1]):
        top = sorted(((k[0], v) for k, v in r["kernels"].items()
                      if k[1] == layer), key=lambda kv: -kv[1])[:2]
        print(f"  {layer}: {ms:.3f} ms ({100 * ms / total:.1f}%); "
              + "; ".join(f"{n} {v:.3f}" for n, v in top))
    print(f"  generic engine and FFT conv by layer: "
          f"{json.dumps(r['generic'])}")
    print(json.dumps({"network_layers": {
        "route": route, "batch": B, "hw": [h, w], "total_ms": total,
        "layers": {k: round(v, 4) for k, v in r["layers"].items()},
        "generic": r["generic"]}}))


if __name__ == "__main__":
    main()

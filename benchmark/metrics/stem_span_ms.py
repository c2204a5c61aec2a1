"""Device ms per batch of the program's span ``xfeat.stem``: the network's
full-resolution stem (the instance norm, block1, the skip branch and the
keypoint head's space-to-depth; ``ops/cuda_kernels.xfeat_stem`` on the
card), nested in ``xfeat.network``; the median over the profiled batches.
Nothing where the program records no such span."""

from benchmark import spans


def read(rec):
    return spans.device_ms(rec, "xfeat.stem")

"""Seconds from the process's start to the first timed batch: the build
of the kernels where the checkout has none, the weights, the traffic, the
warm-up."""


def read(rec):
    return rec.setup_s

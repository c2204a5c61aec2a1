"""The 95th percentile of every batch's latency, from the start of its
upload to its last answer on the host (on a mesh, the slowest rank's)."""

import numpy as np


def read(rec):
    return float(np.percentile(np.asarray(rec.lat) * 1e3, 95))

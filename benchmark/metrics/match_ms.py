"""Device ms per batch of the match stage (CUDA events at its boundaries),
the median over the traced window's batches."""

import numpy as np


def read(rec):
    v = rec.spans.get("match")
    return None if v is None else float(np.median(v))

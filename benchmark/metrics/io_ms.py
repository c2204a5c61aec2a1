"""Device ms per batch of the host hand-off: the upload, the conversion to
float and the read-back of every answer (CUDA events at its boundaries),
the median over the traced window's batches."""

import numpy as np


def read(rec):
    v = rec.spans.get("io")
    return None if v is None else float(np.median(v))

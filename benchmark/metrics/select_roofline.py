"""Keypoint selection's share of its roofline: the bytes it must move
(``counts.select_bytes``) at the peak bandwidth, over its measured time,
summed over the traced window's batches, in %."""

from benchmark import counts


def read(rec):
    v = rec.spans.get("select")
    if v is None or not len(v):
        return None
    K = rec.cfg["extractor"]["num_keypoints"]
    bound = counts.roofline_s(0, counts.select_bytes(rec.batch, rec.net_hw, K),
                              rec.peaks)
    return 100.0 * bound * len(v) / (float(v.sum()) / 1e3)

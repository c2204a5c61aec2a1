"""The matcher's share of its roofline: the larger of its operations (valid
rows x valid columns of each pair) at the float32 peak and its bytes at
the peak bandwidth, over its measured time, summed over the traced
window's batches, in %."""

from benchmark import counts


def read(rec):
    v = rec.spans.get("match")
    if v is None or not len(v):
        return None
    K = rec.cfg["extractor"]["num_keypoints"]
    nbytes = counts.match_bytes(rec.batch, K)
    bound = sum(counts.roofline_s(counts.match_ops(c), nbytes, rec.peaks)
                for c in rec.counts)
    return 100.0 * bound / (float(v.sum()) / 1e3)

"""The share of the traced window in which no kernel or copy ran on the
card (the union of the profiler's device records), the mean over the
chips used, in %."""


def read(rec):
    if not rec.ranks or not all(rec.ranks):
        return None
    return 100.0 * sum(1.0 - r["busy_s"] / r["window_s"]
                       for r in rec.ranks) / len(rec.ranks)

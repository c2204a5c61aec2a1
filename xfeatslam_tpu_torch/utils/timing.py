"""Per-stage timing statistics (role of ORB-SLAM3's REGISTER_TIMES spans,
dumped as mean/std per stage at shutdown).

A copy of ``xfeatslam_tpu/utils/timing.py``. The spans are host wall
time: a span that ends with a host read of device results (every tracked
frame does) includes the device work it waited for."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List


class StageTimer:
    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        self.samples[name].append(seconds)

    def summary(self) -> Dict[str, dict]:
        import numpy as np

        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "mean_ms": float(a.mean() * 1e3),
                "std_ms": float(a.std() * 1e3),
                "median_ms": float(np.median(a) * 1e3),
                "count": len(a),
            }
        return out

    def dump(self, path: str):
        """ExecMean.txt-style dump (mean +- std per stage)."""
        with open(path, "w") as f:
            for name, st in sorted(self.summary().items()):
                f.write(
                    f"{name}: {st['mean_ms']:.3f} ms +- {st['std_ms']:.3f} ms "
                    f"(median {st['median_ms']:.3f} ms, n={st['count']})\n"
                )

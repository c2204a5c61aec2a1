"""What the profiler's trace of a window says: the device's busy time, the
device operations that took the most, the idle gaps by what the host was
doing, and the collectives' device time. Read from the raw kineto records
(building the profiler's Python events for a window of many kernels takes
minutes)."""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

BATCH = "bench.batch"


def _records(prof):
    """(device ops [(start, end, name)], host ops [(start, end, name)])
    in ns, the device's without the profiler's own annotations."""
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        rec = (s, s + e.duration_ns(), e.name())
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev.append(rec)
        else:
            host.append(rec)
    return dev, host


def _host_at(host, starts, t):
    """The innermost host op running at ``t``: of those that cover it, the
    one that started last (looked for among the 256 last to start)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 256, -1), -1):
        s, e, n = host[j]
        if e >= t and n != BATCH:
            return n
    return "python between ops"


def summarize(prof, top: int = 10):
    """The window from the first to the last ``bench.batch`` range: its
    length, the union of device op intervals in it, the top device ops by
    summed time, the idle gaps' time summed by the host op that covered
    each gap's middle, and the summed device time of NCCL kernels."""
    dev, host = _records(prof)
    batches = [(s, e) for s, e, n in host if n == BATCH]
    if not batches or not dev:
        return None
    w0 = min(s for s, _ in batches)
    w1 = max(e for _, e in batches)
    dev.sort()
    host.sort()
    starts = [h[0] for h in host]
    busy = 0
    per_op = defaultdict(int)
    gaps = defaultdict(int)
    nccl = 0
    cur = w0
    for s, e, n in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        per_op[n] += e - s
        if "nccl" in n.lower():
            nccl += e - s
        if s > cur:
            gaps[_host_at(host, starts, (cur + s) // 2)] += s - cur
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if w1 > cur:
        gaps[_host_at(host, starts, (cur + w1) // 2)] += w1 - cur

    def ranked(d):
        return [[n, v / 1e9] for n, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
            "device_ops": ranked(per_op), "idle_gaps": ranked(gaps),
            "nccl_s": nccl / 1e9, "batches": len(batches)}

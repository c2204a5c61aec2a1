"""``stem_span_ms``: the device ms of the program's ``xfeat.stem`` span a
batch, read from a synthetic profiled stretch and from a traced run on the
CPU at a small size; a program that records no such span (one without the
stem's own span) reads as nothing."""

from types import SimpleNamespace

import pytest

from benchmark import harness, run

from .test_bench_faults import SEED
from .tiny import tiny


def _batch(stem_ms):
    """One batch's records (name, parent, host ms, device ms), the stem
    left out where ``stem_ms`` is None."""
    recs = [("xfeat.upload", None, 0.4, 0.3),
            ("xfeat.extract_batch", None, 9.0, 8.0),
            ("xfeat.network", "xfeat.extract_batch", 7.0, 6.0)]
    if stem_ms is not None:
        recs.append(("xfeat.stem", "xfeat.network", 1.0, stem_ms))
    return recs + [("xfeat.select", "xfeat.extract_batch", 1.0, 0.5)]


@pytest.mark.parametrize("stems, want", [((1.5, 2.5, 2.0), 2.0),
                                         ((None, None), None)])
def test_stem_span_ms_reads_the_stem_records(monkeypatch, stems, want):
    from xfeatslam_tpu_torch.utils import timing

    recs = [r for s in stems for r in _batch(s)]
    monkeypatch.setattr(timing, "records", lambda: recs)
    rec = SimpleNamespace(spans={}, counts=[[1]], ranks=[{}], chips=1)
    assert harness.reader("stem_span_ms")(rec) == want


def test_traced_run_reports_the_stem_inside_the_network():
    out = run.run(tiny("offline.tum1.b32"), SEED, 0.3, True, device="cpu")
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert 0 < m["stem_span_ms"] <= m["network_span_ms"]

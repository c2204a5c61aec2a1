"""The program's spans (``utils/timing``): off, the batched pass records
nothing; under ``torch.profiler`` its layers' ranges land in the trace,
nested as the calls are, and in the process-wide timer with the same names
and parents; the timer keeps only the newest profiled stretch; a
``System``'s ``StageTimer.span`` reaches the trace too; and on a card a
graph captured under the profiler records no CUDA event.

The card's test runs there with ``python -m pytest --noconftest
tests/test_torch_tracing.py`` (the tests' conftest imports JAX)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from xfeatslam_tpu_torch import _build  # noqa: E402
from xfeatslam_tpu_torch.models import weights as tw  # noqa: E402
from xfeatslam_tpu_torch.ops import image as ti  # noqa: E402
from xfeatslam_tpu_torch.parallel import batched as tb  # noqa: E402
from xfeatslam_tpu_torch.parallel import mesh as tm  # noqa: E402
from xfeatslam_tpu_torch.utils import timing  # noqa: E402

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "weights", "xfeat_synthetic.npz")
B, H, W, K = 3, 64, 96, 32


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def timer(monkeypatch):
    """A fresh process-wide timer for the test."""
    t = timing.StageTimer()
    monkeypatch.setattr(timing, "PROCESS", t)
    return t


@pytest.fixture(scope="module")
def model():
    return tw.load_npz(NPZ, device="cpu")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(5)
    return (rng.random((B, H, W, 1)) * 255).astype(np.uint8)


def _pass(model, frames, device="cpu"):
    """Upload, extract and match, as a user runs the batched pass."""
    x = ti.to_float_image(frames, device)
    out = tb.extract_batch(model, x, K)
    return out, tb.match_consecutive(out["desc"], out["valid"])


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def _parents(prof, prefix="xfeat."):
    """Each span's name -> its enclosing span's name (None at the root),
    from the profiler's events."""
    out = {}
    for e in prof.events():
        if e.name.startswith(prefix):
            p = e.cpu_parent
            while p is not None and not p.name.startswith(prefix):
                p = p.cpu_parent
            out[e.name] = p.name if p is not None else None
    return out


def test_off_records_nothing(model, frames, timer):
    _pass(model, frames)
    assert timer.records == [] and timer.dropped == 0
    assert timing.records() == []


def test_profiled_spans_nest_in_the_trace_and_the_timer(model, frames, timer):
    prof = _profiled(lambda: _pass(model, frames))
    want = {"xfeat.upload": None, "xfeat.extract_batch": None,
            "xfeat.network": "xfeat.extract_batch",
            "xfeat.stem": "xfeat.network",
            "xfeat.select": "xfeat.extract_batch", "xfeat.match": None}
    assert _parents(prof) == want
    recs = timing.records()
    assert [r[0] for r in recs] == ["xfeat.upload", "xfeat.extract_batch",
                                    "xfeat.network", "xfeat.stem",
                                    "xfeat.select", "xfeat.match"]
    assert {r[0]: r[1] for r in recs} == want
    for name, _, host, dev in recs:
        assert host > 0 and dev == host, name
    net = next(r for r in recs if r[0] == "xfeat.network")
    outer = next(r for r in recs if r[0] == "xfeat.extract_batch")
    assert net[2] <= outer[2]


def test_extract_fn_holds_the_resize(model, timer):
    from xfeatslam_tpu_torch.models import extractor

    x = torch.rand(B, 70, 100, 1)  # resized to 64x96
    _profiled(lambda: extractor.extract_fn(model, x, K))
    assert {r[0]: r[1] for r in timing.records()} == {
        "xfeat.extract_fn": None, "xfeat.resize": "xfeat.extract_fn",
        "xfeat.network": "xfeat.extract_fn", "xfeat.stem": "xfeat.network",
        "xfeat.select": "xfeat.extract_fn"}


def test_sharded_pipeline_on_a_mesh_of_one_nests(model, frames, timer):
    pipe = tb.make_sharded_pipeline(tm.make_mesh(1, device="cpu"), model,
                                    num_keypoints=K)
    x = ti.to_float_image(frames, "cpu")
    prof = _profiled(lambda: pipe(x))
    want = {"xfeat.pipeline": None, "xfeat.extract_batch": "xfeat.pipeline",
            "xfeat.network": "xfeat.extract_batch",
            "xfeat.stem": "xfeat.network",
            "xfeat.select": "xfeat.extract_batch",
            "xfeat.match": "xfeat.pipeline"}
    assert _parents(prof) == want
    assert {r[0]: r[1] for r in timing.records()} == want


def test_only_the_newest_profiled_stretch_is_held(model, frames, timer):
    out, _ = _pass(model, frames)
    _profiled(lambda: _pass(model, frames))
    first = len(timer.records)
    assert first == 6
    tb.match_consecutive(out["desc"], out["valid"])  # the profiler is off
    assert len(timer.records) == first
    _profiled(lambda: [tb.match_consecutive(out["desc"], out["valid"])
                       for _ in range(2)])
    assert [r[:2] for r in timing.records()] == [("xfeat.match", None)] * 2


def test_records_past_the_cap_are_counted(model, frames, timer, monkeypatch):
    monkeypatch.setattr(timing, "MAX_RECORDS", 3)
    _profiled(lambda: _pass(model, frames))
    assert len(timer.records) == 3 and timer.dropped == 3


def test_off_span_is_one_flag_check():
    """Off, ``span`` hands back one shared object that does nothing."""
    assert timing.span("a") is timing.span("b")
    with timing.span("a") as s:
        assert s is timing.span("c")


def test_stage_timer_span_reaches_the_trace():
    t = timing.StageTimer()
    with t.span("track"):  # off: a host sample only
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.span("track"):
            with t.span("track.extract"):
                torch.ones(4).sum()
    assert _parents(prof, "track") == {"track": None,
                                       "track.extract": "track"}
    assert len(t.samples["track"]) == 2
    assert len(t.samples["track.extract"]) == 1
    assert t.records == []


def test_build_records_each_library_it_loads(monkeypatch, tmp_path):
    """``_build.loads`` gains one record a library, loaded or compiled."""
    monkeypatch.setattr(_build, "loads", [])
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build", lambda names: ["k"])
    monkeypatch.setattr(_build, "library_path", lambda name: tmp_path / name)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    _build.load("k")
    _build.load("k")
    assert [(n, c) for n, _, c in _build.loads] == [("k", True)]
    assert _build.loads[0][1] >= 0


@pytest.mark.card
def test_graph_captured_under_the_profiler_records_no_event(timer):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = tw.load_npz(NPZ, device="cuda")
    x = torch.rand(B, H, W, 1, device="cuda")
    want = tb.extract_batch(model, x, K)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tb.extract_batch(model, x, K)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with torch.cuda.graph(g):
            got = tb.extract_batch(model, x, K)
        g.replay()
        torch.cuda.synchronize()
    assert [r[0] for r in timer.records] == ["xfeat.extract_batch",
                                             "xfeat.network", "xfeat.stem",
                                             "xfeat.select"]
    assert all(r[4] is False and r[5] is False for r in timer.records)
    assert all(r[3] is None for r in timing.records())
    for k in want:
        assert torch.equal(got[k], want[k]), k

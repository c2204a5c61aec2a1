"""A run on the CPU at a small size, the harness's look for a card
skipped: sound, it comes out correct; with each fault its cell can have
planted under the timed path, it comes out not correct."""

import pytest

from benchmark import run

from .tiny import tiny

SEED = 2**31 + 11
ONE_CHIP = ["offline.tum1.b256", "offline.kitti.b256", "offline.tum1.b32"]


@pytest.mark.parametrize("cell", ONE_CHIP)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(cell, trace):
    out = run.run(tiny(cell), SEED, 0.3, trace, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m for m in out["metrics"]}
    if trace:
        assert {"network_ms", "select_ms", "match_ms", "io_ms"} <= names
        assert out["checks"]["split_equal"]["value"] == 0
    else:
        assert names == {"frames_per_s", "batch_p95_ms", "setup_s"}


@pytest.mark.parametrize("cell", ONE_CHIP)
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_fault_is_not_correct(cell, fault):
    out = run.run(tiny(cell), SEED, 0.3, False, device="cpu",
                  hook=f"benchmark.tests.faults:{fault}")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [None, "no_exchange", "altered"])
def test_mesh_cell_on_four_cpu_ranks(fault):
    spec = tiny("offline.tum1.b256.mesh4", batch=8, judge_batches=1)
    out = run.run(spec, SEED, 0.3, False, device="cpu",
                  hook=fault and f"benchmark.tests.faults:{fault}")
    assert out["device"]["count"] == 4
    assert out["correct"] == (fault is None), out["checks"]

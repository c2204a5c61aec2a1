"""BENCHMARK.json and the files it names: every cell finds its
configuration, traffic, limits, entry and metric readers by name."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

from .tiny import MESH_CELL, bench

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]] + [MESH_CELL["name"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    spec = harness.cell(name, bench())
    assert spec.cfg["reduced"] == []
    assert set(spec.limits) >= {"nms_gap", "desc_gap", "match_gap",
                                "rank_gap", "bad_slots"}
    assert spec.limits["bad_slots"] == 0
    assert (harness.HERE / "entries" / f"{spec.entry}.py").exists()
    for m in spec.end_to_end + spec.per_layer:
        assert callable(harness.reader(m["name"]))
    moves = {m["name"] for m in spec.end_to_end}
    assert all(m["moves"] in moves for m in spec.per_layer)
    assert spec.per_layer


def test_readers_leave_out_what_they_cannot_read():
    from types import SimpleNamespace
    rec = SimpleNamespace(spans={}, counts=[], ranks=[None], chips=1)
    for m in BENCH["per_layer"]:
        if m["name"] in ("step_mfu", "device_idle_share", "collective_ms") \
                or m["name"].endswith(("_ms", "_roofline")):
            assert harness.reader(m["name"])(rec) is None

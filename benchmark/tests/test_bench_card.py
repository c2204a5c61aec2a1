"""On the card: a short run of each one-card cell, correct, with every
metric of its kind. Skips without a card (``python -m pytest
benchmark/tests -m card`` on a machine with one)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["offline.tum1.b256", "offline.kitti.b256", "offline.tum1.b32"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                        "--seed", "2147483659", "--seconds", "2",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0

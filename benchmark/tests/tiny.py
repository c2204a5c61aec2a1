"""A cell cut to a size that a CPU test holds: small frames (the camera
scaled with them), few slots, a few frames a batch. Everything else is the
cell's own: configuration, traffic, limits, entry and metrics.

``MESH_CELL`` is the four-card cell that `BENCHMARK.json` leaves out until
its runs hold a bound (PERF.md, Open questions); its files are here and the
tests drive it on four CPU ranks."""

import copy
import json

from benchmark import harness

MESH_CELL = {
    "name": "offline.tum1.b256.mesh4", "config": "xfeat-tum1-vga-k1000",
    "traffic": "batch256.mesh4", "chips": 4,
    "why": "batch 256 over a 4-card data mesh (make_sharded_pipeline, NCCL)"}


def bench():
    """BENCHMARK.json's object with ``MESH_CELL`` and its metric added."""
    b = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    b["workloads"].append(MESH_CELL)
    b["per_layer"].append({
        "name": "collective_ms", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "mesh gathers (parallel/mesh, NCCL)",
        "moves": "frames_per_s", "workloads": [MESH_CELL["name"]]})
    return b


def tiny(name, hw=None, K=64, batch=4, judge_batches=2):
    spec = harness.cell(name, bench())
    if hw is None:
        hw = (70, 100) if spec.cfg["extractor"]["subpixel"] else (64, 96)
    spec.cfg = copy.deepcopy(spec.cfg)
    s = hw[1] / spec.cfg["frame"]["width"]
    spec.cfg["frame"].update(height=hw[0], width=hw[1])
    spec.cfg["camera"] = {k: v * s for k, v in spec.cfg["camera"].items()}
    spec.cfg["extractor"]["num_keypoints"] = K
    spec.traffic = dict(spec.traffic, batch=batch, pool_batches=2,
                        judge_batches=judge_batches)
    return spec

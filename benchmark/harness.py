"""One run of one cell: set-up, the measured window, the check of what the
window produced, and the result line.

Everything that belongs to a cell is found by name: the cell in
``BENCHMARK.json``, its configuration's file, its traffic mix in
``workloads/<traffic>.json``, its limits in ``limits/<cell>.json``, the
entry it drives in ``entries/<entry>.py`` and each metric's reader in
``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from xfeatslam_tpu_torch.models import weights as wio
from xfeatslam_tpu_torch.ops import image as image_ops
from xfeatslam_tpu_torch.parallel import mesh as mesh_mod

from . import judge as judge_mod
from . import trace as trace_mod
from .entries import load as load_entry
from .reference import xfeat as ref
from .traffic import render

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
WEIGHTS = ROOT / "weights" / "xfeat_synthetic.npz"
FORBIDDEN = ("jax", "jaxlib", "flax", "xfeatslam_tpu")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's clock ticks)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def cell(name: str, bench=None):
    """The cell ``name`` of ``bench`` (``BENCHMARK.json``'s object, read
    from the root when not given) with its configuration, traffic, limits
    and the metrics it reports."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    traffic = json.loads((HERE / "workloads" / f"{w['traffic']}.json")
                         .read_text())
    return SimpleNamespace(
        name=name, chips=w["chips"],
        cfg=json.loads((ROOT / c["file"]).read_text()),
        traffic=traffic,
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        entry=traffic.get("entry") or json.loads(
            (ROOT / c["file"]).read_text())["entry"])


def reader(metric: str):
    """``read(rec)`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"metric {metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Marks:
    """CUDA events at each stage boundary of each traced batch (the host
    clock on the CPU, where every op is synchronous)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.rows = []

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self):
        self.cur = [("start", self._now())]

    def mark(self, name):
        self.cur.append((name, self._now()))

    def end(self):
        self.rows.append(self.cur)

    def spans_ms(self):
        """Stage name -> ms per batch; "io" is the upload and the
        read-back together."""
        out = {}
        for row in self.rows:
            for (_, a), (name, b) in zip(row[:-1], row[1:]):
                ms = (a.elapsed_time(b) if self.cuda else (b - a) * 1e3)
                key = "io" if name in ("upload", "readback") else name
                out.setdefault(key, []).append(0.0)
                out[key][-1] += ms
        return {k: np.array(v) for k, v in out.items()}


class Session:
    """The program's model and entry on one device, with the traffic.
    ``hook``, "module:function", is called with the session before
    anything runs (the tests plant faults so)."""

    def __init__(self, spec, device, mesh=None, hook=None):
        self.spec = spec
        self.device = device
        self.model = wio.load_npz(str(WEIGHTS), device)
        self.entry = load_entry(spec.entry)(self.model, spec.cfg, device,
                                            mesh)
        self.batch = spec.traffic["batch"]
        self.free = []
        if hook is not None:
            mod, fn = hook.split(":")
            getattr(importlib.import_module(mod), fn)(self)

    def run_batch(self, frames, marks=None):
        """One batch as a user runs it: upload, to float, the entry, every
        answer read back to the host."""
        if marks is None:
            x = image_ops.to_float_image(frames, self.device)
            return self._read_back(self.entry.step(x))
        marks.start()
        with record_function("bench.upload"):
            x = image_ops.to_float_image(frames, self.device)
        marks.mark("upload")
        with record_function("bench.step"):
            out = self.entry.traced_step(x, marks.mark)
        with record_function("bench.readback"):
            host = self._read_back(out)
        marks.mark("readback")
        marks.end()
        return host

    def _read_back(self, out):
        """Every answer copied into a set of host buffers (pinned, made in
        set-up, reused), then one wait for the copies."""
        self.reserve(1, out)
        host = self.free.pop()
        for k, v in out.items():
            host[k].copy_(v, non_blocking=True)
        _sync(self.device)
        return host

    def release(self, host):
        """Give a batch's host buffers back for the next batches."""
        self.free.append(host)

    def reserve(self, n: int, like):
        """Have ``n`` sets of host buffers shaped as ``like`` ready."""
        while len(self.free) < n:
            self.free.append({k: torch.empty(
                v.shape, dtype=v.dtype, pin_memory=self.device.type == "cuda")
                for k, v in like.items()})

    def pool_batch(self, pool, b):
        return pool[b * self.batch:(b + 1) * self.batch]


def _equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# the profiler records the first seconds of a traced window: reading the
# trace of a longer one would take minutes
PROFILED_S = 10.0


class Agreement:
    """Where the window and its profiled part end, as batch indices that
    every rank reads: rank 0 decides by its clock, after the batch in which
    the time is up, that the next batch is the last, and writes that
    index; every rank ends after that index. Ranks move in step (each batch
    has its collectives), so a rank is never past the index when it is
    written. Several ranks share ``path``, a file of two int64 made before
    they start; one rank keeps the indices in memory."""

    WINDOW, PROFILED = 0, 1

    def __init__(self, rank: int, path=None):
        self.rank = rank
        self.last = (np.full(2, -1, np.int64) if path is None else
                     np.memmap(path, dtype=np.int64, mode="r+", shape=(2,)))

    def ends_after(self, part: int, i: int, due: bool) -> bool:
        if self.rank == 0 and due and self.last[part] < 0:
            self.last[part] = i + 1
        return 0 <= self.last[part] <= i


def window(sess, pool, seconds, seed, trace, agree, prof=None):
    """The measured window: batches of the pool in turn until ``seconds``
    have passed (every rank ending at the same batch through ``agree``).
    Returns the latencies, the frames, the window's length, a sample of
    the batches' answers drawn from the seed (reservoir), the valid counts
    of each batch's frames and the stage marks of a traced run. ``prof``,
    a started profiler, is stopped after the batch that ends past
    ``PROFILED_S``."""
    nb = len(pool) // sess.batch
    k = sess.spec.traffic["judge_batches"]
    rng = random.Random(seed)
    keep, lat, counts = [], [], []
    marks = Marks(sess.device) if trace else None
    t_start = time.perf_counter()
    i = 0
    while True:
        b = i % nb
        t0 = time.perf_counter()
        if trace:
            with record_function(trace_mod.BATCH):
                host = sess.run_batch(sess.pool_batch(pool, b), marks)
        else:
            host = sess.run_batch(sess.pool_batch(pool, b))
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if trace:
            counts.append(np.count_nonzero(host["valid"].numpy(), axis=1))
        if len(keep) < k:
            keep.append((b, host))
        else:
            j = rng.randrange(i + 1)
            if j < k:
                sess.release(keep[j][1])
                keep[j] = (b, host)
            else:
                sess.release(host)
        if prof is not None and agree.ends_after(
                agree.PROFILED, i, t1 - t_start >= PROFILED_S):
            prof.stop()
            prof = None
        i += 1
        if agree.ends_after(agree.WINDOW, i - 1, t1 - t_start >= seconds):
            break
    if prof is not None:
        prof.stop()
    t_end = time.perf_counter()
    return SimpleNamespace(lat=lat, frames=i * sess.batch, batches=i,
                           window_s=t_end - t_start, keep=keep,
                           counts=[v.tolist() for v in counts],
                           marks=marks)


def _slowest(lats):
    """Each batch's latency on the slowest rank. Ranks whose batches share
    collectives run as many; a rank cut off from the others may not, and
    only the batches that all ran count."""
    n = min(len(v) for v in lats)
    return np.max([v[:n] for v in lats], axis=0)


def check(spec, nums):
    """Each number compared beside its limit, and whether all are within."""
    checks = {k: {"value": nums[k], "limit": spec.limits[k]}
              for k in spec.limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def judge_kept(spec, device, pool, keep, batch):
    """The numbers of the kept batches, the widest of each (the count of
    wrong slots summed), judged by the reference on ``device``."""
    net = ref.Network(str(WEIGHTS), device)
    total = {}
    for b, host in keep:
        frames = pool[b * batch:(b + 1) * batch].to(device)
        n = judge_mod.judge(net, frames, host, spec.cfg)
        for k, v in n.items():
            if k == "bad_slots":
                total[k] = total.get(k, 0) + v
            elif k in ("kpts_per_frame", "matches_per_pair"):
                total.setdefault(k, []).append(v)
            else:
                total[k] = max(total.get(k, 0.0), v)
    for k in ("kpts_per_frame", "matches_per_pair"):
        total[k] = float(np.mean(total[k]))
    return total


def calibrate_rank(spec, seeds, control_seeds, device, rank=0, world=1,
                   init_method=None, hook=None):
    """The readings that the limits are set from: for each seed, the
    program's numbers on ``judge_batches`` batches of the pool drawn from
    the seed (as many as a run compares), and for ``control_seeds`` the
    control's: the reference in TF32 put in the program's place. Rank 0
    returns one row a seed; the others None."""
    device, mesh, _, _, _ = start(spec, device, rank, world, init_method)
    try:
        sess = Session(spec, device, mesh, hook)
        net = ref.Network(str(WEIGHTS), device) if rank == 0 else None
        rows = []
        for seed in seeds:
            pool = render.render_pool(spec.cfg, spec.traffic, seed, device)
            nb = len(pool) // sess.batch
            picks = random.Random(seed).sample(
                range(nb), min(nb, spec.traffic["judge_batches"]))
            sess.release(sess.run_batch(sess.pool_batch(pool, picks[0])))
            keep = [(b, sess.run_batch(sess.pool_batch(pool, b)))
                    for b in picks]
            if rank != 0:
                for _, h in keep:
                    sess.release(h)
                continue
            row = {"seed": seed,
                   "program": judge_kept(spec, device, pool, keep,
                                         sess.batch)}
            for _, h in keep:
                sess.release(h)
            if seed in control_seeds:
                ctl = []
                for b in picks:
                    frames = sess.pool_batch(pool, b).to(device)
                    out = ref.extract(net, frames, spec.cfg, tf32=True)
                    ctl.append((b, {k: v.cpu() for k, v in out.items()}))
                row["control"] = judge_kept(spec, device, pool, ctl,
                                            sess.batch)
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
        return rows if rank == 0 else None
    finally:
        if world > 1:
            dist.destroy_process_group()


def power_limit():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def start(spec, device, rank=0, world=1, init_method=None):
    """The device, float32 as the configuration states (TF32 off in both
    switches), and on several ranks the process group, the mesh, the
    window's agreement (``agreement_path``) and two host collectives: a
    barrier and a gather of objects."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if world == 1:
        return device, None, Agreement(0), None, None
    # the ranks share the host: one intra-op thread each
    torch.set_num_threads(1)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world)
    host_group = dist.new_group(backend="gloo")
    mesh = mesh_mod.make_mesh(world, spec.traffic["mesh"]["data"],
                              device=device)

    def barrier():
        dist.barrier(group=host_group)

    def gather(obj):
        out = [None] * world
        dist.all_gather_object(out, obj, group=host_group)
        return out

    return (device, mesh, Agreement(rank, agreement_path(init_method)),
            barrier, gather)


def agreement_path(init_method: str) -> str:
    """The agreement's file, beside the rendezvous file."""
    return os.path.join(os.path.dirname(init_method[len("file://"):]),
                        "window")


def run_rank(spec, seed, seconds, trace, device, rank=0, world=1,
             init_method=None, hook=None):
    """One rank's run. Rank 0 returns the result; the others None."""
    t_setup = time.perf_counter()
    device, mesh, agree, barrier, gather = start(spec, device, rank, world,
                                           init_method)
    phases = [("start-up and imports", process_age_s())]
    try:
        sess = Session(spec, device, mesh, hook)
        phases.append(("device, weights", process_age_s()))
        pool = render.render_pool(spec.cfg, spec.traffic, seed, device)
        _sync(device)
        phases.append(("traffic rendered", process_age_s()))
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        # warm up the one shape the window runs, twice; a traced run also
        # holds the split to the entry bit for bit on the first batch
        first = sess.run_batch(sess.pool_batch(pool, 0))
        sess.release(sess.run_batch(
            sess.pool_batch(pool, 1 % (len(pool) // sess.batch))))
        split_equal = True
        if trace:
            split = sess.run_batch(sess.pool_batch(pool, 0), Marks(device))
            split_equal = _equal(first, split)
            sess.release(split)
        sess.release(first)
        # the window holds the kept batches and the one in flight
        sess.reserve(spec.traffic["judge_batches"] + 2, first)
        _sync(device)
        if barrier is not None:
            barrier()
        setup_s = process_age_s()
        phases.append(("warm-up, kernels built or loaded", setup_s))
        if rank == 0:
            print("set-up: " + "; ".join(f"{n} at {t!r} s" for n, t in phases),
                  file=sys.stderr)
        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        win = window(sess, pool, seconds, seed, trace, agree, prof)
        _sync(device)
        summary = None
        if prof is not None:
            summary = trace_mod.summarize(prof)
            del prof
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        mine = {"lat": win.lat, "peak": peak, "summary": summary}
        every = gather(mine) if gather else [mine]
        if rank != 0:
            return None
        del sess
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_judge = time.perf_counter()
        nums = judge_kept(spec, device, pool, win.keep, spec.traffic["batch"])
        judge_s = time.perf_counter() - t_judge
        rec = SimpleNamespace(
            cfg=spec.cfg, traffic=spec.traffic, batch=spec.traffic["batch"],
            frames=win.frames, batches=win.batches, window_s=win.window_s,
            lat=_slowest([e["lat"] for e in every]), setup_s=setup_s,
            spans=win.marks.spans_ms() if win.marks else {},
            counts=win.counts, chips=world,
            ranks=[e["summary"] for e in every],
            peaks=json.loads((HERE / "peaks.json").read_text()),
            net_hw=ref.net_size((spec.cfg["frame"]["height"],
                                 spec.cfg["frame"]["width"])))
        return finish(spec, rec, nums, split_equal, trace, device, world,
                      max(e["peak"] for e in every), judge_s,
                      time.perf_counter() - t_setup)
    finally:
        if world > 1:
            dist.destroy_process_group()


def finish(spec, rec, nums, split_equal, trace, device, world, peak,
           judge_s, total_s):
    """The result line's object, with the counts and the checks also on
    standard error."""
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    ok, checks = check(spec, nums)
    if trace:
        checks["split_equal"] = {"value": 0 if split_equal else 1,
                                 "limit": 0}
        ok = ok and split_equal
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": world, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(ok), "attempted": rec.frames, "failed": 0,
           "metrics": metrics, "device": dev}
    if trace and all(rec.ranks):
        dev["busy_s"] = float(np.mean([r["busy_s"] for r in rec.ranks]))
        dev["window_s"] = float(np.mean([r["window_s"] for r in rec.ranks]))
        out["breakdown"] = {"device_ops": rec.ranks[0]["device_ops"],
                            "idle_gaps": rec.ranks[0]["idle_gaps"]}
        for i, r in enumerate(rec.ranks):
            print(f"rank {i}: busy {r['busy_s']!r} s of {r['window_s']!r} s "
                  f"traced, idle share {1 - r['busy_s'] / r['window_s']!r}",
                  file=sys.stderr)
    out["checks"] = checks
    print(f"cell {spec.name}: {kind}, power limit {power_limit()}; "
          f"{rec.batches} batches of {rec.batch}, {rec.window_s!r} s window",
          file=sys.stderr)
    print(f"counts: kpts_per_frame {nums['kpts_per_frame']!r}, "
          f"matches_per_pair {nums['matches_per_pair']!r}", file=sys.stderr)
    print(f"reference check {judge_s!r} s; the run {total_s!r} s after "
          "start-up", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return out


def loaded_forbidden():
    """Modules of JAX or the JAX package loaded in this process, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})

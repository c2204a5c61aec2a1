#!/usr/bin/env python3
"""Where the matcher kernels' device time goes, on one NVIDIA GPU.

Usage: python3 matcher_breakdown.py   (from the repository root, one CUDA
card with nvcc)

Builds variants of ``xfeatslam_tpu_torch/csrc/mnn_pairs.cu``, each made by
a text substitution of the source (the grid always 64-row or always
16-row CTAs; then, one after the other, without the dot products, the
column pass, the col_best decode, the b gathers and the a tile), into
``xfeatslam_tpu_torch/_build/breakdown/``, and times each C entry by
CUDA-graph replay (no host cost) on random unit descriptors with prefix
masks of 124-176 valid slots out of K=1000, as the batched path leaves
them: ``mnn_pairs`` at P=31 and P=255 (batch 32 and 256) and P=1, and
``similarity_top2`` at N=M=1000. A variant without a stage gives wrong
results; only its time is read. Prints one line per variant and shape.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
K = 1000
GRID = "return (long long)P * ((N + 63) / 64) >= 2LL * sms ? 64 : 16;"
DOTS_START, DOTS_END = "switch (min(kGroups", "default: tile_dot<1>"
COLUMN_PASS = "    if constexpr (PAIRS) {\n      // each column's best"
DECODE = "  if constexpr (PAIRS) {\n    // the last CTA"
B_FIRST = ("  if (nrounds > 0) load_tile<NT>(ring, Bm, cols, 0, kRound, nvalid,"
           " tid);\n")
B_NEXT = ("      load_tile<NT>(ring + ((r + 1) & 1) * kRound * kLd, Bm, cols,\n"
          "                    (r + 1) * kRound, kRound, nvalid, tid);\n")
A_TILE = ("  load_tile<NT>(As, a + (size_t)p * N * kD, nullptr, row0, TM, N,"
          " tid);\n")


def substitute(src, old, new):
    if old not in src:
        raise SystemExit(f"matcher_breakdown: {old!r} is no longer in "
                         "mnn_pairs.cu; update the variants")
    return src.replace(old, new)


def variants(src):
    """(name, source) of every variant, the cumulative ones in order."""
    start = src.index(DOTS_START)
    end = src.index("}\n", src.index(DOTS_END, start)) + 2
    no_dots = substitute(src, src[start:end], "for (int i = 0; i < 4; ++i) "
                         "for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;\n")
    out = [("as is", src),
           ("64-row CTAs always", substitute(src, GRID, "return 64;")),
           ("16-row CTAs (8 slices of 32 columns) always",
            substitute(src, GRID, "return 16;")),
           ("no dot products", no_dots)]
    steps = (("and no column pass", COLUMN_PASS,
              COLUMN_PASS.replace("PAIRS", "false")),
             ("and no col_best decode", DECODE, DECODE.replace("PAIRS",
                                                               "false")),
             ("and no b gathers", B_FIRST, ""),
             ("and no a tile", A_TILE, ""))
    cur = no_dots
    for name, old, new in steps:
        cur = substitute(cur, old, new)
        if old == B_FIRST:
            cur = substitute(cur, B_NEXT, "")
        out.append((name, cur))
    return out


def build(named, out_dir):
    """Compile every variant at once; the loaded libraries by name."""
    from xfeatslam_tpu_torch import _build
    from xfeatslam_tpu_torch.ops import cuda_kernels as ck

    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build.find_nvcc()
    jobs = []
    for i, (name, src) in enumerate(named):
        cu = os.path.join(out_dir, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(out_dir, f"libv{i}.so")
        jobs.append((name, so, subprocess.Popen(
            [nvcc, *_build._flags("mnn_pairs"), "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for variant {name!r}:\n{log}")
        lib = ctypes.CDLL(so)
        for fn in ("mnn_pairs", "similarity_top2"):
            getattr(lib, fn).argtypes = ck._ENTRY_POINTS[fn][1]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("matcher_breakdown: needs one CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke

    print(chip_smoke.card_line())
    src_path = os.path.join(REPO, "xfeatslam_tpu_torch", "csrc", "mnn_pairs.cu")
    with open(src_path) as f:
        named = variants(f.read())
    libs = build(named, os.path.join(REPO, "xfeatslam_tpu_torch", "_build",
                                     "breakdown"))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for P in (31, 255, 1):
        d = rng.standard_normal((P + 1, K, 64)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        v = np.arange(K) < rng.integers(124, 177, (P + 1, 1))
        desc, val = torch.tensor(d, device=dev), torch.tensor(v, device=dev)
        a, b, va, vb = desc[:-1], desc[1:], val[:-1], val[1:]
        best = torch.empty((P, K), device=dev)
        second = torch.empty_like(best)
        idx = torch.empty((P, K), dtype=torch.int32, device=dev)
        col = torch.empty_like(idx)
        scratch = torch.zeros(P * K + P, dtype=torch.int64, device=dev)
        zero_ms = chip_smoke.graph_ms(scratch.zero_)
        print(f"P={P}: zeroing the scratch alone {zero_ms * 1e3:.2f} us")
        for name, lib in libs.items():
            def pairs():
                scratch.zero_()
                lib.mnn_pairs(a.data_ptr(), b.data_ptr(), va.data_ptr(),
                              vb.data_ptr(), best.data_ptr(), second.data_ptr(),
                              idx.data_ptr(), col.data_ptr(), scratch.data_ptr(),
                              P, K, K, torch._C._cuda_getCurrentRawStream(
                                  dev.index or 0))

            def top2():
                lib.similarity_top2(a[0].data_ptr(), b[0].data_ptr(),
                                    vb[0].data_ptr(), best.data_ptr(),
                                    second.data_ptr(), idx.data_ptr(), K, K,
                                    torch._C._cuda_getCurrentRawStream(
                                        dev.index or 0))

            line = (f"P={P} [{name}]: mnn_pairs with the zeroing "
                    f"{chip_smoke.graph_ms(pairs) * 1e3:.2f} us")
            if P == 1:
                line += (f"; similarity_top2 "
                         f"{chip_smoke.graph_ms(top2) * 1e3:.2f} us")
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

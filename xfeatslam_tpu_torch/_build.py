"""Build the CUDA kernels in ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C entry point. It is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``_build/`` (listed in ``.gitignore``), named by a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
The library is loaded with ``ctypes``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

KERNELS = ("detect_candidates", "desc_sample", "mnn_pairs")

_BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC"]
# detect_candidates and desc_sample must not contract their position and
# weight arithmetic into FMAs: that moves floor() decisions and
# quantization steps (see the files).
_EXTRA_FLAGS = {"detect_candidates": ["--fmad=false"],
                "desc_sample": ["--fmad=false"]}

_loaded: dict = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """nvcc from PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "xfeatslam_tpu_torch: nvcc not found (looked on PATH, in "
        "$CUDA_HOME/bin and /usr/local/cuda/bin); the CUDA kernels cannot "
        "be built")


def _flags(name: str) -> list:
    return _BASE_FLAGS + _EXTRA_FLAGS.get(name, [])


def library_path(name: str) -> Path:
    """Where the library for the current source of ``name`` lives."""
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _start(name: str, nvcc: str):
    """Start nvcc for ``name`` into a temporary file."""
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *_flags(name), "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build(names=KERNELS) -> None:
    """Compile every out-of-date kernel, all nvcc processes at once."""
    with _lock:
        jobs = {}
        nvcc = None
        try:
            for name in names:
                if library_path(name).exists():
                    continue
                nvcc = nvcc or find_nvcc()
                jobs[name] = _start(name, nvcc)
        finally:
            errors = []
            for name, job in jobs.items():
                try:
                    _finish(name, job)
                except RuntimeError as e:
                    errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                _loaded[name] = lib
    return lib

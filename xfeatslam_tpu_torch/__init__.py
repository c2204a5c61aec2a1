"""PyTorch / CUDA port of xfeatslam_tpu's batched XFeat extract + match path.

The package mirrors ``xfeatslam_tpu``'s layout (``models/``, ``ops/``,
``parallel/``) so each module has an obvious counterpart; the JAX package
stays the numerical reference. Hand-written CUDA kernels for the three
Pallas kernels on this path live in ``csrc/`` and are built with ``nvcc`` at
first use (``_build.py``).

Importing the package has no side effects: it does not import jax, sets no
precision switch and builds nothing. Callers that need float32 parity on the
GPU turn TF32 off themselves (``torch.backends.cudnn.allow_tf32 = False``,
``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device for tensors made from host data: CUDA unless the caller
    names another. Asking for CUDA (explicitly or by default) on a host
    without a GPU raises rather than falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "xfeatslam_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return dev

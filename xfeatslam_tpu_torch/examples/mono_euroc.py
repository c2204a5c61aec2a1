"""Monocular SLAM with the port on an EuRoC sequence or on rendered
frames: the twin of ``examples/mono_euroc.py`` (the body and the layouts are
in ``examples/mono.py`` of this package).

    python -m xfeatslam_tpu_torch.examples.mono_euroc SETTINGS.yaml SEQ_DIR TIMES
    python -m xfeatslam_tpu_torch.examples.mono_euroc --synthetic 18 --out DIR
"""

from __future__ import annotations

from .mono import main as _main


def main(argv=None) -> int:
    return _main(argv, "euroc")


if __name__ == "__main__":
    raise SystemExit(main())

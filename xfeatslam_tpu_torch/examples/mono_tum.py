"""Monocular SLAM with the port on a TUM sequence or on rendered
frames: the twin of ``examples/mono_tum.py`` (the body and the layouts are
in ``examples/mono.py`` of this package).

    python -m xfeatslam_tpu_torch.examples.mono_tum SETTINGS.yaml SEQ_DIR
    python -m xfeatslam_tpu_torch.examples.mono_tum --synthetic 18 --out DIR
"""

from __future__ import annotations

from .mono import main as _main


def main(argv=None) -> int:
    return _main(argv, "tum")


if __name__ == "__main__":
    raise SystemExit(main())

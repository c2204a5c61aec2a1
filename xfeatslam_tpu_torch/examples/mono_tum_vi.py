"""Monocular SLAM with the port on a TUM-VI sequence or on rendered
frames: the twin of ``examples/mono_tum_vi.py`` (the body and the layouts are
in ``examples/mono.py`` of this package).

    python -m xfeatslam_tpu_torch.examples.mono_tum_vi SETTINGS.yaml SEQ_DIR [TIMES]
    python -m xfeatslam_tpu_torch.examples.mono_tum_vi --synthetic 18 --out DIR
"""

from __future__ import annotations

from .mono import main as _main


def main(argv=None) -> int:
    return _main(argv, "tum_vi")


if __name__ == "__main__":
    raise SystemExit(main())

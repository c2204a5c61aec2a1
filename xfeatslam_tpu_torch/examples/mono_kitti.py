"""Monocular SLAM with the port on a KITTI sequence or on rendered
frames: the twin of ``examples/mono_kitti.py`` (the body and the layouts are
in ``examples/mono.py`` of this package).

    python -m xfeatslam_tpu_torch.examples.mono_kitti SETTINGS.yaml SEQ_DIR
    python -m xfeatslam_tpu_torch.examples.mono_kitti --synthetic 18 --out DIR
"""

from __future__ import annotations

from .mono import main as _main


def main(argv=None) -> int:
    return _main(argv, "kitti")


if __name__ == "__main__":
    raise SystemExit(main())

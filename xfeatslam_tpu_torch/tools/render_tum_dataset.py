"""Render the synthetic room sequence to disk in the TUM RGB-D format.

Twin of ``tools/render_tum_dataset.py``, writing its PNGs with the port's
own writer (``utils/png.py``) in place of ``cv2``:

    <out>/rgb/<t>.png          8-bit gray PNGs
    <out>/depth/<t>.png        16-bit PNGs, metres * DepthMapFactor (5000)
    <out>/rgb.txt, depth.txt   `# comments` + `t path` lines; the depth
                               timestamps a few ms after the rgb ones, so
                               association is a nearest-neighbour pairing
    <out>/groundtruth.txt      TUM `t tx ty tz qx qy qz qw` camera-to-world
    <out>/settings.yaml        the renderer's calibration (pinhole, no
                               distortion)

The examples' dataset mode and ``utils/io``'s TUM readers take the
directory as they take a real TUM sequence.

    python -m xfeatslam_tpu_torch.tools.render_tum_dataset OUT --frames 30
"""

from __future__ import annotations

import argparse
import os

import numpy as np

DEPTH_FACTOR = 5000.0
# rgb at i/fps; depth a few ms later (TUM sensors are unsynchronized)
DEPTH_OFFSET = 0.008

SETTINGS_TEMPLATE = """%YAML:1.0
# Auto-written by render_tum_dataset — calibration of the
# synthetic room renderer (pinhole, no distortion). Schema of
# ORB-SLAM3's examples/RGB-D/TUM1.yaml.

File.version: "1.0"
Camera.type: "PinHole"

Camera1.fx: {fx}
Camera1.fy: {fy}
Camera1.cx: {cx}
Camera1.cy: {cy}

Camera.width: {w}
Camera.height: {h}
Camera.fps: {fps}
Camera.RGB: 1

RGBD.DepthMapFactor: {factor}
Stereo.b: 0.07732
Stereo.ThDepth: 40.0

ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def render_tum_dataset(out_dir: str, n_frames: int = 30, seed: int = 0,
                       fps: float = 30.0, period: int = 120,
                       forward_per_frame: float = 0.005) -> str:
    """Write a TUM-format RGB-D dataset directory; returns ``out_dir``."""
    from ..utils import io as io_utils
    from ..utils import png, synthetic

    seq = synthetic.make_sequence(n_frames=n_frames, seed=seed, fps=fps,
                                  period=period,
                                  forward_per_frame=forward_per_frame)
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)

    rgb_lines = ["# color images", "# timestamp filename"]
    depth_lines = ["# depth images", "# timestamp filename"]
    gt_lines = ["# ground truth trajectory (camera-to-world)",
                "# timestamp tx ty tz qx qy qz qw"]
    for i in range(n_frames):
        t_rgb = seq["timestamps"][i]
        t_depth = t_rgb + DEPTH_OFFSET
        rgb_name = f"rgb/{t_rgb:.6f}.png"
        depth_name = f"depth/{t_depth:.6f}.png"
        img = seq["images"][i]
        if img.dtype != np.uint8:
            img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        png.write(os.path.join(out_dir, rgb_name), img)
        depth_u16 = np.clip(seq["depths"][i] * DEPTH_FACTOR,
                            0, 65535).astype(np.uint16)
        png.write(os.path.join(out_dir, depth_name), depth_u16)
        rgb_lines.append(f"{t_rgb:.6f} {rgb_name}")
        depth_lines.append(f"{t_depth:.6f} {depth_name}")
        R, tr = seq["poses"][i]
        Rwc = np.asarray(R).T
        twc = -Rwc @ np.asarray(tr)
        q = io_utils.rotation_to_quat_xyzw(Rwc)
        gt_lines.append(f"{t_rgb:.6f} " +
                        " ".join(f"{v:.6f}" for v in (*twc, *q)))

    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("\n".join(lines) + "\n")

    K = seq["K"]
    h, w = seq["images"][0].shape[:2]
    with open(os.path.join(out_dir, "settings.yaml"), "w") as f:
        f.write(SETTINGS_TEMPLATE.format(
            fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
            cy=float(K[1, 2]), w=w, h=h, fps=fps, factor=DEPTH_FACTOR))
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m xfeatslam_tpu_torch.tools.render_tum_dataset",
        description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--period", type=int, default=120)
    ap.add_argument("--forward-per-frame", type=float, default=0.005)
    args = ap.parse_args(argv)
    render_tum_dataset(args.out, n_frames=args.frames, seed=args.seed,
                       fps=args.fps, period=args.period,
                       forward_per_frame=args.forward_per_frame)
    print(f"wrote {args.frames}-frame TUM-format dataset to {args.out}")


if __name__ == "__main__":
    main()

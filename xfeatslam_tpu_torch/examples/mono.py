"""Monocular SLAM on a dataset sequence, or on the rendered synthetic room,
with the port: the body of the ``mono_tum``, ``mono_kitti``, ``mono_euroc``
and ``mono_tum_vi`` twins of ``examples/mono_*.py``.

Each takes ``SETTINGS.yaml`` and its dataset's layout (below), or
``--synthetic N`` for N rendered frames of ``utils/synthetic.make_sequence``
(TUM1 intrinsics scaled to ``--size``). Frames are read by ``utils/io``
(PNGs decoded by ``utils/png``, no ``cv2``) and tracked with
``System.track_monocular`` (loop closing on unless ``--no-loop``). Writes
``KeyFrameTrajectory.txt`` in TUM format, prints the median and mean
tracking time and, for the synthetic run, the keyframes' ATE against the
rendered truth after a similarity alignment (a monocular map's scale is
arbitrary). The device defaults to CUDA.

  tum     SETTINGS SEQ_DIR                  (SEQ_DIR/rgb.txt)
  kitti   SETTINGS SEQ_DIR                  (image_0/*.png, times.txt)
  euroc   SETTINGS SEQ_DIR TIMES [SEQ_DIR TIMES ...]   (mav0/cam0/data;
          several pairs run back to back in one session, a new map each)
  tum_vi  SETTINGS SEQ_DIR [TIMES]          (mav0/cam0/data)
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

_LAYOUTS = {"tum": "SEQ_DIR", "kitti": "SEQ_DIR",
            "euroc": "SEQ_DIR TIMES [SEQ_DIR TIMES ...]",
            "tum_vi": "SEQ_DIR [TIMES]"}


def _layout_ok(dataset: str, paths) -> bool:
    n = len(paths)
    if dataset == "euroc":
        return n == 1 or (n >= 2 and n % 2 == 0)
    return n in ((1, 2) if dataset == "tum_vi" else (1,))


def _sequences(dataset: str, paths):
    """[(timestamps, image paths)] of the dataset's positional paths."""
    from ..utils import io as io_utils

    if dataset == "tum":
        return [io_utils.load_tum_mono(paths[0])]
    if dataset == "kitti":
        return [io_utils.load_kitti_mono(paths[0])]
    if dataset == "tum_vi":
        return [io_utils.load_tum_vi_mono(*paths)]
    if len(paths) == 1:
        return [io_utils.load_euroc_mono(paths[0])]
    return [io_utils.load_euroc_mono(seq, times)
            for seq, times in zip(paths[0::2], paths[1::2])]


def main(argv, dataset: str) -> int:
    ap = argparse.ArgumentParser(
        prog=f"python -m xfeatslam_tpu_torch.examples.mono_{dataset}",
        description=f"Monocular SLAM on a {dataset} sequence or rendered "
                    "frames")
    ap.add_argument("settings", nargs="?", default=None)
    ap.add_argument("paths", nargs="*", metavar="PATH",
                    help=_LAYOUTS[dataset])
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N rendered frames")
    ap.add_argument("--out", default=".")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--size", default="480x640",
                    help="HxW of the rendered frames")
    ap.add_argument("--features", type=int, default=1000,
                    help="keypoints per rendered frame")
    args = ap.parse_args(argv)

    from ..ops.camera import Pinhole
    from ..slam.settings import Settings
    from ..slam.system import Sensor, System
    from ..utils import io as io_utils
    from ..utils import png, synthetic

    if args.synthetic:
        h, w = (int(v) for v in args.size.lower().split("x"))
        s = w / 640.0
        K = np.array([[517.3 * s, 0, 318.6 * s], [0, 516.5 * s, 255.3 * s],
                      [0, 0, 1]], np.float32)
        seq = synthetic.make_sequence(n_frames=args.synthetic, hw=(h, w),
                                      K=K)
        settings = Settings(
            cam=Pinhole.from_list([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]),
            fps=30.0, n_features=args.features)
        runs = [[(lambda i=i: seq["images"][i], seq["timestamps"][i])
                 for i in range(args.synthetic)]]
    else:
        if args.settings is None or not _layout_ok(dataset, args.paths):
            ap.error(f"provide <settings.yaml> {_LAYOUTS[dataset]} or "
                     "--synthetic N")
        settings = Settings.from_yaml(args.settings)
        runs = [[(lambda p=p: png.read_gray(p), t) for t, p in zip(ts, ps)]
                for ts, ps in _sequences(dataset, args.paths)]

    # float32 convolutions and matmuls, as the JAX package computes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    system = System(settings, Sensor.MONOCULAR,
                    enable_loop_closing=not args.no_loop, device=args.device)
    times = []
    for n_seq, frames in enumerate(runs):
        if n_seq:
            print("Changing the dataset ...")
            system.change_dataset()
        for i, (read, t) in enumerate(frames):
            gray = read()
            t0 = time.perf_counter()
            state, _ = system.track_monocular(gray, t)
            times.append(time.perf_counter() - t0)
            if i % 30 == 0:
                print(f"frame {i}/{len(frames)} state={state.name} "
                      f"kfs={system.map.num_keyframes()} "
                      f"mps={system.map.num_points()}", flush=True)

    # finish an in-flight post-loop GBA before the trajectory is saved
    stats = system.shutdown()
    kf_path = os.path.join(args.out, "KeyFrameTrajectory.txt")
    system.save_keyframe_trajectory_tum(kf_path)
    times = np.array(times)
    print("-------")
    print(f"median tracking time: {np.median(times):.4f}")
    print(f"mean tracking time: {np.mean(times):.4f}")
    print("stats:", stats)
    if args.synthetic:
        est_t, est = io_utils.load_trajectory_tum(kf_path)
        gt_xyz = np.stack([-R.T @ t for (R, t) in seq["poses"]])
        rmse = io_utils.ate_rmse(np.asarray(seq["timestamps"]), gt_xyz,
                                 est_t, est[:, :3], scale=True)
        print(f"keyframe ATE RMSE vs ground truth (similarity-aligned): "
              f"{rmse:.4f} m")
    return 0

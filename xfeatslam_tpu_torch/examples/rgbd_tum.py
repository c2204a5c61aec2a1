"""RGB-D SLAM on a TUM sequence, or on the rendered synthetic room, with
the port.

The port's twin of ``examples/rgbd_tum.py``:

    python -m xfeatslam_tpu_torch.examples.rgbd_tum SETTINGS.yaml SEQ_DIR
        ASSOCIATION.txt [--out DIR] [--no-loop] [--device cpu]
        [--backend xfeat|orb]
    python -m xfeatslam_tpu_torch.examples.rgbd_tum --synthetic 60 --out DIR
        [--device cpu] [--size 480x640] [--features 1000] [--no-loop]
        [--backend xfeat|orb]

The dataset mode reads the settings with ``Settings.from_yaml`` and the
frames through ``utils/io.load_tum_association`` (PNGs decoded by
``utils/png``, no ``cv2``). The synthetic mode renders N frames of
``utils/synthetic.make_sequence`` (TUM1 intrinsics scaled to the size) and
prints the ATE against the rendered truth. Either tracks with
``System.track_rgbd`` (loop closing on unless ``--no-loop``), writes
``CameraTrajectory.txt`` and ``KeyFrameTrajectory.txt`` in TUM format and
prints the median and mean tracking time. The device defaults to CUDA; the
feature backend to ORB when ``USE_ORB`` is set, else XFeat.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("settings", nargs="?", default=None)
    ap.add_argument("sequence", nargs="?", default=None)
    ap.add_argument("association", nargs="?", default=None)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N rendered frames")
    ap.add_argument("--out", default=".")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--size", default="480x640", help="HxW of the frames")
    ap.add_argument("--features", type=int, default=1000,
                    help="keypoints per frame (ORBextractor.nFeatures)")
    ap.add_argument("--backend", default=None, choices=["xfeat", "orb"],
                    help="feature backend (default: orb when the USE_ORB "
                    "environment variable is set, else xfeat)")
    args = ap.parse_args(argv)
    if not args.synthetic and None in (args.settings, args.sequence,
                                       args.association):
        ap.error("provide <settings.yaml> <sequence_dir> <association_file>"
                 " or --synthetic N")

    from ..ops.camera import Pinhole
    from ..slam.settings import Settings
    from ..slam.system import Sensor, System
    from ..utils import io as io_utils
    from ..utils import synthetic

    # float32 convolutions and matmuls, as the JAX package computes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.synthetic:
        h, w = (int(v) for v in args.size.lower().split("x"))
        s = w / 640.0
        K = np.array([[517.3 * s, 0, 318.6 * s], [0, 516.5 * s, 255.3 * s],
                      [0, 0, 1]], np.float32)
        seq = synthetic.make_sequence(n_frames=args.synthetic, hw=(h, w),
                                      K=K)
        settings = Settings(
            cam=Pinhole.from_list([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]),
            bf=40.0 * s, th_depth=7.0, depth_map_factor=1.0, fps=30.0,
            n_features=args.features)
        n = args.synthetic

        def frame(i):
            return seq["images"][i], seq["depths"][i], seq["timestamps"][i]
    else:
        settings = Settings.from_yaml(args.settings)
        data = io_utils.load_tum_association(args.sequence, args.association)
        n, frame = len(data), data.read
    os.makedirs(args.out, exist_ok=True)
    system = System(settings, Sensor.RGBD, backend=args.backend,
                    enable_loop_closing=not args.no_loop, device=args.device)

    times = []
    for i in range(n):
        gray, depth, t = frame(i)
        t0 = time.perf_counter()
        state, _ = system.track_rgbd(gray, depth, t)
        times.append(time.perf_counter() - t0)
        if i % 30 == 0:
            print(f"frame {i}/{n} state={state.name} "
                  f"kfs={system.map.num_keyframes()} "
                  f"mps={system.map.num_points()}", flush=True)

    # finish an in-flight post-loop GBA before the trajectories are saved
    stats = system.shutdown()
    cam_path = os.path.join(args.out, "CameraTrajectory.txt")
    system.save_trajectory_tum(cam_path)
    system.save_keyframe_trajectory_tum(
        os.path.join(args.out, "KeyFrameTrajectory.txt"))
    times = np.array(times)
    print("-------")
    print(f"median tracking time: {np.median(times):.4f}")
    print(f"mean tracking time: {np.mean(times):.4f}")
    print("stats:", stats)
    if not args.synthetic:
        return 0
    est_t, est = io_utils.load_trajectory_tum(cam_path)
    gt_xyz = np.stack([-R.T @ t for (R, t) in seq["poses"]])
    rmse = io_utils.ate_rmse(np.asarray(seq["timestamps"]), gt_xyz, est_t,
                             est[:, :3])
    print(f"ATE RMSE vs ground truth: {rmse:.4f} m")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

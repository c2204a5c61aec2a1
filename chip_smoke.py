#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU.

Usage: python3 chip_smoke.py [--batch N]   (from the repository root, one
CUDA card; the batch defaults to 32)

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
     TF32 off for float32 parity;
  2. build every CUDA kernel of ``xfeatslam_tpu_torch/csrc`` with nvcc;
  3. the batched path once with the launch counters zeroed just before:
     ``extract_batch`` + ``match_consecutive`` on a batch of frames at 640x480,
     K=1000, float32, the shipped weights; each of its kernels
     (``detect_candidates``, ``keypoint_desc``, ``mutual_nn_pairs``) must
     have launched exactly once;
  4. each kernel against its plain PyTorch version on the tensors of that
     run and at odd shapes: ``detect_candidates`` bit for bit on every slot,
     also on frame 0 alone (batch 1), at a ragged strip, a width that is no
     multiple of the column split and on a lattice of 4-9 survivors per
     cell, each with its launch's grid; ``keypoint_desc`` with ``subpixel``
     both ways; the descriptors-at-keypoints path
     (``detect.sample_descriptors``, ``bilinear_desc_sample``), counted; one
     call of the extraction wrappers under
     ``torch.cuda.set_sync_debug_mode("error")``; the two matcher kernels
     also on inputs full of exact ties (duplicated columns, duplicated
     rows, valid all-zero rows, prefix masks, all-valid masks), where the
     first index must win, at
     P=31 and P=1, M=4096, N=1 and M=1, each with its launch's CTA count;
     one call of each matcher wrapper under
     ``torch.cuda.set_sync_debug_mode("error")``; the whole path against the
     plain path on the same card;
  5. ``XFeatExtractor()`` on one 500x700 uint8 frame (resize, sub-pixel
     selection, coordinate rescale);
  6. the single-pair matcher path, counted: ``match_consecutive(fused=False)``
     (``match_mutual_nn`` pair by pair through ``similarity_top2``) against the
     batched matcher; ``match_mutual_nn`` fused against unfused; the kernel
     against its plain version on frames 0 and 1 and at odd shapes;
  7. the online RGB-D frame step: 6 synthetic frames at 640x480 (TUM1
     intrinsics), a map back-projected from frame 0 (stage 1: M1=1000
     slots, stage 2: a 4096-row local map), ``xfeat_rgbd_frame_step`` on
     frames 1-5, counted per frame, held to the ground truth (< 1 cm) and to
     the plain-kernel path; the same frames by replay of the step's CUDA
     graph (``track_step.RgbdFrameStepGraph``), bit for bit against the
     eager step, with one ``detect_candidates``, one ``keypoint_desc`` and
     two ``pose_lm`` (one per tracking stage) recorded at capture; the
     monocular configuration once; no host sync inside a step
     (``torch.cuda.set_sync_debug_mode``); the ``pose_lm`` kernel against
     its plain version on both stages' inputs of frames 1-5 and on odd
     inputs (no valid edge, all mono with bf 0, 30% outliers, N=999,
     N=2048, the largest N it takes; one N more refused): R and t within
     1e-4, inlier flags equal on >= 0.99 of the valid slots, two calls bit
     for bit;
  8. the RGB-D SLAM host, counted (the frame step's kernels and
     ``local_ba``, local mapping's rounds by replay): ``System.track_rgbd`` (loop closing
     on; no loop may close) on 40 rendered frames at 640x480, K=1000, the shipped weights, run
     three times in one process, each held to the JAX package's 40-frame
     bars (every frame OK, camera centre within 3 cm everywhere and 1 cm
     at the median), at least 30 frames through the captured step, runs 2
     and 3 bit-identical to run 1 (every pose, the saved trajectory, the
     keyframe and map-point counts); the host wall time per frame, the
     ``track`` and ``backend`` spans, local BA per round by graph replay,
     the map's size (run 2); the device's busy share over frames 2-39 from
     a ``torch.profiler`` pass over run 3;
  9. relocalization, counted: the tracker set LOST takes frame 0 later
     and comes back OK within 1 cm; frame 0 again arrives RECENTLY_LOST with
     the motion model and reference keyframe made to fail and relocalizes
     too; the tracker set LOST takes frame 1, which no keyframe was made
     from, and comes back OK within 1 cm; each leaves the map as it was;
     then localization mode, counted: frames 2-6 OK with the map's
     keyframe and point counts unchanged; the ``pose_lm`` kernel against its
     plain version on every pose-LM call the relocalizations made;
 10. loop closing on ``bench.py --mode loop``'s workload at its size (the
     40-keyframe drifted RGB-D chain of ``utils/synthetic.make_loop_map``):
     at least one closure, the ATE RMSE after below the RMSE before and
     within 1.25x of the JAX package's CPU result on the same map; host ms
     per keyframe; the GBA's last problem eager and by replay, bit for
     bit, timed, with its device events, and the ``local_ba`` kernels
     against their plain twin on it; the atlas through
     ``System.save_atlas`` and ``load_atlas``: keyframes, points, poses and
     the retrieval index equal;
 10b. monocular SLAM, counted: ``System.track_monocular`` on 18 rendered
     frames (640x480, K=1000, loop closing off): the initializer succeeds
     with its global BA through the ``local_ba`` kernels (held to their
     plain twin on the GBA's problem), the last frame
     OK and at least 12 OK, at least 2 keyframes, at least 8 frames
     through the captured step; per-frame states and wall, and the
     keyframe trajectory's ATE after a similarity alignment;
 10c. the dataset readers: a TUM-layout sequence written here (PNGs by
     ``write_png``, every scanline filter, two IDAT chunks; rgb.txt,
     depth.txt, an association file, an OpenCV-YAML settings file), read
     back equal, then ``examples/rgbd_tum`` in its dataset mode (every
     pose written, within 1 cm of the truth) and the ``mono_tum`` twin (at
     least 2 keyframes written);
 11. local BA (``optim/local_ba``, the ``local_ba`` kernels of
     ``csrc/local_ba.cu``) at the bucket's shapes (32 cameras, 4096
     points, 16384 observations) on the SLAM run's last first-stage
     problem and on a full bucket, for both schedules local mapping runs:
     launches per solve from the wrapper's counter (one: a persistent
     cooperative launch) and ``torch.profiler`` (at most 8 device events
     for a (5, 0) round); two eager solves bit-identical,
     the ``LocalBAGraph`` replay bit-identical to the eager solve; eager,
     capture and replay ms, the plain twin's ms; the kernels' solve
     against the plain twin on the card and against the CPU's solve;
 12. CUDA-event timings of the forward, each kernel and its plain version
     (detect also at batch 1), the top-k, a PyTorch yardstick call where one
     computes the same function, the stages of one batch
     (``match_consecutive`` both ways) and the end-to-end frame rate; the
     kernels', the top-k's and the matchers' yardsticks' device time alone,
     by CUDA-graph replay; the frame step per frame eager and by graph
     replay, its parts, its host wall time and its CUDA kernel count
     (``torch.profiler``); ``pose_lm`` alone, by CUDA events and by graph
     replay, its plain version and its bounds;
 13. the ORB backend: the quadtree built by g++; ``ORBExtractor`` on the
     card against the port's CPU run of one rendered 640x480 frame
     (level-0 candidates with their order and their quadtree selection
     equal, per-level keypoint Jaccard and descriptor bits at
     tests/test_torch_orb.py's bars; the levels ``orb_fast`` builds equal
     the CPU's resize), each stage's graph replay bit for bit against its
     eager call; the two ORB kernels (``orb_fast``, ``orb_describe``)
     against their plain twins on the frame and its keypoints
     (``orb_fast`` bit for bit at every level: the level
     images, scores, survivors and counts; ``orb_describe`` level 0
     exact, angles and bits, the other levels' angles within 1e-4 rad and
     >= 0.999 of the bits) and at odd shapes (levels narrower than a tile,
     a portrait frame, corners on the wrap seam, halos wrapped on both
     axes and more than once; keypoints at the corners, 15 px from them,
     padding slots), one launch of each per extractor call, their times,
     the twins', the moment convolutions' and the bounds; the stages' times and device events beside those of the
     stages that resized the levels themselves (commit 5e60de8);
     ``System(backend="orb").track_rgbd`` at the JAX package's ORB bars (14
     frames, loop closing off: < 1 cm max, < 5 mm median; 40 frames, loop
     closing on, twice, counted: every frame OK, < 3 cm, >= 3 keyframes,
     the second run bit-identical to the first, pose_lm 2 per
     graph-tracked frame, local_ba 1 per round, no XFeat kernel); on that
     run's System relocalization and localization mode as in phase 9 (frame
     0 fed LOST, then RECENTLY_LOST with the motion model and reference
     keyframe made to fail, then frame 1 fed LOST: each OK within 1 cm, the
     map unchanged, the pose LM against its plain version on every
     relocalization call; frames 2-6 in localization mode OK, the map
     unchanged; counted: orb_fast, orb_describe, pose_lm); the
     readers phase's TUM directory through ``rgbd_tum --backend orb``
     (within 1 cm) and ``mono_tum --backend orb`` (>= 1 keyframe);
 14. XFeat stereo, counted: ``System(Sensor.STEREO).track_stereo`` on the
     JAX package's 10 rendered pairs (640x480, K=1000, right view 8 cm
     along +x) twice, at its test_xfeat_stereo_single_dispatch bars (>=
     8 OK, < 8 cm, >= 6 pairs through ``StereoFrameStepGraph``), the runs
     bit-identical; the step's graph records one detect_candidates, one
     keypoint_desc and two pose_lm; the last step by replay bit for bit
     against the eager step and held to the plain kernels; wall and spans;
 15. ORB stereo, counted: ``System(Sensor.STEREO, backend="orb")`` on 8
     pairs twice at test_stereo_tracks' bars, the runs bit-identical, two
     orb_fast and two orb_describe launches per pair;
 16. fisheye: ``build_stereo_fisheye`` on tests/test_fisheye.py's 512x512
     KB8 rig (>= 100 keypoints with depth, median error < 5%); the XFeat
     RGB-D System through a KB8 camera on 8 rendered 384x288 frames, counted
     (every frame OK, < 5 cm, none through the pinhole frame step);
 17. rectification without cv2: the host ms of an EuRoC-style rig's
     ``precompute_rectification`` and of ``rectify`` per 752x480 pair;
 18. visual-inertial RGB-D, ``System(Sensor.IMU_RGBD)``: the ORB System
     on tests/test_inertial_slam.py::TestImuRgbd's run (60 frames of
     ``make_vi_sequence`` at 640x480, 10 fps, 200 Hz IMU, its injected
     biases and noise, its Settings) twice, counted (orb_fast and
     orb_describe; pose_lm and local_ba before IMU initialization), each
     held to TestImuRgbd's bars (IMU initialized with VIBA1 and VIBA2,
     gravity within 0.35, >= 6 keyframes, scale within 0.03, ATE max
     < 5 cm, the last 3 keyframes' velocities within 0.08 m/s, biases
     within 2e-3 and 4e-2, every frame from 1 OK), run 2 (replaying run
     1's graphs) bit-identical to run 1; its wall median and p90, the
     ``track`` and ``backend`` spans, the launches per frame; the run's
     atlas saved and loaded (every keyframe's velocity, biases, chain link
     and preintegration, the map's IMU flags and biases equal); the XFeat
     System on the same run once (IMU initialized, every frame from 1 OK,
     detect_candidates and keypoint_desc once per frame; its figures
     printed without bars); each inertial
     solver (``preintegrate``, both inertial pose LMs, ``inertial_init``,
     ``local_inertial_ba`` on the window and the full chain) on the card
     against the same function on CPU tensors, on run 1's recorded inputs,
     at the CPU tests' bars, with its eager ms, capture wall ms, replay ms,
     device events per call and bound; the 4-DoF essential graph on a
     12-keyframe loop, card against CPU within 1e-4;
 19. visual-inertial monocular and stereo: ``System(Sensor.IMU_MONOCULAR)``
     on tests/test_inertial_slam.py::TestImuMonocular's run (the same 60
     frames and Settings) and ``System(Sensor.IMU_STEREO)`` on
     TestImuStereo's (50 pairs, each right view rendered 8 cm along camera
     +x, bf = 0.08 fx), ORB twice each, counted (from run 2 exactly one
     orb_fast and one orb_describe an image), held to their bars
     (initialized, >= 6 keyframes; scale within 0.08 / 0.03, ATE max
     < 8 / 6 cm, gravity within 0.5 / 0.4), run 2 bit-identical; the
     monocular run 2's wall, spans and launches per frame; the XFeat
     stereo System once (initialized, every pair from 1 OK, two
     detect_candidates and two keypoint_desc a pair; figures without
     bars); the new solver calls card against CPU at the CPU tests' bars:
     the scale-free first ``inertial_init`` and the scale refinement of
     the monocular run 1, and ``merge_inertial_ba``'s 24-slot solve on
     TestMergeInertialBA's welded 13-keyframe scene, built on the card
     (err1 < 0.5 err0); where a float32 LM decision differs, the fields it
     moves are held to the JAX tests' bars; the phase's time.

Prints ``kernels: {...}`` with each path's launch counts, one JSON line
``{"kernels": [...]}`` with each kernel's numbers (``orb_launches``, the
launches on the ORB RGB-D path, on ``pose_lm``, ``local_ba`` and the two
ORB kernels, whose ``launches`` are the ORB stereo path's;
``stereo_launches`` on the XFeat stereo path's kernels;
``imu_rgbd_launches`` on the ORB IMU_RGBD path's; ``imu_mono_launches``
on the ORB IMU_MONOCULAR path's, ``imu_stereo_launches`` on the ORB
IMU_STEREO path's (its run 2) and ``imu_stereo_xfeat_launches`` on the
XFeat IMU_STEREO path's, each from its own run with the counts reset just
before it), the script's time, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
no CUDA device is available or the package is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
H, W, K = 480, 640, 1000
# NVIDIA H100 SXM data sheet: HBM bandwidth and the float32 rate of the
# CUDA cores (no tensor cores), both at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# float ops per pixel of the detect post-processing, counted from the
# algorithm at its least: softmax ~6 (per logit: scale, max, sub, exp, sum,
# div), separable 5x5 NMS 10, reliability bilinear ~8, score 2, 3x3
# soft-argmax with quantize and pack ~25, per-cell top-9 selection ~18.
DETECT_OPS_PER_PIXEL = 70
KERNEL_SOURCES = {
    "detect_candidates": ("xfeatslam_tpu_torch/csrc/detect_candidates.cu",
                          "xfeatslam_tpu/ops/pallas_kernels.py:375"),
    "bilinear_desc_sample": ("xfeatslam_tpu_torch/csrc/desc_sample.cu",
                             "xfeatslam_tpu/ops/pallas_kernels.py:505"),
    "keypoint_desc": ("xfeatslam_tpu_torch/csrc/desc_sample.cu",
                      "xfeatslam_tpu/ops/pallas_kernels.py:505"),
    "mutual_nn_pairs": ("xfeatslam_tpu_torch/csrc/mnn_pairs.cu",
                        "xfeatslam_tpu/ops/pallas_kernels.py:596"),
    "similarity_top2": ("xfeatslam_tpu_torch/csrc/mnn_pairs.cu",
                        "xfeatslam_tpu/ops/pallas_kernels.py:84"),
    "pose_lm": ("xfeatslam_tpu_torch/csrc/pose_lm.cu",
                "xfeatslam_tpu/optim/pose_opt.py:82 (XLA, not Pallas)"),
    "local_ba": ("xfeatslam_tpu_torch/csrc/local_ba.cu",
                 "xfeatslam_tpu/optim/local_ba.py:102 (XLA, not Pallas)"),
    "orb_fast": ("xfeatslam_tpu_torch/csrc/orb_fast.cu",
                 "xfeatslam_tpu/models/orb.py:93 (XLA, not Pallas)"),
    "orb_describe": ("xfeatslam_tpu_torch/csrc/orb_describe.cu",
                     "xfeatslam_tpu/models/orb.py:148 (XLA, not Pallas)"),
}
# a (5, 0) local-BA round must stay at this many kernel launches (it was
# ~16,429 as tensor ops and 431 as a kernel sequence; one persistent
# cooperative launch makes it 1)
LOCAL_BA_MAX_LAUNCHES = 1
# float ops per valid observation of the BA solver, counted from the
# algorithm at its least: per CG step the residual's product J v once (27
# MACs) and J^T of it on both sides (18 + 9 MACs), 108 in all; per LM
# iteration the linearization (~150), the normal equations' sums (~220)
# and one trial-cost pass (~40)
LOCAL_BA_OPS_PER_OBS_CG_STEP = 108
LOCAL_BA_OPS_PER_OBS_LM_ITER = 410
# the kernels each path must launch
BATCHED_KERNELS = {"detect_candidates": 1, "keypoint_desc": 1,
                   "mutual_nn_pairs": 1}
# the kernels of one frame step and their launches: the pose LM once per
# tracking stage
FRAME_STEP_KERNELS = {"detect_candidates": 1, "keypoint_desc": 1,
                      "pose_lm": 2}
# the online frame step: TrackerConfig's XFeat defaults (slam/tracking.py)
# and the local-map bucket
M1, M2 = 1000, 4096
BF, DEPTH_EDGE_REL, INV_SIGMA2 = 40.0, 0.05, 1.0
RADIUS_MOTION, RADIUS_LOCAL, TH_HIGH, RATIO = 15.0, 10.0, 1000.0, 0.9
WIDEN_BELOW, SCALE_FACTOR = 20, 1.2
N_FRAMES = 6
# the SLAM host's kernels: the frame step's, and local BA's by replay
SLAM_KERNELS = {**{name: None for name in FRAME_STEP_KERNELS},
                "local_ba": None}
# frames of the SLAM phase (the 40-frame bars of the JAX package's
# test_slam_integration.py)
SLAM_FRAMES, SLAM_MIN_CAPTURED = 40, 30
# the loop phase's bar on bench.py's loop workload. The reference schedule's
# last GBA (20 LM iterations) stops short of convergence, so the ATE RMSE it
# leaves moves by tens of percent with the RANSAC draws and the float32
# rounding of earlier stages (PERF.md): the JAX package's CPU run leaves
# 6.35441892882227e-06 m there (`JAX_PLATFORMS=cpu python bench.py --mode
# loop` reports it as 0.001 cm), printed beside the card's figure for
# information. The bar holds the figure after LOOP_EXTRA_GBAS further inline
# GBAs of the final map within LOOP_RMSE_FACTOR of the JAX package's own CPU
# figure after the same GBAs on the same map, as the `slow` test
# tests/test_torch_loop_closing.py::test_bench_loop_chain_matches_jax
# prints it
JAX_LOOP_RMSE_AFTER = 6.35441892882227e-06
JAX_LOOP_RMSE_CONVERGED = 2.669299647095613e-06
LOOP_EXTRA_GBAS = 3
LOOP_RMSE_FACTOR = 1.25
# the frames the relocalization phase feeds a lost tracker. RELOC_FRAME is
# the view of the map's origin keyframe, which relocalizes within 1 cm
# under every RANSAC seed tried (test_torch_slam_system.py's 40-frame
# comparison prints the scan). RELOC_OTHER_FRAME is a view no keyframe was
# made from (the run's keyframes come from frames 0, 3, 9, 36 and 39) that
# relocalizes under the draws of its frame id here, 42: of frames 1-34
# at frame id 42 on the card, frames 1, 2, 4, 7, 8, 11, 12, 22, 25, 30, 32
# and 34 relocalize (frame 1 at 4.06 mm), the others fail, as later frames
# do on some seeds only in the JAX package
RELOC_FRAME, RELOC_OTHER_FRAME = 0, 1
# the monocular phase: JAX's test_xfeat_mono_tracks_single_dispatch at
# 640x480, K=1000, and its bars
MONO_FRAMES, MONO_MIN_OK, MONO_MIN_CAPTURED = 18, 12, 8
# frames the readers phase writes as a TUM sequence
READER_FRAMES = 12
# the ORB phase: the JAX package's ORB tests' frame counts
# (test_slam_integration.py), the frames of the 40 that must go through
# the tracking stages' graph, the per-level keypoint Jaccard of
# tests/test_torch_orb.py, and the SLAM path's kernels
ORB_FRAMES_SHORT, ORB_FRAMES_LONG, ORB_MIN_TRACKED = 14, 40, 30
ORB_LEVEL_JACCARD = 0.95
ORB_SLAM_KERNELS = {"pose_lm": None, "local_ba": None, "orb_fast": None,
                    "orb_describe": None}
# an ORB frame's kernels outside the SLAM runs: the extractor's two and the
# pose LM
ORB_FRAME_KERNELS = {"orb_fast": None, "orb_describe": None,
                     "pose_lm": None}
# the ORB stages by replay as tensor ops, before their kernels (PERF.md,
# NVIDIA H100 80GB HBM3 at 700 W): candidates ms and device events,
# describe ms and device events
TENSOR_OPS_CANDIDATES, TENSOR_OPS_DESCRIBE = (4.9074, 1857), (3.8532, 435)
# the same stages by replay at commit 5e60de8, each stage resizing the
# levels with JAX's weights and order (a kernel a tap) before its ORB
# kernel and the describe stage blurring them by cuDNN (PERF.md, on NVIDIA
# H100 80GB HBM3 at 700 W): ms and device events
RESIZING_CANDIDATES, RESIZING_DESCRIBE = (1.6695, 592), (0.6857, 122)
# the card's float64 rate outside the tensor cores (NVIDIA H100 SXM data
# sheet, 700 W), for the resize's and the blur's float64 sums
PEAK_F64_FLOPS = 34e12
# float ops of the ORB kernels, counted from the algorithm at its least:
# orb_fast per level pixel 16 differences and absolutes, then per
# threshold p +- t, 32 compares, 16 adds, the two run-of-9 tests (~36),
# the select, 8 suppression compares and the border (~99 each), float32;
# and the resize's taps, a float64 multiply and add each (orb_fast_work);
# orb_describe per distinct keypoint position the 709-pixel disc's moments
# (3 float64 ops a pixel), per valid slot the rotation of each distinct
# sample (4 products, 2 sums, 2 roundings, 2 offsets, 4 clamps) and the
# 256 compares, float32, and the 7x7 blur at each distinct sample position
# after the rotation (49 float64 multiply-adds, 98 ops; orb_describe_work)
ORB_FAST_OPS_PER_PIXEL = 230
ORB_DESCRIBE_OPS_PER_SAMPLE = 14
ORB_DISC_OPS_PER_POSITION = 3 * 709
ORB_BLUR_OPS_PER_SAMPLE = 98
# the stereo phases: the JAX package's TestStereoSlam rig (the rendered
# room, the right view 8 cm along +x) and frame counts, and its bars
STEREO_BASELINE, STEREO_FRAMES, ORB_STEREO_FRAMES = 0.08, 10, 8
STEREO_KERNELS = {"detect_candidates": None, "keypoint_desc": None,
                  "pose_lm": None}
ORB_STEREO_KERNELS = {"pose_lm": None, "orb_fast": None,
                      "orb_describe": None}
# tests/test_fisheye.py's rig: two KB8 cameras (EuRoC / TUM-VI-like),
# camera 2 11 cm to the right with a 0.02 rad yaw, 512x512
FISHEYE_KB1 = [190.98, 190.97, 254.93, 256.9, 0.0034823894, 0.0007150348,
               -0.0020532361, 0.00020293673]
FISHEYE_KB2 = [190.44, 190.44, 252.59, 254.65, 0.0034003171, 0.0007233193,
               -0.0020532361, 0.00020293673]
FISHEYE_HW = (512, 512)
# tests/test_torch_slam_fisheye.py's camera: TUM-VI's KB8 distortion on a
# 384x288 image, the System tracking through it over 8 rendered RGB-D
# frames (the port's CPU run and the JAX System's both read 23.1 mm at
# most against the truth: the optimizers project through fx, fy, cx, cy)
FISHEYE_TRACK_KB8 = [230.0, 230.0, 191.5, 143.5, 0.0034823894,
                     0.0007150348, -0.0020532361, 0.00020293673]
FISHEYE_TRACK_HW, FISHEYE_TRACK_FRAMES = (288, 384), 8
# tests/test_settings.py::TestStereoRectification's EuRoC-style rig
EUROC_STEREO_YAML = """%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: 458.654
Camera1.fy: 457.296
Camera1.cx: 367.215
Camera1.cy: 248.375
Camera1.k1: -0.28340811
Camera1.k2: 0.07395907
Camera1.p1: 0.00019359
Camera1.p2: 1.76187114e-05
Camera2.fx: 457.587
Camera2.fy: 456.134
Camera2.cx: 379.999
Camera2.cy: 255.238
Camera2.k1: -0.28368365
Camera2.k2: 0.07451284
Camera2.p1: -0.00010473
Camera2.p2: -3.55590700e-05
Stereo.ThDepth: 35.0
Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [1.0, 0.0, 0.0, 0.11, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0,
         0.0, 0.0, 0.0, 1.0]
Camera.width: 752
Camera.height: 480
Camera.fps: 20
Camera.RGB: 1
ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def make_images(n):
    """A copy of bench.make_images: smooth pattern plus 40 Gaussian blobs."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    imgs = []
    for i in range(n):
        img = 0.5 + 0.3 * np.sin(xx / 21 + i) * np.cos(yy / 17 - i)
        for _ in range(40):
            cy, cx = rng.uniform(20, H - 20), rng.uniform(20, W - 20)
            img += 0.4 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 25.0)
        imgs.append(np.clip(img, 0, 1).astype(np.float32))
    return np.stack(imgs)[..., None]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=20, replays=10):
    """Device time of one call of ``fn`` in ms, with no host cost in it:
    ``calls`` calls captured in a CUDA graph, replayed ``replays`` times
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    from xfeatslam_tpu_torch.optim.track_step import gc_paused

    graph = torch.cuda.CUDAGraph()
    with gc_paused(), torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def bound_ms(nbytes, flops, flops64=0):
    """The least time for the work: bytes over HBM rate or the operations
    (float32 ops over the CUDA-core peak plus float64 ops over the float64
    peak), whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_F32_FLOPS + flops64 / PEAK_F64_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def plain_kernels(ck):
    """Route the wrappers to their plain versions, for the plain path."""
    names = tuple(KERNEL_SOURCES)
    saved = {n: getattr(ck, n) for n in names}
    try:
        for n in names:
            setattr(ck, n, getattr(ck, n + "_plain"))
        yield
    finally:
        for n, f in saved.items():
            setattr(ck, n, f)


def jaccard(a, b):
    return len(a & b) / max(len(a | b), 1)


def pixel_set(kpts, valid):
    return {tuple(p) for p in kpts[valid].round().astype(np.int64)}


def pair_set(kpts, idx, b):
    return {(tuple(kpts[b, i].round().astype(np.int64)),
             tuple(kpts[b + 1, j].round().astype(np.int64)))
            for i, j in enumerate(idx[b]) if j >= 0}


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    if smi.returncode != 0 or not smi.stdout.strip():
        return f"nvidia-smi failed: {smi.stderr.strip()}"
    return smi.stdout.strip().splitlines()[0]


def detect_note(ck, B, H8, W8):
    ctas, S, parts = ck.detect_grid(
        B, H8, W8, torch.cuda.get_device_properties(0).multi_processor_count)
    return f"{ctas} CTAs of {S} cell rows x {-(-W8 // parts)} cell columns"


def compare_detect(ck, logits, heat, nc, label):
    """detect_candidates kernel vs plain on every slot: vals equal, aux
    equal (channel and both quantized offsets), so the survivor mask too;
    the whole tensors must be bit-identical."""
    vk, ak = ck.detect_candidates(logits, heat, nc=nc)
    vp, ap = ck.detect_candidates_plain(logits, heat, nc=nc)
    sk, sp = vk > -1, vp > -1
    check(bool(sp.any()), f"detect [{label}]: no survivor to compare")
    mask_agree = float((sk == sp).float().mean())
    err = float((vk - vp).abs().max())
    aux_agree = float((ak == ap).float().mean())
    per_cell = (vp > -1).sum(2).max()
    print(f"detect [{label}; {detect_note(ck, *logits.shape[:3])}]: on all "
          f"{vk.numel()} slots survivor mask agreement {mask_agree:.6f}, vals "
          f"max abs err {err:.3e}, aux agreement {aux_agree:.6f}; "
          f"{int(sp.sum())} survivors, at most {int(per_cell)} in a cell")
    check(torch.equal(vk, vp) and torch.equal(ak, ap),
          f"detect [{label}]: candidates differ from the plain version")
    return {"max_abs_err": err}


def compare_kpdesc(ck, feats_flat, vals, aux, k, subpixel, label):
    """keypoint_desc kernel vs plain on the top-k of the candidates ``vals``:
    kpts within 1e-6, desc within 1e-5 on valid rows, invalid rows exactly
    zero."""
    B, H8, _, W8 = vals.shape
    scores, sel = torch.topk(vals.reshape(B, -1), k, dim=1)
    kk, dk = ck.keypoint_desc(feats_flat, scores, sel, aux, W8, subpixel)
    kp, dp = ck.keypoint_desc_plain(feats_flat, scores, sel, aux, W8, subpixel)
    v = scores > 0
    check(bool(v.any()), f"kpdesc [{label}]: no valid keypoint")
    kerr = float((kk - kp).abs().max())
    derr = float((dk - dp).abs()[v].max())
    print(f"kpdesc [{label}, subpixel={subpixel}]: kpts max abs err "
          f"{kerr:.3e} ({'bit-identical' if torch.equal(kk, kp) else 'not bit-identical'}), "
          f"desc max abs err {derr:.3e} over {int(v.sum())} valid of "
          f"{v.numel()} rows")
    check(kerr <= 1e-6, f"kpdesc [{label}]: kpts differ by more than 1e-6")
    check(derr <= 1e-5, f"kpdesc [{label}]: desc differ by more than 1e-5")
    check(bool((dk[~v] == 0).all()), f"kpdesc [{label}]: invalid rows not zero")
    return {"max_abs_err": max(kerr, derr)}


def lattice_inputs(rng, B, H8, W8):
    """Peaks on a lattice of pitch 3 px (each the 5x5 maximum), so cells
    hold 4-9 survivors: arg-max rounds past 4 and the rank fill both run.
    Every other cell's peaks have equal logits (exact score ties, ordered
    by aux), the rest jittered ones."""
    logits = np.full((B, H8, W8, 65), -8.0, np.float32)
    y, x = np.mgrid[0:H8 * 8:3, 0:W8 * 8:3]
    cy, cx, ch = y // 8, x // 8, (y % 8) * 8 + x % 8
    peak = np.where((cy + cx) % 2 == 0, 4.0,
                    4.0 + rng.uniform(0, 1, (B,) + y.shape)).astype(np.float32)
    for b in range(B):
        logits[b, cy, cx, ch] = peak[b]
    heat = rng.uniform(0.2, 1.0, (B, H8, W8, 1)).astype(np.float32)
    return logits, heat


def compare_desc(ck, feats_flat, idx4, w4, label):
    """bilinear_desc_sample kernel vs plain: rows with a nonzero weight
    within 1e-5, rows without exactly zero."""
    dk = ck.bilinear_desc_sample(feats_flat, idx4, w4)
    dp = ck.bilinear_desc_sample_plain(feats_flat, idx4, w4)
    v = (w4 != 0).any(-1)
    err = float((dk - dp).abs()[v].max())
    print(f"desc [{label}]: max abs err {err:.3e} over {int(v.sum())} rows")
    check(err <= 1e-5, f"desc [{label}]: rows differ by more than 1e-5")
    check(bool((dk[~v] == 0).all()), f"desc [{label}]: zero-weight rows not zero")
    return {"max_abs_err": err}


def max_err(k, p, where):
    """Largest |k - p| over ``where`` (0 if it is empty)."""
    return float((k - p).abs()[where].max()) if bool(where.any()) else 0.0


def grid_note(ck, P, N):
    ctas, rows = ck.matcher_grid(P, N)
    return f"{ctas} CTAs of {rows} rows"


def compare_mnn(ck, args, label, exact=False):
    """mutual_nn_pairs kernel vs plain: best column equal on >= 99.9% of
    valid rows, best distance within 1e-3 where they agree, column best
    equal on >= 99.9% of valid columns; with ``exact``, idx equal on every
    row and col_best on every column."""
    mk = ck.mutual_nn_pairs(*args)
    mp = ck.mutual_nn_pairs_plain(*args)
    va, vb = args[2], args[3]
    rows = torch.ones_like(va) if exact else va
    cols = torch.ones_like(vb) if exact else vb

    def agreement(k, p, where):
        return float((k == p)[where].float().mean()) if where.any() else 1.0

    idx_agree = agreement(mk[2], mp[2], rows)
    col_agree = agreement(mk[3], mp[3], cols)
    same = rows & (mk[2] == mp[2]) & torch.isfinite(mp[0])
    err = max(max_err(mk[0], mp[0], same),
              max_err(mk[1], mp[1], same & torch.isfinite(mp[1])))
    inf_same = bool(all((torch.isinf(k) == torch.isinf(q)).all()
                        for k, q in zip(mk[:2], mp[:2])))
    need = 1.0 if exact else 0.999
    print(f"mnn [{label}; {grid_note(ck, va.shape[0], va.shape[1])}]: idx "
          f"agreement {idx_agree:.6f} on {'all' if exact else 'valid'} rows, "
          f"column best agreement {col_agree:.6f}, distance max abs err "
          f"{err:.3e}")
    check(idx_agree >= need, f"mnn [{label}]: best columns disagree")
    check(col_agree >= need, f"mnn [{label}]: column best rows disagree")
    check(err <= 1e-3, f"mnn [{label}]: distances differ by more than 1e-3")
    check(inf_same, f"mnn [{label}]: rows without a valid column differ")
    return {"max_abs_err": err}


def odd_shape_checks(ck, detect, dev):
    """The kernels against their plain versions off the main path's shapes:
    dense random survivors, a ragged last detect strip, nc=5, batch 1, a
    width that is not a multiple of the column split, a lattice of
    survivors (4-9 per cell), keypoints out of bounds, K and N != M not
    multiples of any tile, a pair with no valid column."""
    rng = np.random.default_rng(1)

    def t(a):
        return torch.tensor(a, device=dev)

    # ragged last strips and column parts in each tile size (2x8 cells up
    # to batch 6 here, 16x16 at 16x60x83)
    for B, H8, W8 in ((2, 13, 120), (1, 13, 83), (1, 60, 80), (16, 60, 83)):
        logits = t((rng.standard_normal((B, H8, W8, 65)) * 3).astype(np.float32))
        heat = t(rng.uniform(size=(B, H8, W8, 1)).astype(np.float32))
        for nc in ((5, 9) if B == 2 else (9,)):
            compare_detect(ck, logits, heat, nc, f"random {B}x{H8}x{W8}, nc={nc}")
        feats = t(rng.standard_normal((B, H8 * W8, 64)).astype(np.float32))
        vals, aux = ck.detect_candidates(logits, heat)
        for subpixel in (False, True):
            compare_kpdesc(ck, feats, vals, aux, 1000, subpixel,
                           f"random {B}x{H8}x{W8}, K=1000")
    for B, H8, W8 in ((32, 60, 80), (1, 13, 83)):
        logits, heat = (t(a) for a in lattice_inputs(rng, B, H8, W8))
        compare_detect(ck, logits, heat, 9, f"lattice {B}x{H8}x{W8}")

    Kq = 37
    kpts = np.stack([rng.uniform(-3, W8 * 8 + 2, (B, Kq)),
                     rng.uniform(-3, H8 * 8 + 2, (B, Kq))], -1)
    idx4, w4 = detect.desc_taps(t(kpts.astype(np.float32)),
                                t(rng.uniform(size=(B, Kq)) > 0.2), H8, W8)
    feats = t(rng.standard_normal((B, H8 * W8, 64)).astype(np.float32))
    compare_desc(ck, feats, idx4, w4, f"random K={Kq}, out-of-bounds taps")

    P, N, M = 3, 300, 257
    a = rng.standard_normal((P, N, 64)).astype(np.float32)
    b = rng.standard_normal((P, M, 64)).astype(np.float32)
    b[:, :120] = a[:, :120] + 0.05 * rng.standard_normal((P, 120, 64))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    vb = rng.uniform(size=(P, M)) > 0.1
    vb[0] = False
    compare_mnn(ck, (t(a), t(b), t(rng.uniform(size=(P, N)) > 0.1), t(vb)),
                f"random {P}x{N}x{M}, one pair without valid columns")


TIE_CASES = ("duplicate columns", "duplicate rows", "zero rows",
             "prefix masks", "all valid")


def tie_banks(rng, case, P, N, M):
    """Descriptor banks of small multiples of 1/8: every similarity is exact
    in float32 whatever the order of the sum, so equal similarities are
    equal in every implementation, and ties are common. ``case`` plants
    more: b's second half repeating its first (row ties across columns),
    a's second half repeating its first (column-best ties across rows, in
    other CTAs), a valid all-zero row in a and in b (all its similarities
    0), masks that are prefixes (as select_keypoints leaves them), or all
    valid."""
    a = (rng.integers(-2, 3, (P, N, 64)) / 8).astype(np.float32)
    b = (rng.integers(-2, 3, (P, M, 64)) / 8).astype(np.float32)
    va = rng.uniform(size=(P, N)) > 0.2
    vb = rng.uniform(size=(P, M)) > 0.2
    if case == "duplicate columns":
        h = M // 2
        b[:, h:2 * h] = b[:, :h]
    elif case == "duplicate rows":
        h = N // 2
        a[:, h:2 * h] = a[:, :h]
    elif case == "zero rows":
        a[:, N // 3] = 0
        va[:, N // 3] = True
        b[:, M // 3] = 0
        vb[:, M // 3] = True
    elif case == "prefix masks":
        va = np.arange(N) < rng.integers(0, N + 1, (P, 1))
        vb = np.arange(M) < rng.integers(0, M + 1, (P, 1))
    elif case == "all valid":
        va[:], vb[:] = True, True
    return a, b, va, vb


def matcher_checks(ck, dev, main_args):
    """The two matcher kernels against their plain versions on exact ties
    (the first index must win on every row and column) at the main path's
    P=31 and at P=1, at M=4096, and at N=1 and M=1; then one call of each
    wrapper under set_sync_debug_mode("error")."""
    rng = np.random.default_rng(3)

    def t(*xs):
        return tuple(torch.tensor(x, device=dev) for x in xs)

    for case in TIE_CASES:
        for P in (31, 1):
            compare_mnn(ck, t(*tie_banks(rng, case, P, K, K)),
                        f"ties: {case}, P={P}, N=M={K}", exact=True)
        a, b, _, vb = tie_banks(rng, case, 1, K, K)
        compare_top2(ck, *t(a[0], b[0], vb[0]),
                     f"ties: {case}, N=M={K}", exact=True)
    for P, N, M in ((2, K, 4096), (3, 1, 1), (2, 1, K), (2, K, 1)):
        for case in ("duplicate columns", "all valid"):
            args = t(*tie_banks(rng, case, P, N, M))
            compare_mnn(ck, args, f"ties: {case}, P={P}, N={N}, M={M}",
                        exact=True)
            compare_top2(ck, args[0][0], args[1][0], args[3][0],
                         f"ties: {case}, N={N}, M={M}", exact=True)

    a0, b0, vb0 = main_args[0][0], main_args[1][0], main_args[3][0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ck.mutual_nn_pairs(*main_args)
        ck.similarity_top2(a0, b0, vb0)
    except RuntimeError as e:
        raise SmokeFailure(f"a matcher wrapper synchronized: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("matcher wrappers under set_sync_debug_mode('error'): no "
          "synchronizing call")


def extract_sync_check(ck, logits, heat, feats_flat, vals, aux):
    """One call of each extraction wrapper (and the top-k between them)
    under set_sync_debug_mode("error")."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ck.detect_candidates(logits, heat)
        scores, sel = torch.topk(vals.reshape(vals.shape[0], -1), K, dim=1)
        ck.keypoint_desc(feats_flat, scores, sel, aux, aux.shape[3], True)
    except RuntimeError as e:
        raise SmokeFailure(f"an extraction wrapper synchronized: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("detect_candidates, torch.topk and keypoint_desc under "
          "set_sync_debug_mode('error'): no synchronizing call")


def path_counts(ck, label, expect, allowed=()):
    """Read the launch counts of the path just driven and check that each
    kernel of ``expect`` launched (``expect`` maps a name to an exact count
    or None for "at least once") and no other did, but those ``allowed``
    (any number of times)."""
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    print(f"kernels [{label}]: " + json.dumps(counts))
    for name, n in counts.items():
        if name in allowed:
            continue
        if name not in expect:
            check(n == 0, f"{label}: kernel {name} launched off its path")
        elif expect[name] is None:
            check(n > 0, f"{label}: kernel {name} was not launched")
        else:
            check(n == expect[name], f"{label}: kernel {name} launched {n} "
                  f"times, expected {expect[name]}")
    return counts


def compare_top2(ck, a, b, vb, label, exact=False):
    """similarity_top2 kernel vs plain: best column equal on >= 99.9% of
    rows (every row with ``exact``); s1 and s2 within 1e-6 where the best
    columns agree; rows without a valid column exactly -inf with column
    0."""
    sk = ck.similarity_top2(a, b, vb)
    sp = ck.similarity_top2_plain(a, b, vb)
    agree = sk[2] == sp[2]
    idx_agree = float(agree.float().mean())
    err = 0.0
    for k, p in zip(sk[:2], sp[:2]):
        fin = agree & torch.isfinite(p)
        if bool(fin.any()):
            err = max(err, float((k - p).abs()[fin].max()))
        check(bool((k[~torch.isfinite(p)] == p[~torch.isfinite(p)]).all()),
              f"top2 [{label}]: -inf rows differ")
    none = torch.isneginf(sp[0])
    check(bool((sk[2][none] == 0).all()), f"top2 [{label}]: empty rows' index")
    print(f"top2 [{label}; {grid_note(ck, 1, a.shape[0])}]: idx agreement "
          f"{idx_agree:.6f}, similarity max abs err {err:.3e}, "
          f"{int(none.sum())} rows without a valid column")
    check(idx_agree >= (1.0 if exact else 0.999),
          f"top2 [{label}]: best columns disagree")
    check(err <= 1e-6, f"top2 [{label}]: similarities differ by more than 1e-6")
    return {"max_abs_err": err}


def single_pair_phase(ck, matching, batched, desc, valid, res_batched, dev):
    """The single-pair matcher path (kernel 4): counted, against the batched
    matcher and the unfused route, and the kernel against its plain version
    on the main path's frames 0 and 1 and at odd shapes."""
    B = desc.shape[0]
    ck.reset_launch_counts()
    res_pp = batched.match_consecutive(desc, valid, fused=False)
    launches = path_counts(ck, "match_consecutive(fused=False)",
                           {"similarity_top2": 2 * (B - 1)})
    idx_agree = float((res_pp.idx == res_batched.idx).float().mean())
    mask_agree = float((res_pp.mask == res_batched.mask).float().mean())
    print(f"per-pair vs pair-batched matcher: idx agreement {idx_agree:.6f}, "
          f"mask agreement {mask_agree:.6f}, matches per pair mean "
          f"{float(res_pp.mask.sum(1).float().mean()):.1f}")
    check(idx_agree >= 0.999 and mask_agree >= 0.999,
          "match_consecutive(fused=False) disagrees with the batched matcher")

    kw = dict(max_dist=matching.TH_LOW * 6, ratio=0.95)
    rf = matching.match_mutual_nn(desc[0], desc[1], valid[0], valid[1],
                                  fused=True, **kw)
    ru = matching.match_mutual_nn(desc[0], desc[1], valid[0], valid[1],
                                  fused=False, **kw)
    idx_agree = float((rf.idx == ru.idx).float().mean())
    mask_agree = float((rf.mask == ru.mask).float().mean())
    print(f"match_mutual_nn fused vs unfused (frames 0,1): idx agreement "
          f"{idx_agree:.6f}, mask agreement {mask_agree:.6f}, "
          f"{int(rf.mask.sum())} matches")
    check(idx_agree >= 0.999 and mask_agree >= 0.999,
          "match_mutual_nn's routes disagree")
    check(bool(torch.isinf(rf.dist[~valid[0]]).all()),
          "fused route: invalid rows' distance is not inf")

    report = compare_top2(ck, desc[0], desc[1], valid[1], "frames 0,1")
    rng = np.random.default_rng(2)
    N, M = 333, 257
    a = rng.standard_normal((N, 64)).astype(np.float32)
    b = rng.standard_normal((M, 64)).astype(np.float32)
    b[:100] = a[:100] + 0.05 * rng.standard_normal((100, 64))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    vb = rng.uniform(size=M) > 0.1
    a_t, b_t = torch.tensor(a, device=dev), torch.tensor(b, device=dev)
    compare_top2(ck, a_t, b_t, torch.tensor(vb, device=dev),
                 f"random {N}x{M}, masked columns")
    compare_top2(ck, a_t, b_t, torch.zeros(M, dtype=torch.bool, device=dev),
                 f"random {N}x{M}, no valid column")
    return launches, report


# float ops of one pass of the pose LM over one edge, counted from
# csrc/pose_lm.cu at its least: the transform 18, projection and residuals
# ~15, chi2 and the robust cost ~8, each of 2-3 Jacobian rows ~12 plus the
# 21 entries of H and 6 of b as multiply-adds (54); a stereo edge ~220
POSE_LM_OPS_PER_EDGE_PASS = 220


@contextlib.contextmanager
def recording_pose_lm(store):
    """Keep a copy of the arguments of every ``pose_opt.pose_optimization``
    call (the pose LM's callers reach it through the module; the kernel
    wrapper itself stays in place, with its launch counter)."""
    from xfeatslam_tpu_torch.optim import pose_opt

    fn = pose_opt.pose_optimization

    def rec(*args, **kwargs):
        store.append((tuple(a.clone() if isinstance(a, torch.Tensor) else a
                            for a in args), dict(kwargs)))
        return fn(*args, **kwargs)

    pose_opt.pose_optimization = rec
    try:
        yield store
    finally:
        pose_opt.pose_optimization = fn


def pose_problem(rng, cam, n, dev, noise_px=0.3, outlier_frac=0.0,
                 stereo_frac=1.0, bf=BF, valid_frac=1.0):
    """A pose-LM problem of ``n`` edges (numpy, from ``rng``): points 2-8 m
    in front of a camera moved by a small motion, noisy pixels, a share of
    gross outliers, stereo and valid edges at the given shares, the LM
    started at the identity. Returns the wrapper's positional arguments."""
    X = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(2.0, 8.0, n)
    a = np.array([0.04, -0.06, 0.03])
    th = np.linalg.norm(a)
    k = a / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    t = np.array([0.1, -0.05, 0.02])
    Xc = X @ R.T + t
    uv = np.stack([cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx,
                   cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy], -1)
    ur = uv[:, 0] - bf / Xc[:, 2]
    uv = uv + rng.normal(0, noise_px, uv.shape)
    n_out = int(outlier_frac * n)
    if n_out:
        sel = rng.choice(n, n_out, replace=False)
        uv[sel] += (rng.uniform(20, 80, (n_out, 2))
                    * rng.choice([-1, 1], (n_out, 2)))
    stereo = rng.uniform(size=n) < stereo_frac
    valid = rng.uniform(size=n) < valid_frac

    def t_(x, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    return (t_(np.eye(3)), t_(np.zeros(3)), t_(X), t_(uv), t_(ur),
            t_(np.ones(n)), t_(stereo, torch.bool), t_(valid, torch.bool),
            cam, bf)


def compare_pose_lm(ck, args, kwargs, label):
    """pose_lm kernel vs its plain version on the same inputs: R and t
    within 1e-4, inlier flags equal on >= 0.99 of the valid slots; the
    kernel twice, bit for bit. Returns the largest pose difference."""
    k = ck.pose_lm(*args, **kwargs)
    k2 = ck.pose_lm(*args, **kwargs)
    p = ck.pose_lm_plain(*args, **kwargs)
    valid = args[7]
    n_valid = int(valid.sum())
    err = max(float((k[0] - p[0]).abs().max()),
              float((k[1] - p[1]).abs().max()))
    agree = (float((k[2] == p[2])[valid].float().mean()) if n_valid else 1.0)
    same = all(torch.equal(a, b) for a, b in zip(k, k2))
    print(f"pose_lm [{label}; N={valid.shape[0]}, {n_valid} valid]: R, t max "
          f"abs err {err:.3e}, inlier agreement {agree:.6f} on valid slots, "
          f"inliers {int(k[3])} kernel / {int(p[3])} plain, two calls "
          f"bit-identical {same}")
    check(bool(torch.isfinite(k[0]).all() & torch.isfinite(k[1]).all()),
          f"pose_lm [{label}]: non-finite pose")
    check(err <= 1e-4, f"pose_lm [{label}]: pose differs from the plain "
          "version by more than 1e-4")
    check(agree >= 0.99, f"pose_lm [{label}]: inlier flags disagree")
    check(same, f"pose_lm [{label}]: two calls differ")
    check(not bool(k[2][~valid].any()), f"pose_lm [{label}]: an invalid "
          "slot is an inlier")
    return err


def pose_lm_bound(args, kwargs):
    """The least time of one pose-LM call on these inputs: each input read
    and each output written once, or POSE_LM_OPS_PER_EDGE_PASS float ops
    per valid edge in each of its passes (2 schedules x (rounds x (iters +
    1) + 1) LM and final cost passes, the classification). Valid edges
    count in every pass, though a round's active set is smaller. Prints
    both bounds and the chain the kernel runs: rounds x (iters + 1) + 2
    dependent passes per schedule (46 at 4 x 10: the LM passes, the final
    cost, the classification that the two share), the two schedules side
    by side on two SMs; returns (ms, "bytes" or "operations")."""
    N = args[2].shape[0]
    rounds, iters = kwargs.get("rounds", 4), kwargs.get("iters", 10)
    n_valid = int(args[7].sum())
    nbytes = N * (3 + 2 + 1 + 1) * 4 + 2 * N + 12 * 4 + (12 * 4 + N + 4
                                                          + 4 * N)
    chain = rounds * (iters + 1) + 2  # the LM passes, the final cost, the
    passes = 2 * chain - 1            # classification (split by the two)
    flops = passes * n_valid * POSE_LM_OPS_PER_EDGE_PASS
    print(f"pose_lm bound at N={N}, {n_valid} valid: bytes {nbytes} -> "
          f"{nbytes / PEAK_BYTES_PER_S * 1e3:.6f} ms, float ops {flops} -> "
          f"{flops / PEAK_F32_FLOPS * 1e3:.6f} ms; {chain} dependent passes "
          "per schedule, the two schedules concurrent, each pass ending in "
          "a block reduction and a 6x6 solve")
    return bound_ms(nbytes, flops)


def pose_lm_odd_checks(ck, cam, dev):
    """The kernel against its plain version on odd inputs: no valid edge,
    all mono with bf 0, 30% outliers, N not a multiple of 32, N = 2048 (the
    relocalization pad) with 40% of it valid, and the largest N it takes.
    Returns the largest pose difference."""
    rng = np.random.default_rng(7)
    cases = {
        "no valid edge": pose_problem(rng, cam, 1000, dev, valid_frac=0.0),
        "all mono, bf 0": pose_problem(rng, cam, 1000, dev, stereo_frac=0.0,
                                       bf=0.0),
        "30% outliers": pose_problem(rng, cam, 1000, dev, outlier_frac=0.3,
                                     stereo_frac=0.7),
        "N = 999": pose_problem(rng, cam, 999, dev, outlier_frac=0.1,
                                stereo_frac=0.5, valid_frac=0.6),
        "N = 2048": pose_problem(rng, cam, 2048, dev, outlier_frac=0.2,
                                 valid_frac=0.4),
        "N = max": pose_problem(rng, cam, ck.POSE_LM_MAX_EDGES, dev,
                                outlier_frac=0.1, valid_frac=0.5),
    }
    err = 0.0
    for label, args in cases.items():
        err = max(err, compare_pose_lm(ck, args, {}, label))
    try:
        big = pose_problem(rng, cam, ck.POSE_LM_MAX_EDGES + 1, dev)
        ck.pose_lm(*big)
        refused = False
    except ValueError:
        refused = True
    check(refused, "pose_lm took more edges than its kernel holds")
    return err


def build_map(o, depth, R, t, cam):
    """Frame 0's valid keypoints with depth, back-projected with the true
    pose (numpy): even ones fill stage 1's M1 slots, odd ones a local map
    padded to M2 rows under ids stage 1 does not hold. Keypoints on a depth
    silhouette (3x3 max - min above DEPTH_EDGE_REL of the depth, the frame
    step's own gate) get no map point."""
    kp, desc, val = (o[k][0].cpu().numpy() for k in ("kpts", "desc", "valid"))
    xi = np.clip(np.round(kp[:, 0]).astype(int), 0, W - 1)
    yi = np.clip(np.round(kp[:, 1]).astype(int), 0, H - 1)
    z = depth[yi, xi]
    nbrs = np.stack([depth[np.clip(yi + dy, 0, H - 1), np.clip(xi + dx, 0, W - 1)]
                     for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    z = np.where((nbrs.max(0) - nbrs.min(0) > DEPTH_EDGE_REL * z)
                 | (nbrs.min(0) <= 0), 0.0, z)
    Xc = np.stack([(kp[:, 0] - cam.cx) / cam.fx * z,
                   (kp[:, 1] - cam.cy) / cam.fy * z, z], -1)
    Xw = ((Xc - t) @ R).astype(np.float32)
    sel = np.nonzero(val & (z > 0))[0]
    s1, s2 = sel[0::2], sel[1::2]

    def pad(x, n, fill=0):
        out = np.full((n,) + x.shape[1:], fill, x.dtype)
        out[: len(x)] = x
        return out

    arrays = (pad(Xw[s1], M1), pad(desc[s1], M1),
              pad(np.ones(len(s1), bool), M1, False),
              np.zeros(M1, np.float32), np.zeros(M1, np.int32),
              pad(np.arange(len(s1), dtype=np.int32), M1, -1),
              pad(Xw[s2], M2), pad(desc[s2], M2),
              pad(np.ones(len(s2), bool), M2, False),
              np.zeros(M2, np.float32), np.zeros(M2, np.int32),
              pad(np.arange(len(s2), dtype=np.int32) + M1, M2, -1),
              np.full(M2, 10.0, np.float32))
    return arrays, len(s1), len(s2)


def center_err(R, t, pose):
    """Distance between the estimated and the true camera centre, m."""
    R, t = R.cpu().numpy(), t.cpu().numpy()
    Rg, tg = pose
    return float(np.linalg.norm(-R.T @ t + Rg.T @ tg))


def frame_step_phase(model, ck, dev):
    """The online RGB-D frame step on frames 1-5 of a synthetic sequence,
    counted per frame, against the truth and the plain-kernel path; the
    monocular configuration; no host sync inside a step; timings."""
    from xfeatslam_tpu_torch.models.extractor import extract_fn
    from xfeatslam_tpu_torch.ops import camera
    from xfeatslam_tpu_torch.ops import image as image_ops
    from xfeatslam_tpu_torch.optim import pose_opt, track_step
    from xfeatslam_tpu_torch.utils import synthetic

    t0 = time.perf_counter()
    seq = synthetic.make_sequence(N_FRAMES, (H, W))
    Km = seq["K"]
    cam = camera.Pinhole.from_list([Km[0, 0], Km[1, 1], Km[0, 2], Km[1, 2]])
    imgs = [image_ops.to_float_image(g, dev) for g in seq["images"]]
    depths = [torch.from_numpy(d).to(dev) for d in seq["depths"]]
    no_depth = torch.zeros((1, 1), device=dev)
    o0 = extract_fn(model, imgs[0], K)
    arrays, n1, n2 = build_map(o0, seq["depths"][0], *seq["poses"][0], cam)
    maps = tuple(torch.from_numpy(x).to(dev) for x in arrays)
    print(f"frame step: {N_FRAMES} frames rendered at {W}x{H} and a map "
          f"built in {time.perf_counter() - t0:.2f} s; stage 1 holds {n1} of "
          f"{M1} slots, the local map {n2} of {M2} rows")

    def step(i, R0, t0, has_depth=True):
        return track_step.xfeat_rgbd_frame_step(
            model, imgs[i], depths[i] if has_depth else no_depth, R0, t0,
            *maps, cam, BF, DEPTH_EDGE_REL, INV_SIGMA2, RADIUS_MOTION,
            RADIUS_LOCAL, TH_HIGH, RATIO, WIDEN_BELOW, SCALE_FACTOR,
            2.0 * cam.cx, 2.0 * cam.cy, num_keypoints=K, n_levels=1,
            has_depth=has_depth)

    Rg0, tg0 = (torch.from_numpy(x).to(dev) for x in seq["poses"][0])
    # ---- frames 1-5, each from the previous estimate, counted; the pose
    # LM's inputs of both stages kept ----
    inputs, results, walls, lm_calls = [], [], [], []
    R, t = Rg0, tg0
    with recording_pose_lm(lm_calls):
        for i in range(1, N_FRAMES):
            ck.reset_launch_counts()
            tw = time.perf_counter()
            out, r1, r2 = step(i, R, t)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - tw)
            path_counts(ck, f"frame step, frame {i}", FRAME_STEP_KERNELS)
            inputs.append((R, t))
            results.append((out, r1, r2))
            R, t = r2.R, r2.t
    errs = []
    for i, (out, r1, r2) in zip(range(1, N_FRAMES), results):
        errs.append(center_err(r2.R, r2.t, seq["poses"][i]))
        print(f"frame {i}: {int(out['valid'].sum())} keypoints, "
              f"{int((out['depth'] > 0).sum())} with depth; stage 1 "
              f"{int(r1.n_matched)} matched / {int(r1.n_inliers)} inliers, "
              f"stage 2 {int(r2.n_matched)} / {int(r2.n_inliers)}; "
              f"translation error {errs[-1] * 1e3:.3f} mm")
        check(int(r1.n_matched) > 0 and int(r2.n_matched) > 0,
              f"frame {i}: a stage bound no match")
        check(errs[-1] < 0.01, f"frame {i}: translation error >= 1 cm")

    # ---- no host sync inside a step ----
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(1, *inputs[0])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # torch's warning for each synchronizing call (its notice that the mode
    # is a prototype is not one)
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    print(f"frame step: {len(syncs)} synchronizing calls inside a step"
          + (f": {syncs[:3]}" if syncs else ""))
    check(not syncs, "the frame step synchronizes with the host")

    # ---- the same frames by CUDA-graph replay, bit for bit ----
    graph = track_step.RgbdFrameStepGraph(model)

    def replay(i, R0, t0):
        return graph(imgs[i], depths[i], R0, t0, *maps, cam, BF,
                     DEPTH_EDGE_REL, INV_SIGMA2, RADIUS_MOTION, RADIUS_LOCAL,
                     TH_HIGH, RATIO, WIDEN_BELOW, SCALE_FACTOR, 2.0 * cam.cx,
                     2.0 * cam.cy, num_keypoints=K, n_levels=1,
                     has_depth=True)

    for i, ((R0, t0), res) in enumerate(zip(inputs, results), 1):
        ck.reset_launch_counts()
        got = track_step.fetch(replay(i, R0, t0))
        counts = path_counts(ck, f"frame step by graph replay, frame {i}", {
            name: None if i == 1 else n
            for name, n in FRAME_STEP_KERNELS.items()})
        want = track_step.fetch(res)
        differ = [f"{part}.{k}" for part, a, b in zip(("frame", "r1", "r2"),
                                                      want, got)
                  for k, x in (a.items() if isinstance(a, dict)
                               else a._asdict().items())
                  if not np.array_equal(x, (b if isinstance(b, dict)
                                            else b._asdict())[k])]
        print(f"frame {i} by graph replay: bit-identical to the eager step: "
              f"{not differ}" + (f" (differ: {differ})" if differ else "")
              + (f"; launches in the call that captured {counts}"
                 if i == 1 else ""))
        check(not differ, f"frame {i}: graph replay differs from the eager "
              "step")
    captured = graph.captured_launches()
    print(f"frame step graph: kernel launches recorded at capture "
          f"{captured}")
    check(captured == [FRAME_STEP_KERNELS],
          "the captured frame step does not launch its kernels "
          f"{FRAME_STEP_KERNELS}")

    # ---- the same frames through the plain kernels ----
    t_dev, slot_agree = 0.0, 1.0
    with plain_kernels(ck):
        for i, ((R0, t0), (_, k1, k2)) in enumerate(zip(inputs, results), 1):
            _, p1, p2 = step(i, R0, t0)
            t_dev = max(t_dev, float((p2.t - k2.t).abs().max()),
                        float((p2.R - k2.R).abs().max()))
            for k, p in ((k1, p1), (k2, p2)):
                slot_agree = min(slot_agree, float(
                    (k.slot_mp == p.slot_mp).float().mean()))
    print(f"frame step vs plain-kernel path: pose max abs difference "
          f"{t_dev:.3e}, slot agreement min {slot_agree:.6f}")
    check(t_dev <= 1e-4, "frame-step poses differ from the plain path")
    check(slot_agree >= 0.99, "frame-step slots differ from the plain path")

    # ---- the pose LM kernel against its plain version: both stages'
    # inputs of frames 1-5, then odd inputs ----
    check(len(lm_calls) == 2 * (N_FRAMES - 1),
          f"the frame steps made {len(lm_calls)} pose-LM calls")
    lm_err = 0.0
    for c, (args, kwargs) in enumerate(lm_calls):
        lm_err = max(lm_err, compare_pose_lm(
            ck, args, kwargs, f"frame {c // 2 + 1}, stage {c % 2 + 1}"))
    lm_err = max(lm_err, pose_lm_odd_checks(ck, cam, dev))

    # ---- monocular configuration ----
    _, m1, m2 = step(1, Rg0, tg0, has_depth=False)
    mono_ok = bool(torch.isfinite(m2.R).all() & torch.isfinite(m2.t).all())
    print(f"monocular frame 1: stage 1 {int(m1.n_inliers)} inliers, stage 2 "
          f"{int(m2.n_inliers)} inliers, translation error "
          f"{center_err(m2.R, m2.t, seq['poses'][1]) * 1e3:.3f} mm")
    check(mono_ok and int(m2.n_inliers) >= 20, "monocular frame step failed")

    # ---- timings: the step, its parts, host wall, kernel count ----
    R1, t1 = inputs[0]
    out1, r1_1, _ = results[0]
    times = {"frame_step": cuda_ms(lambda: step(1, R1, t1), iters=5,
                                   warmup=1),
             "frame_step_graph": cuda_ms(lambda: replay(1, R1, t1), iters=20,
                                         warmup=2),
             "extract_b1": cuda_ms(lambda: extract_fn(model, imgs[1], K))}
    walls = []
    for _ in range(10):
        tw = time.perf_counter()
        track_step.fetch(replay(1, R1, t1))
        walls.append(time.perf_counter() - tw)
    times["graph_host_wall_with_fetch"] = float(np.median(walls)) * 1e3
    zeros_k = torch.zeros(K, device=dev)
    isig = zeros_k + INV_SIGMA2
    times["two_stages"] = cuda_ms(lambda: track_step.two_stage_track_step(
        R1, t1, *maps, out1["kpts_un"], out1["desc"], out1["valid"], zeros_k,
        zeros_k.to(torch.int32), out1["ur"], isig, cam, BF, RADIUS_MOTION,
        RADIUS_LOCAL, TH_HIGH, RATIO, WIDEN_BELOW, SCALE_FACTOR, 2.0 * cam.cx,
        2.0 * cam.cy), iters=5, warmup=1)
    slot = r1_1.slot_mp
    edges = (slot >= 0) & out1["valid"]
    Xw = maps[0][slot.long().clamp(min=0)]
    times["pose_optimization"] = cuda_ms(lambda: pose_opt.pose_optimization(
        R1, t1, Xw, out1["kpts_un"], out1["ur"], isig,
        (out1["ur"] > 0) & edges, edges, cam, BF), iters=5, warmup=1)
    times["host_wall_per_frame"] = float(np.mean(walls[1:])) * 1e3
    # the pose LM alone on frame 1's stage-1 inputs
    lm_args, lm_kw = lm_calls[0]
    times["pose_lm"] = cuda_ms(lambda: ck.pose_lm(*lm_args, **lm_kw))
    times["pose_lm_device"] = graph_ms(lambda: ck.pose_lm(*lm_args, **lm_kw),
                                       calls=5, replays=5)
    times["pose_lm_plain"] = cuda_ms(
        lambda: ck.pose_lm_plain(*lm_args, **lm_kw), iters=3, warmup=1)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        step(1, R1, t1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tw
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    launch_calls = sum(1 for e in prof.events()
                       if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                     "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    print(f"frame step under torch.profiler: {len(dev_events)} device events, "
          f"{launch_calls} kernel-launch API calls, device busy "
          f"{busy_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms wall "
          f"({busy_us / 1e6 / wall:.3f}); busy share of the unprofiled step "
          f"{busy_us / 1e3 / times['frame_step']:.3f}")
    ops = sorted(((e.key, e.count) for e in prof.key_averages()
                  if e.key.startswith("aten::")), key=lambda kv: -kv[1])
    print("frame step: ATen ops with the most calls: "
          + json.dumps(dict(ops[:12])))
    print(f"frame step ms at {W}x{H}, K={K}, M1={M1}, M2={M2}, batch 1: "
          + json.dumps({k: round(v, 4) for k, v in times.items()}))
    return {"max_abs_err": lm_err, "ms": times["pose_lm"],
            "device_ms": times["pose_lm_device"],
            "plain_ms": times["pose_lm_plain"],
            "bound": pose_lm_bound(lm_args, lm_kw)}


def _slam_run(n_frames, seq, settings, record_ba=False, profile_from=None,
              ba_graph=None, backend="xfeat", loop=True, graphs_from=None):
    """One ``System.track_rgbd`` run over ``seq``: states, camera-centre
    errors, poses and host wall per frame. ``record_ba`` keeps the BA
    problems local mapping solves; ``profile_from`` traces the frames from
    that index on with ``torch.profiler`` (CUDA activity) and returns the
    device's busy time over their wall time; ``ba_graph`` is a
    ``LocalBAGraph`` that already holds the BA rounds' graphs.
    ``backend`` and ``loop`` (loop closing) configure the System;
    ``graphs_from`` is an earlier ORB System whose CUDA graphs (the
    extractor's two stages, the tracking stages, local BA) this run
    replays."""
    from torch.profiler import ProfilerActivity, profile

    from xfeatslam_tpu_torch.slam.system import Sensor, System

    system = System(settings, Sensor.RGBD, backend=backend,
                    enable_loop_closing=loop)
    if ba_graph is not None:
        system.local_mapping._ba_graph = ba_graph
    if graphs_from is not None:
        system.extractor._graphs = graphs_from.extractor._graphs
        system.tracking._track_graph = graphs_from.tracking._track_graph
        system.local_mapping._ba_graph = graphs_from.local_mapping._ba_graph
    problems = []
    if record_ba:
        lm = system.local_mapping
        solve = lm._solve

        def recording(prob, stage, stage_iters):
            problems.append((stage, prob))
            return solve(prob, stage, stage_iters)

        lm._solve = recording
    out = {"system": system, "states": [], "errs": [], "poses": [],
           "walls": [], "problems": problems}
    prof, t_prof = None, None
    for i in range(n_frames):
        if profile_from is not None and i == profile_from:
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof = time.perf_counter()
        tw = time.perf_counter()
        state, pose = system.track_rgbd(seq["images"][i], seq["depths"][i],
                                        seq["timestamps"][i])
        out["walls"].append(time.perf_counter() - tw)
        out["states"].append(state.name)
        out["poses"].append((pose[0].copy(), pose[1].copy()))
        Rg, tg = seq["poses"][i]
        out["errs"].append(float(np.linalg.norm(-pose[0].T @ pose[1]
                                                + Rg.T @ tg)))
    if prof is not None:
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_prof
        prof.__exit__(None, None, None)
        t0 = time.perf_counter()
        # the raw kineto records: building the profiler's Python events
        # for ~2M kernels takes minutes
        dev = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
        busy = sum(e.duration_ns() for e in dev) / 1e9
        out["profile"] = {"frames": n_frames - profile_from,
                          "device_events": len(dev),
                          "device_busy_ms": round(busy * 1e3, 4),
                          "wall_ms": round(wall * 1e3, 4),
                          "busy_share": round(busy / wall, 4),
                          "processing_s": round(time.perf_counter() - t0, 2)}
    out["errs"] = np.array(out["errs"])
    return out


def slam_phase(ck, n_frames):
    """``System.track_rgbd`` (no loop closing) on ``n_frames`` rendered
    frames at 640x480, K=1000, the shipped weights, three times in one
    process, the counters zeroed before the first run: each run every frame
    OK, the camera centre within 3 cm of the truth everywhere and 1 cm at
    the median, at least SLAM_MIN_CAPTURED frames through the captured
    step; runs 2 and 3 bit-identical to run 1 (every pose, the saved
    trajectory, the keyframe and map-point counts). Runs 2 and 3 reuse run
    1's BA graphs, so no BA capture falls in their frames: host wall time
    per frame, the track and backend spans and local BA per round by
    replay from run 2; the device's busy time over frames 2.. from a
    profiler pass over run 3, against run 2's wall. Returns run 3, the
    sequence and the BA problems of run 1."""
    from xfeatslam_tpu_torch.ops.camera import Pinhole
    from xfeatslam_tpu_torch.slam.settings import Settings
    from xfeatslam_tpu_torch.utils import synthetic

    t0 = time.perf_counter()
    seq = synthetic.make_sequence(n_frames=n_frames)
    Km = seq["K"]
    settings = Settings(
        cam=Pinhole.from_list([Km[0, 0], Km[1, 1], Km[0, 2], Km[1, 2]]),
        bf=40.0, th_depth=3.0, depth_map_factor=1.0, n_features=K)
    print(f"slam: {n_frames} frames rendered at {W}x{H} in "
          f"{time.perf_counter() - t0:.2f} s")
    ck.reset_launch_counts()
    run1 = _slam_run(n_frames, seq, settings, record_ba=True)
    counts = path_counts(ck, f"System.track_rgbd, {n_frames} frames",
                         SLAM_KERNELS)
    graphs = run1["system"].local_mapping._ba_graph
    run2 = _slam_run(n_frames, seq, settings, ba_graph=graphs)
    run3 = _slam_run(n_frames, seq, settings, profile_from=2,
                     ba_graph=graphs)
    runs = (("run 1", run1), ("run 2", run2), ("run 3", run3))
    for tag, r in runs:
        st = r["system"].shutdown()
        r["stats"] = st
        errs = r["errs"]
        print(f"slam {tag}: states {r['states'].count('OK')} of {n_frames} "
              f"OK, camera centre error max {errs.max() * 1e3:.3f} mm, median "
              f"{np.median(errs) * 1e3:.3f} mm; {st['keyframes']} keyframes, "
              f"{st['map_points']} map points; {st.get('fused_grab', 0)} "
              f"frames through the captured step; loops closed "
              f"{st['loops_closed']}"
              + (f"; launches {counts}" if r is run1 else ""))
        check(r["states"] == ["OK"] * n_frames,
              f"slam {tag}: a frame was not OK: {r['states']}")
        check(errs.max() < 0.03, f"slam {tag}: camera centre error >= 3 cm")
        check(np.median(errs) < 0.01,
              f"slam {tag}: median camera centre error >= 1 cm")
        check(st.get("fused_grab", 0) >= SLAM_MIN_CAPTURED,
              f"slam {tag}: too few frames through the captured step")
        # the rendered orbit never comes back to a place it saw
        check(st["loops_closed"] == 0 and r["system"].loop_closing is not None,
              f"slam {tag}: loops closed {st['loops_closed']} (expected 0, "
              "with loop closing on)")
    for tag, r in runs[1:]:
        same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                   for a, b in zip(run1["poses"], r["poses"]))
        same_traj = all(
            np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
            for a, b in zip(run1["system"].tracking.resolved_trajectory(),
                            r["system"].tracking.resolved_trajectory()))
        counts_same = all(run1["stats"][k] == r["stats"][k]
                          for k in ("keyframes", "map_points", "kfs"))
        print(f"slam: {tag} against run 1: every pose bit-identical {same}, "
              f"saved trajectory bit-identical {same_traj}, keyframe and map "
              f"point counts equal {counts_same}")
        check(same and same_traj and counts_same,
              f"slam: {tag} differs from run 1")

    def pct(xs, q):
        return round(float(np.percentile(np.asarray(xs) * 1e3, q)), 4)

    # steady state: frames 2.. (frame 0 initializes the map, frame 1
    # captures the step's graph)
    system, walls = run2["system"], run2["walls"]
    spans = system.timer.samples
    ba = system.local_mapping.ba_seconds
    report = {
        "wall_per_frame_ms": {"median": pct(walls[2:], 50),
                              "p90": pct(walls[2:], 90),
                              "mean": round(float(np.mean(walls[2:])) * 1e3,
                                            4)},
        "track_ms": {"median": pct(spans["track"][2:], 50),
                     "p90": pct(spans["track"][2:], 90)},
        "backend_ms": {"median": pct(spans["backend"][2:], 50),
                       "p90": pct(spans["backend"][2:], 90)},
        # inside track: the host's inputs of the step, then the replay and
        # its one read (the first replay's call captured the graph)
        "track_snapshot_ms": {"median": pct(spans["track.snapshot"][1:], 50),
                              "p90": pct(spans["track.snapshot"][1:], 90)},
        "track_frame_step_ms": {
            "median": pct(spans["track.frame_step"][1:], 50),
            "p90": pct(spans["track.frame_step"][1:], 90)},
        "frame_0_ms": round(walls[0] * 1e3, 4),
        "frame_1_capture_ms": round(walls[1] * 1e3, 4),
        # BA rounds by replay, each with its read
        "local_ba_first_stage_ms": [round(t * 1e3, 4) for k, t, _ in ba
                                    if k == "first"],
        "local_ba_tick_ms": [round(t * 1e3, 4) for k, t, _ in ba
                             if k == "tick"],
        # run 1's calls that captured a BA graph
        "local_ba_capture_calls_ms": [
            round(t * 1e3, 4)
            for _, t, c in run1["system"].local_mapping.ba_seconds if c],
        "keyframes": run2["stats"]["keyframes"],
        "map_points": run2["stats"]["map_points"],
    }
    print(f"slam timings (host wall, run 2, {n_frames} frames at {W}x{H}, "
          f"K={K}): " + json.dumps(report))
    # the profiler slows the host, so the busy time is also put against
    # run 2's unprofiled wall over the same frames (the same graphs run)
    prof = dict(run3["profile"], busy_share_of_run_2_wall=round(
        run3["profile"]["device_busy_ms"] / 1e3 / sum(walls[2:]), 4))
    print(f"slam device busy share (torch.profiler, CUDA activity, run 3, "
          f"frames 2-{n_frames - 1}): " + json.dumps(prof))
    return run3, seq, run1["problems"], counts


def relocalization_phase(ck, run, seq, kernels=FRAME_STEP_KERNELS,
                         label="relocalization"):
    """After the SLAM runs: the tracker set LOST takes frame RELOC_FRAME at
    a later time and must come back OK within 1 cm of the truth; then the
    same frame arrives RECENTLY_LOST with the motion model and the
    reference keyframe made to fail, so it goes through relocalization too
    (that used to raise); then the tracker set LOST takes RELOC_OTHER_FRAME,
    which no keyframe was made from. Each comes back OK within 1 cm, the
    map unchanged (a LOST frame that fails resets a small map). Counted:
    each builds its frame with the extraction kernels (``kernels``: the
    XFeat frame step's, or the ORB extractor's). Returns the next
    timestamp, the last frame fed and the pose LM's largest gap to its
    plain version."""
    from xfeatslam_tpu_torch.slam.tracking import State

    system = run["system"]
    tr = system.tracking
    lm_calls = []
    kf_frames = sorted(kf.frame_id for kf in system.map.keyframes.values())
    check(RELOC_OTHER_FRAME not in kf_frames,
          f"frame {RELOC_OTHER_FRAME} is a keyframe's ({kf_frames})")
    map_id, kfs = system.map.map_id, system.map.num_keyframes()
    t_next = seq["timestamps"][-1] + 1.0
    ck.reset_launch_counts()
    tag = label
    for label, state, i in (("LOST", State.LOST, RELOC_FRAME),
                            ("RECENTLY_LOST", State.RECENTLY_LOST,
                             RELOC_FRAME),
                            ("LOST", State.LOST, RELOC_OTHER_FRAME)):
        tr.state = state
        tr.lost_since = t_next - 0.1
        forced = state == State.RECENTLY_LOST
        if forced:
            tr._track_with_motion_model = lambda frame: False
            tr._track_reference_keyframe = lambda frame: False
        before = tr.stats.get("reloc_ok", 0)
        fid = tr.pipeline._next_id
        tw = time.perf_counter()
        try:
            with recording_pose_lm(lm_calls):
                got, pose = system.track_rgbd(seq["images"][i],
                                              seq["depths"][i], t_next)
        finally:
            if forced:
                del tr._track_with_motion_model, tr._track_reference_keyframe
        wall = time.perf_counter() - tw
        Rg, tg = seq["poses"][i]
        err = (float(np.linalg.norm(-pose[0].T @ pose[1] + Rg.T @ tg))
               if pose is not None else float("nan"))
        print(f"{tag} from {label}: frame {i} (frame id {fid}; "
              f"keyframes from frames {kf_frames}) -> {got.name}, camera "
              f"centre error {err * 1e3:.3f} mm (tracked in the run: "
              f"{run['errs'][i] * 1e3:.3f} mm), reloc_ok {before} -> "
              f"{tr.stats.get('reloc_ok', 0)}, host wall {wall * 1e3:.1f} ms")
        check(got == State.OK, f"{tag} of frame {i} from {label} failed")
        check(err < 0.01, f"{tag} of frame {i} from {label}: error >= 1 cm")
        check(system.map.map_id == map_id
              and system.map.num_keyframes() == kfs,
              f"{tag} of frame {i} from {label} left the map")
        if forced:
            check(tr.stats.get("reloc_ok", 0) == before + 1,
                  f"{tag}: the RECENTLY_LOST frame did not relocalize")
        t_next += 1.0 / 30
    # a local-BA round may run after a relocalized frame
    path_counts(ck, tag, {name: None for name in kernels},
                allowed=("local_ba",))
    # the pose LM kernel against its plain version on every call the
    # relocalizations made (the relocalization LM and the tracking after)
    check(lm_calls, f"{tag} made no pose-LM call")
    err = max(compare_pose_lm(ck, args, kwargs, f"{tag} call {c}")
              for c, (args, kwargs) in enumerate(lm_calls))
    return t_next, RELOC_OTHER_FRAME, err


def localization_phase(ck, run, seq, t_next, last,
                       kernels=FRAME_STEP_KERNELS, label="localization mode"):
    """Localization mode: the 5 frames after ``last``, the frame last
    relocalized, every frame OK and the map's keyframe and point counts
    unchanged; counted (``kernels``: the path's)."""
    system = run["system"]
    system.activate_localization_mode()
    kfs, mps = system.map.num_keyframes(), system.map.num_points()
    ck.reset_launch_counts()
    states, errs = [], []
    for i in range(last + 1, last + 6):
        state, pose = system.track_rgbd(seq["images"][i], seq["depths"][i],
                                        t_next)
        t_next += 1.0 / 30
        states.append(state.name)
        Rg, tg = seq["poses"][i]
        errs.append(float(np.linalg.norm(-pose[0].T @ pose[1] + Rg.T @ tg)))
    path_counts(ck, f"{label}, 5 frames", {name: None for name in kernels},
                allowed=("local_ba",))
    print(f"{label}: states {states}, camera centre error max "
          f"{max(errs) * 1e3:.3f} mm; keyframes {kfs} -> "
          f"{system.map.num_keyframes()}, map points {mps} -> "
          f"{system.map.num_points()}")
    check(states == ["OK"] * 5, f"{label}: a frame was not OK")
    check(system.map.num_keyframes() == kfs and system.map.num_points() == mps,
          f"{label} changed the map")
    system.deactivate_localization_mode()


def loop_phase(ck, model_settings, dev):
    """Loop closing on ``bench.py --mode loop``'s workload at its full size:
    the 40-keyframe drifted RGB-D chain of ``utils/synthetic.make_loop_map``
    (period 36, the last 4 keyframes revisit the first, 1200 points,
    bf 40), every keyframe fed in order to ``LoopClosing`` (fix_scale, 3
    confirmations, the inline GBA, the 25/30 projection gates) on the card.
    At least one loop must close and the ATE RMSE after the correction must
    fall below the RMSE before. After LOOP_EXTRA_GBAS more inline GBAs of the
    final map it must stay within LOOP_RMSE_FACTOR of the JAX package's CPU
    figure after the same GBAs. The GBA's last problem is solved
    again eagerly and by replay (bit-identical), and timed, and the
    kernels' solve is held to the plain twin's (``ba_against_plain``).
    Then the atlas
    goes through ``System.save_atlas`` and a second System's
    ``load_atlas``: keyframes, points, poses and the retrieval index come
    back equal."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from xfeatslam_tpu_torch.ops.camera import Pinhole
    from xfeatslam_tpu_torch.optim import local_ba
    from xfeatslam_tpu_torch.optim.track_step import fetch
    from xfeatslam_tpu_torch.slam.loop_closing import LoopClosing
    from xfeatslam_tpu_torch.slam.settings import Settings
    from xfeatslam_tpu_torch.slam.system import Sensor, System
    from xfeatslam_tpu_torch.utils.synthetic import make_loop_map

    cam = Pinhole.from_list([517.3, 516.5, 318.6, 255.3])
    t0 = time.perf_counter()
    m, gt, est = make_loop_map(np.random.default_rng(0), n_kf=40, n_pts=1200,
                               period=36, revisit_tail=4, bf=40.0)
    print(f"loop: map of {m.num_keyframes()} keyframes, {m.num_points()} "
          f"points built in {time.perf_counter() - t0:.2f} s")
    lc = LoopClosing(m, cam, bf=40.0, fix_scale=True, confirmations=3,
                     run_gba=True, proj_matches=25, proj_matches_strict=30,
                     device=dev)
    walls = []
    for kid in sorted(m.keyframes):
        tw = time.perf_counter()
        lc.process_keyframe(kid)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - tw)

    def rmse(pose_t):
        return float(np.sqrt(np.mean([np.linalg.norm(pose_t(k) - gt[k][1])
                                      ** 2 for k in m.keyframes])))

    before = rmse(lambda k: est[k][1])
    after = rmse(lambda k: m.keyframes[k].t)
    gba = lc.ba_seconds
    report = {
        "closures": lc.closed, "detected": len(lc.detected),
        "sim3_extended_pairs": lc.n_sim3_extended,
        "ate_rmse_before_m": before, "ate_rmse_after_m": after,
        "jax_cpu_ate_rmse_after_m": JAX_LOOP_RMSE_AFTER,
        "ratio_to_jax": after / JAX_LOOP_RMSE_AFTER,
        "host_ms_per_keyframe": {
            "median": round(float(np.median(walls)) * 1e3, 4),
            "mean": round(float(np.mean(walls)) * 1e3, 4),
            "max": round(float(np.max(walls)) * 1e3, 4)},
        "gba_calls_ms": [(k, round(t * 1e3, 4), c) for k, t, c in gba],
    }
    print("loop: " + json.dumps(report))
    check(len(lc.closed) >= 1, "loop: no loop closed")
    check(after < before, "loop: the ATE RMSE did not fall")
    extra = []
    for _ in range(LOOP_EXTRA_GBAS):
        lc.global_bundle_adjust()
        extra.append(rmse(lambda k: m.keyframes[k].t))
    converged = extra[-1]
    print("loop: " + json.dumps({
        f"ate_rmse_after_{LOOP_EXTRA_GBAS}_more_gbas_m": converged,
        "ate_rmse_after_each_gba_m": extra,
        "jax_cpu_ate_rmse_converged_m": JAX_LOOP_RMSE_CONVERGED,
        "ratio_to_jax_converged": converged / JAX_LOOP_RMSE_CONVERGED}))
    check(converged <= LOOP_RMSE_FACTOR * JAX_LOOP_RMSE_CONVERGED,
          f"loop: ATE RMSE after {LOOP_EXTRA_GBAS} more GBAs {converged} m "
          f"above {LOOP_RMSE_FACTOR} x the JAX package's "
          f"{JAX_LOOP_RMSE_CONVERGED} m")

    # the GBA's last problem again: eager, replay, bit for bit; ms; kernels
    built = lc._build_gba(65536, 262144)
    check(built is not None, "loop: no GBA problem")
    prob = built[0]
    graph = lc._ba_graph
    eager = fetch(local_ba.bundle_adjust(prob, cam, 40.0,
                                         stage_iters=(10, 10)))
    replay = fetch(graph(prob, cam, 40.0, stage_iters=(10, 10)))
    same = all(np.array_equal(a, b) for a, b in zip(eager, replay))
    times = {
        "gba_eager_ms": cuda_ms(lambda: local_ba.bundle_adjust(
            prob, cam, 40.0, stage_iters=(10, 10)), iters=2, warmup=1),
        "gba_replay_ms": cuda_ms(lambda: graph(prob, cam, 40.0,
                                               stage_iters=(10, 10)),
                                 iters=5, warmup=1)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph(prob, cam, 40.0, stage_iters=(10, 10))
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA)
    print(f"loop GBA ({tuple(prob.R.shape)[0]} cameras, {prob.X.shape[0]} "
          f"points, {prob.obs_cam.shape[0]} observations, 20 LM "
          f"iterations): replay bit-identical to eager {same}; "
          f"{kernels} device events per replay; "
          + json.dumps({k: round(v, 4) for k, v in times.items()}))
    check(same, "loop: the GBA replay differs from the eager solve")
    ba_against_plain(ck, prob, cam, 40.0, (10, 10), "loop GBA")

    # the atlas through System.save_atlas / load_atlas
    settings = Settings(cam=cam, bf=40.0, depth_map_factor=1.0,
                        n_features=model_settings.n_features)
    a = System(settings, Sensor.RGBD, enable_loop_closing=True)
    m.map_id = a.map.map_id
    a.atlas.maps = {m.map_id: m}
    a.loop_closing.retrieval = lc.retrieval
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "loop.osa")
        a.save_atlas(path)
        b = System(settings, Sensor.RGBD, enable_loop_closing=True)
        b.load_atlas(path)
        size = os.path.getsize(path)
    mb = b.map
    n = m.points.n
    same_kfs = sorted(m.keyframes) == sorted(mb.keyframes) and all(
        np.array_equal(getattr(m.keyframes[k], f), getattr(mb.keyframes[k], f))
        for k in m.keyframes
        for f in ("R", "t", "kpts_un", "desc", "valid", "ur", "depth",
                  "mp_ids", "global_desc"))
    same_pts = n == mb.points.n and all(
        np.array_equal(getattr(m.points, f)[:n], getattr(mb.points, f)[:n])
        for f in ("pos", "desc", "alive")) and m.obs == mb.obs
    ra, rb = lc.retrieval, b.loop_closing.retrieval
    same_index = sorted(ra._index) == sorted(rb._index) and all(
        np.array_equal(ra.descs[ra._index[key]], rb.descs[rb._index[key]])
        for key in ra._index) and b.tracking.retrieval is rb
    print(f"loop atlas ({size} bytes) through save_atlas / load_atlas: "
          f"keyframes and poses equal {same_kfs}, points equal {same_pts}, "
          f"retrieval index equal {same_index}")
    check(same_kfs and same_pts and same_index,
          "loop: the atlas did not come back equal")


def full_ba_problem(cam, bf, dev, n_cams=32, n_pts=4096, per_point=4,
                    seed=0):
    """A full local-BA bucket (32 cameras, 4096 points, 16384
    observations), every slot valid: cameras on an arc, each point seen by
    4 of them with 0.5 px noise, 60% stereo, 10% outliers, perturbed
    starting poses and points, 3 cameras fixed."""
    from xfeatslam_tpu_torch.ops import lie
    from xfeatslam_tpu_torch.optim import local_ba as ba

    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    X = rng.uniform(-2.5, 2.5, (n_pts, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(3, 8, n_pts)
    Rs, ts = lie.se3_exp(torch.tensor(
        [[0.02 * i, 0.004 * i, 0.002 * i, 0.004 * i, 0.01 * i, 0.001 * i]
         for i in range(n_cams)]))
    Rs, ts = Rs.numpy(), ts.numpy()
    oc = np.stack([rng.choice(n_cams, per_point, replace=False)
                   for _ in range(n_pts)]).reshape(-1)
    op = np.repeat(np.arange(n_pts), per_point)
    Xc = np.einsum("oij,oj->oi", Rs[oc], X[op]) + ts[oc]
    u = fx * Xc[:, 0] / Xc[:, 2] + cx
    n = len(oc)
    uv = np.stack([u, fy * Xc[:, 1] / Xc[:, 2] + cy], -1)
    uv += rng.normal(0, 0.5, (n, 2))
    ur = u - bf / Xc[:, 2] + rng.normal(0, 0.5, n)
    stereo = rng.uniform(size=n) < 0.6
    uv[rng.choice(n, n // 10, replace=False)] += 40
    t0 = ts + rng.normal(0, 0.02, ts.shape)
    t0[:3] = ts[:3]
    fixed = np.arange(n_cams) < 3
    f = dict(R=Rs, t=t0, fixed=fixed, cam_valid=np.ones(n_cams, bool),
             X=X + rng.normal(0, 0.05, X.shape), p_valid=np.ones(n_pts, bool),
             obs_cam=oc.astype(np.int32), obs_pt=op.astype(np.int32), uv=uv,
             ur=np.where(stereo, ur, 0.0), stereo=stereo,
             valid=np.ones(n, bool), inv_sigma2=np.ones(n))
    f = {k: torch.from_numpy(np.asarray(
        v, np.float32 if np.asarray(v).dtype == np.float64 else None)).to(dev)
        for k, v in f.items()}
    prob = ba.BAProblem(**f)
    return prob._replace(plan=ba.segment_plan(
        prob.obs_cam, prob.obs_pt, prob.valid, n_cams, n_pts, dev))


def ba_gap(a, b, prob):
    """How far solve ``a`` lies from the reference solve ``b`` of ``prob``
    (BAResults, any device): poses, the inlier sets, the points that two
    or more of ``b``'s inlier observations determine ("constrained"),
    every point, and the chi2 of the observations both call inliers."""
    a, b = ({k: v.cpu().numpy() for k, v in r._asdict().items()}
            for r in (a, b))
    obs_pt = prob.obs_pt.cpu().numpy()
    stereo = prob.stereo.cpu().numpy()
    n_pts = len(b["X"])
    n_inl = np.bincount(obs_pt[b["inlier"]], minlength=n_pts)
    n_st = np.bincount(obs_pt[b["inlier"] & stereo], minlength=n_pts)
    c = (n_inl >= 2) & prob.p_valid.cpu().numpy()
    dX = np.linalg.norm(a["X"] - b["X"], axis=1)
    # the gap over the point's distance from the world origin (the first
    # camera's centre in a monocular initialization)
    rel = dX / np.maximum(np.linalg.norm(b["X"], axis=1), 1e-12)
    both = a["inlier"] & b["inlier"]
    dchi = np.abs(a["chi2"] - b["chi2"])[both]
    worst = int(np.argmax(np.where(c, dX, -1)))
    far = int(np.argmax(dX))
    return {
        "R": float(np.abs(a["R"] - b["R"]).max()),
        "t": float(np.abs(a["t"] - b["t"]).max()),
        "inliers_differ": int((a["inlier"] != b["inlier"]).sum()),
        "constrained": int(c.sum()),
        "X_constrained_max": float(dX[c].max()) if c.any() else 0.0,
        "X_constrained_over_2e-3": int((dX[c] > 2e-3).sum()),
        "X_constrained_rel_max": float(rel[c].max()) if c.any() else 0.0,
        "X_constrained_q99": float(np.quantile(dX[c], 0.99)) if c.any()
        else 0.0,
        # the constrained point that moved most: its inlier observations
        # (stereo among them) and its depth in the reference
        "X_constrained_worst": [worst, int(n_inl[worst]), int(n_st[worst]),
                                round(float(b["X"][worst, 2]), 3)],
        "X_all_max": float(dX.max()),
        # the point that moved most: its inlier count and its distance
        "X_all_worst": [far, int(n_inl[far]),
                        round(float(np.linalg.norm(b["X"][far])), 3)],
        "chi2_inlier_max": float(dchi.max()) if len(dchi) else 0.0,
        "chi2_within_1e-3_rel_1e-2_abs": bool(np.all(
            dchi <= 1e-2 + 1e-3 * np.abs(b["chi2"][both]))),
    }


def ba_on_cpu(ba, prob, cam, bf, si, planned: bool):
    """The same problem solved on the CPU: ``index_add_`` sums in
    observation order (the JAX package's), or with ``planned`` the card's
    order (the plan's sums) in the CPU's arithmetic."""
    cpu = ba.BAProblem(*(x.cpu() for x in prob[:-1]))
    if not planned:
        return ba.bundle_adjust(cpu, cam, bf, stage_iters=si)
    cpu = cpu._replace(plan=ba.SegmentPlan(*(x.cpu() for x in prob.plan)))
    saved = ba._planned
    ba._planned = lambda t: True
    try:
        return ba.bundle_adjust(cpu, cam, bf, stage_iters=si)
    finally:
        ba._planned = saved


def ba_against_plain(ck, prob, cam, bf, si, label, relative=False):
    """The BA kernels (``ck.local_ba``) against their plain twin
    (``ck.local_ba_plain``) on the card on one problem of a path, at the
    local-BA phase's bars: R and t within 1e-4, the same inliers, the
    points two or more inliers determine within 2e-3 m, or with
    ``relative`` within 2e-3 of their distance from the first camera (a
    monocular initialization fixes each depth by one short baseline, so a
    depth's uncertainty grows with its square; see
    tests/test_torch_slam_system.py::test_mono_initial_gba_matches_jax).
    Returns the gap (``ba_gap``)."""
    from xfeatslam_tpu_torch.optim import local_ba as ba

    a = ba.BAResult(*ck.local_ba(prob, cam, bf, stage_iters=si))
    b = ba.BAResult(*ck.local_ba_plain(prob, cam, bf, stage_iters=si))
    gap = ba_gap(a, b, prob)
    key = "X_constrained_rel_max" if relative else "X_constrained_max"
    print(f"{label}: the BA kernels against the plain twin on the card "
          f"({tuple(prob.R.shape)[0]} cameras, {prob.X.shape[0]} points, "
          f"{prob.obs_cam.shape[0]} observations, stage_iters={si}): "
          + json.dumps(gap))
    check(gap["R"] <= 1e-4 and gap["t"] <= 1e-4,
          f"{label}: BA poses differ from the plain twin's")
    check(gap["inliers_differ"] == 0,
          f"{label}: BA inliers differ from the plain twin's")
    check(gap["constrained"] > 0, f"{label}: no constrained BA point")
    check(gap[key] <= 2e-3,
          f"{label}: BA points differ from the plain twin's ({key} "
          f"{gap[key]})")
    return gap


def local_ba_bound(prob, stage_iters, cg_iters=40):
    """(bound ms, by) of one solve of ``prob``: each input and output once
    (the problem, its plan, the poses, points, inlier flags and chi2), and
    LOCAL_BA_OPS_PER_OBS_* float ops per valid observation in every LM
    iteration."""
    nbytes = sum(x.numel() * x.element_size() for x in prob[:-1]) + sum(
        x.numel() * x.element_size() for x in prob.plan)
    C, P, O = prob.R.shape[0], prob.X.shape[0], prob.obs_cam.shape[0]
    nbytes += (C * 12 + P * 3) * 4 + O * 5
    n_obs = int(prob.valid.sum())
    flops = n_obs * sum(stage_iters) * (
        cg_iters * LOCAL_BA_OPS_PER_OBS_CG_STEP + LOCAL_BA_OPS_PER_OBS_LM_ITER)
    return bound_ms(nbytes, flops)


def local_ba_phase(ck, problems, settings, dev):
    """Local BA on the card at the bucket's shapes (32 cameras, 4096
    points, 16384 observations): the SLAM run's last first-stage problem
    and a full bucket. For each and for both of local mapping's schedules,
    (5, 0) and (0, 5): the kernels' launches per solve from the wrapper's
    counter (at most LOCAL_BA_MAX_LAUNCHES for (5, 0)) and from
    torch.profiler; two eager solves bit-identical, the graph replay
    bit-identical to the eager solve; eager, capture and replay ms, the
    plain twin's ms (``cuda_kernels.local_ba_plain`` on the card). Then the
    kernels' solve against the plain twin's and against the CPU's solve
    of the same problem (``index_add_`` sums, the JAX package's order;
    ``tests/test_torch_local_ba.py`` holds that path to the JAX package):
    on the SLAM problem at the tests' bars (R and t within 1e-4, the same
    inliers, the constrained points within 2e-3). The full bucket is held
    to the poses and at most one inlier in 10,000 flipped: its points are
    seen by 4 of 32 cameras on a short arc, and those left with two mono
    inliers have a depth the problem does not fix. Five LM rounds of 40 CG
    steps leave them where the rounding took them, up to metres apart; the
    CPU moved from JAX's order to the plan's, and the JAX package against
    the port on the CPU in JAX's own order, show gaps of the same size
    there. The gaps against the CPU in the plan's order are printed too.
    Returns the report and the kernels-row numbers (the SLAM problem at
    (5, 0))."""
    from torch.profiler import ProfilerActivity, profile

    from xfeatslam_tpu_torch.optim import local_ba as ba

    cam, bf = settings.cam, settings.bf
    firsts = [p for stage, p in problems if stage == "first"]
    check(bool(firsts), "local BA: the SLAM run solved no first stage")
    cases = (("slam run's last", firsts[-1]),
             ("full bucket", full_ba_problem(cam, bf, dev)))
    report, row = {}, None
    for label, prob in cases:
        n_obs = int(prob.valid.sum())
        graph = ba.LocalBAGraph(dev)
        for si in ((5, 0), (0, 5)):
            def eager():
                return ba.bundle_adjust(prob, cam, bf, stage_iters=si)

            def plain():
                return ba.BAResult(*ck.local_ba_plain(prob, cam, bf, si))

            ck.reset_launch_counts()
            a = eager()
            torch.cuda.synchronize()
            launches = ck.local_ba.launches
            b = eager()
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            rep = graph(prob, cam, bf, stage_iters=si)
            g_same = all(torch.equal(x, y) for x, y in zip(a, rep))
            replays = []
            for _ in range(5):
                torch.cuda.synchronize()
                tw = time.perf_counter()
                graph(prob, cam, bf, stage_iters=si)
                torch.cuda.synchronize()
                replays.append(time.perf_counter() - tw)
            rep2 = graph(prob, cam, bf, stage_iters=si)
            g_same = g_same and all(torch.equal(x, y)
                                    for x, y in zip(a, rep2))
            e_ms = cuda_ms(eager, iters=5, warmup=1)
            p_ms = cuda_ms(plain, iters=2, warmup=1)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                eager()
                torch.cuda.synchronize()
            # the raw kineto records, as the other phases count them
            kernels = sum(1 for e in prof.profiler.kineto_results.events()
                          if e.device_type() == torch.autograd.DeviceType.CUDA)
            key = f"{label}, stage_iters={si}"
            b_ms, b_by = local_ba_bound(prob, si)
            report[key] = {
                "valid_observations": n_obs,
                "launches_per_solve": launches,
                "expected_launches": ck.local_ba_launches(si, 40),
                "device_events_per_solve": kernels,
                "eager_ms": round(e_ms, 4),
                "replay_ms": round(float(np.median(replays)) * 1e3, 4),
                "capture_ms": round(graph.capture_seconds[-1] * 1e3, 4),
                "plain_ms": round(p_ms, 4),
                "bound_ms": b_ms, "bound_by": b_by,
                "inliers": int(a.inlier.sum())}
            print(f"local BA [{key}]: {n_obs} valid observations; two eager "
                  f"solves bit-identical {same}; graph replay bit-identical "
                  f"to eager {g_same}; " + json.dumps(report[key]))
            check(launches == ck.local_ba_launches(si, 40),
                  f"local BA [{key}]: {launches} launches, expected "
                  f"{ck.local_ba_launches(si, 40)}")
            if si == (5, 0):
                check(launches <= LOCAL_BA_MAX_LAUNCHES,
                      f"local BA [{key}]: {launches} launches per round")
                check(kernels <= 8, f"local BA [{key}]: {kernels} device "
                      "events per round")
            check(same, f"local BA [{key}]: two eager solves differ")
            check(g_same, f"local BA [{key}]: the replay differs from the "
                  "eager solve")
            check(bool(torch.isfinite(a.X).all() & torch.isfinite(a.t).all()),
                  f"local BA [{key}]: non-finite result")
            gaps = {
                "the plain twin on the card": ba_gap(a, plain(), prob),
                "the CPU": ba_gap(a, ba_on_cpu(ba, prob, cam, bf, si,
                                               planned=False), prob)}
            gap_order = ba_gap(a, ba_on_cpu(ba, prob, cam, bf, si,
                                            planned=True), prob)
            report[key]["against"] = gaps
            print(f"local BA [{key}]: the kernels against "
                  + "; against ".join(f"{k}: {json.dumps(g)}"
                                      for k, g in gaps.items())
                  + "; against the CPU in the plan's order: "
                  + json.dumps(gap_order))
            for ref, gap in gaps.items():
                check(gap["R"] <= 1e-4 and gap["t"] <= 1e-4,
                      f"local BA [{key}]: poses differ from {ref}'s")
                if label == "full bucket":
                    check(gap["inliers_differ"] <= n_obs // 10000,
                          f"local BA [{key}]: inliers differ from {ref}'s")
                else:
                    check(gap["inliers_differ"] == 0,
                          f"local BA [{key}]: inliers differ from {ref}'s")
                    check(gap["X_constrained_max"] <= 2e-3,
                          f"local BA [{key}]: points differ from {ref}'s")
            if row is None:
                row = {"max_abs_err": max(gaps["the plain twin on the card"][k]
                                          for k in ("R", "t")),
                       "ms": e_ms, "device_ms": report[key]["replay_ms"],
                       "plain_ms": p_ms, "bound": (b_ms, b_by)}
    return report, row


def mono_phase(ck):
    """``System.track_monocular`` (loop closing off) on MONO_FRAMES rendered
    frames at 640x480, K=1000, the configuration of the JAX package's
    test_xfeat_mono_tracks_single_dispatch, held to its bars: the
    initializer succeeds, the last state OK and at least MONO_MIN_OK OK,
    at least 2 keyframes, at least MONO_MIN_CAPTURED frames through the
    captured step; counted, and the initial GBA (``_initial_gba``) must
    have launched the BA kernels, whose solve of its problem is then held
    to the plain twin's (``ba_against_plain``, relative bar). Prints each
    frame's state and host wall,
    the keyframes, and the keyframe trajectory's ATE against the rendered
    truth after a similarity alignment."""
    import tempfile

    from xfeatslam_tpu_torch.ops.camera import Pinhole
    from xfeatslam_tpu_torch.optim import local_ba
    from xfeatslam_tpu_torch.slam.settings import Settings
    from xfeatslam_tpu_torch.slam.system import Sensor, System
    from xfeatslam_tpu_torch.utils import io as io_utils
    from xfeatslam_tpu_torch.utils import synthetic

    seq = synthetic.make_sequence(n_frames=MONO_FRAMES)
    Km = seq["K"]
    settings = Settings(
        cam=Pinhole.from_list([Km[0, 0], Km[1, 1], Km[0, 2], Km[1, 2]]),
        fps=30.0, n_features=K)
    system = System(settings, Sensor.MONOCULAR, enable_loop_closing=False)
    tr = system.tracking
    gbas, gba_problems = [], []
    initial_gba, solve = tr._initial_gba, local_ba.bundle_adjust

    def recording(kf1, kf2):
        n0 = ck.local_ba.launches
        tw = time.perf_counter()
        initial_gba(kf1, kf2)
        gbas.append((ck.local_ba.launches - n0, time.perf_counter() - tw))

    def recording_solve(prob, cam, bf=0.0, stage_iters=(5, 10), **kw):
        if tuple(stage_iters) == (10, 10):
            gba_problems.append((prob, cam, bf))
        return solve(prob, cam, bf, stage_iters=stage_iters, **kw)

    tr._initial_gba = recording
    local_ba.bundle_adjust = recording_solve
    ck.reset_launch_counts()
    states, walls = [], []
    try:
        for i in range(MONO_FRAMES):
            tw = time.perf_counter()
            state, _ = system.track_monocular(seq["images"][i],
                                              seq["timestamps"][i])
            walls.append(time.perf_counter() - tw)
            states.append(state.name)
    finally:
        local_ba.bundle_adjust = solve
    counts = path_counts(ck, f"System.track_monocular, {MONO_FRAMES} frames",
                         SLAM_KERNELS)
    stats = system.shutdown()
    print(f"mono: states {states}; initial GBA (launches, host s) {gbas}")
    check(bool(gbas), "mono: the initializer did not succeed")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "KeyFrameTrajectory.txt")
        system.save_keyframe_trajectory_tum(path)
        est_t, est = io_utils.load_trajectory_tum(path)
    gt_xyz = np.stack([-R.T @ t for (R, t) in seq["poses"]])
    ate = io_utils.ate_rmse(np.asarray(seq["timestamps"]), gt_xyz, est_t,
                            est[:, :3], scale=True)
    # the orbit's extent, for scale
    extent = float(np.linalg.norm(gt_xyz - gt_xyz.mean(0), axis=1).max())
    report = {
        "states": states, "ok": states.count("OK"),
        "keyframes": system.map.num_keyframes(),
        "map_points": system.map.num_points(),
        "fused_grab": stats.get("fused_grab", 0),
        "initial_gba": [{"launches": n, "host_ms": round(t * 1e3, 4)}
                        for n, t in gbas],
        "wall_ms": [round(w * 1e3, 4) for w in walls],
        "wall_ms_median_from_frame_3": round(
            float(np.median(walls[3:])) * 1e3, 4),
        "keyframe_ate_rmse_sim3_m": ate,
        "keyframe_poses_aligned": len(est_t),
        "truth_extent_m": extent,
    }
    print(f"mono ({MONO_FRAMES} frames at {W}x{H}, K={K}): "
          + json.dumps(report))
    check(all(n == ck.local_ba_launches((10, 10), 40) for n, _ in gbas),
          "mono: the initial GBA did not run through the BA kernels")
    check(len(gba_problems) == len(gbas),
          "mono: the initial GBA's problem was not recorded")
    for prob, cam, bf in gba_problems:
        ba_against_plain(ck, prob, cam, bf, (10, 10), "mono initial GBA",
                         relative=True)
    check(states[-1] == "OK", f"mono: the last frame is {states[-1]}")
    check(states.count("OK") >= MONO_MIN_OK,
          f"mono: {states.count('OK')} frames OK")
    check(system.map.num_keyframes() >= 2, "mono: fewer than 2 keyframes")
    check(report["fused_grab"] >= MONO_MIN_CAPTURED,
          "mono: too few frames through the captured step")
    check(np.isfinite(ate), "mono: no keyframe trajectory to align")
    return counts


def _png_chunk(kind, body):
    import struct
    import zlib

    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path, px):
    """A minimal PNG writer: uint8 gray or RGB, or uint16 gray, row y
    filtered with type y % 5 (None, Sub, Up, Average, Paeth), so that the
    reader meets every filter."""
    import struct
    import zlib

    px = np.asarray(px)
    h, w = px.shape[:2]
    ch = 1 if px.ndim == 2 else px.shape[2]
    raw = (px.astype(">u2") if px.dtype == np.uint16 else px).reshape(h, -1)
    raw = raw.view(np.uint8).astype(np.int32)
    bpp = ch * px.dtype.itemsize
    a = np.pad(raw, ((0, 0), (bpp, 0)))[:, :-bpp]   # left
    b = np.pad(raw, ((1, 0), (0, 0)))[:-1]          # up
    c = np.pad(b, ((0, 0), (bpp, 0)))[:, :-bpp]     # up-left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    kind = (np.arange(h) % 5)[:, None]
    pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                     [a, b, (a + b) >> 1, paeth], 0)
    rows = np.concatenate([kind, (raw - pred) & 0xFF], 1).astype(np.uint8)
    color = {1: 0, 3: 2}[ch]
    ihdr = struct.pack(">IIBBBBB", w, h, 8 * px.dtype.itemsize, color, 0, 0,
                       0)
    data = zlib.compress(rows.tobytes())
    # the image data in two IDAT chunks
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", data[:len(data) // 2])
                + _png_chunk(b"IDAT", data[len(data) // 2:])
                + _png_chunk(b"IEND", b""))


def run_example(tag, mod, args, out):
    """An example's ``main`` as a user runs it, its output kept to the
    timing lines; fails the run on a non-zero exit."""
    import io

    buf = io.StringIO()
    tw = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(args + ["--out", out])
    wall = time.perf_counter() - tw
    tail = [ln for ln in buf.getvalue().splitlines() if "tracking time" in ln]
    print(f"{tag}: {mod.__name__.rsplit('.', 1)[1]} exit {rc} in "
          f"{wall:.2f} s; " + "; ".join(tail))
    check(rc == 0, f"{tag}: {mod.__name__} exited {rc}")


def readers_phase(root):
    """The dataset readers on a TUM-layout sequence this phase writes
    (READER_FRAMES rendered frames: rgb/*.png 8-bit RGB, depth/*.png
    16-bit at 5000 per metre, rgb.txt, depth.txt, an association file and
    an OpenCV-YAML settings file with the rendered camera), through the
    port's examples as a user runs them: ``rgbd_tum`` in its dataset mode
    (every frame's pose written, the camera trajectory within 1 cm of the
    truth after a rigid alignment) and the ``mono_tum`` twin (at least two
    keyframes written). The sequence stays in ``root`` for the ORB phase;
    returns (the settings file, the sequence)."""
    from xfeatslam_tpu_torch.examples import mono_tum, rgbd_tum
    from xfeatslam_tpu_torch.utils import io as io_utils
    from xfeatslam_tpu_torch.utils import png, synthetic

    seq = synthetic.make_sequence(n_frames=READER_FRAMES)
    Km = seq["K"]
    bf, th_depth, factor = 40.0, 3.0, 5000.0
    yaml = "\n".join([
        "%YAML:1.0", "# the rendered room's camera", 'File.version: "1.0"',
        'Camera.type: "PinHole"', f"Camera1.fx: {Km[0, 0]}",
        f"Camera1.fy: {Km[1, 1]}", f"Camera1.cx: {Km[0, 2]}",
        f"Camera1.cy: {Km[1, 2]}", f"Camera.width: {W}",
        f"Camera.height: {H}", "Camera.fps: 30", "Camera.RGB: 1",
        f"Stereo.ThDepth: {th_depth * Km[0, 0] / bf}",
        f"Stereo.b: {bf / Km[0, 0]}", f"RGBD.DepthMapFactor: {factor}",
        f"ORBextractor.nFeatures: {K}", "ORBextractor.scaleFactor: 1.2",
        "ORBextractor.nLevels: 8", "ORBextractor.iniThFAST: 20",
        "ORBextractor.minThFAST: 7", ""])
    gt_xyz = np.stack([-R.T @ t for (R, t) in seq["poses"]])
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, sub))
    lines = {"rgb": [], "depth": [], "assoc": []}
    t0 = time.perf_counter()
    for i in range(READER_FRAMES):
        t = f"{seq['timestamps'][i]:.6f}"
        name = f"{i:06d}.png"
        gray = seq["images"][i]
        write_png(os.path.join(root, "rgb", name),
                  np.repeat(gray[..., None], 3, -1))
        depth = np.round(seq["depths"][i] * factor).astype(np.uint16)
        write_png(os.path.join(root, "depth", name), depth)
        check(np.array_equal(png.read_gray(os.path.join(
            root, "rgb", name)), gray), "readers: a gray frame read back "
            "differs")
        check(np.array_equal(png.read(os.path.join(
            root, "depth", name)), depth), "readers: a depth frame read "
            "back differs")
        lines["rgb"].append(f"{t} rgb/{name}")
        lines["depth"].append(f"{t} depth/{name}")
        lines["assoc"].append(f"{t} rgb/{name} {t} depth/{name}")
    for key, fname in (("rgb", "rgb.txt"), ("depth", "depth.txt"),
                       ("assoc", "associations.txt")):
        with open(os.path.join(root, fname), "w") as f:
            f.write("# written by chip_smoke.py\n"
                    + "\n".join(lines[key]) + "\n")
    cfg = os.path.join(root, "room.yaml")
    with open(cfg, "w") as f:
        f.write(yaml)
    print(f"readers: {READER_FRAMES} frames written as PNG and read back "
          f"equal in {time.perf_counter() - t0:.2f} s")
    check(len(io_utils.associate_tum(root)) == READER_FRAMES,
          "readers: rgb.txt and depth.txt did not associate")

    out = os.path.join(root, "out_rgbd")
    run_example("readers", rgbd_tum,
                [cfg, root, os.path.join(root, "associations.txt")], out)
    est_t, est = io_utils.load_trajectory_tum(
        os.path.join(out, "CameraTrajectory.txt"))
    kf_t, _ = io_utils.load_trajectory_tum(
        os.path.join(out, "KeyFrameTrajectory.txt"))
    ate = io_utils.ate_rmse(np.asarray(seq["timestamps"]), gt_xyz,
                            est_t, est[:, :3])
    print(f"readers: rgbd_tum wrote {len(est_t)} camera poses and "
          f"{len(kf_t)} keyframes; ATE RMSE {ate * 1e3:.4f} mm")
    check(len(est_t) == READER_FRAMES and len(kf_t) >= 1,
          "readers: rgbd_tum's trajectories are incomplete")
    check(ate < 0.01, "readers: rgbd_tum's trajectory is off by >= 1 cm")

    out = os.path.join(root, "out_mono")
    run_example("readers", mono_tum, [cfg, root], out)
    kf_t, kf = io_utils.load_trajectory_tum(
        os.path.join(out, "KeyFrameTrajectory.txt"))
    check(len(kf_t) >= 2,
          f"readers: mono_tum wrote {len(kf_t)} keyframes")
    ate = io_utils.ate_rmse(np.asarray(seq["timestamps"]), gt_xyz,
                            kf_t, kf[:, :3], scale=True)
    print(f"readers: mono_tum wrote {len(kf_t)} keyframes; "
          f"similarity-aligned ATE RMSE {ate * 1e3:.4f} mm")
    check(np.isfinite(kf).all(),
          "readers: mono_tum's keyframe trajectory is not finite")
    return cfg, seq


def stage_events(fn):
    """The device events (kernels and copies) of one call of ``fn``, from
    ``torch.profiler``'s raw kineto records: their count, their summed
    device ms, and the three names with the most device ms (name's first
    60 characters, calls, ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in dev:
        n, ns = by_name.get(e.name(), (0, 0))
        by_name[e.name()] = (n + 1, ns + e.duration_ns())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:3]
    return (len(dev), sum(e.duration_ns() for e in dev) / 1e6,
            [(name[:60], n, round(ns / 1e6, 4)) for name, (n, ns) in top])


def _orb_keyed(o):
    """An extractor output's valid keypoints keyed by (octave, pixel at
    that level) -> row (the sub-pixel offset follows the FAST response,
    which the resized levels move by ~1e-4)."""
    v = o["valid"][0]
    lvl_xy = o["kpts"][0][v] / 1.2 ** o["octave"][0][v][:, None]
    return {(int(oc), tuple(np.round(p).astype(np.int64))): i
            for i, (p, oc) in enumerate(zip(lvl_xy, o["octave"][0][v]))}


def _mask_jaccard(a, b):
    a, b = a.cpu().numpy() >= 0, b.cpu().numpy() >= 0
    return float((a & b).sum() / max((a | b).sum(), 1))


def _orb_fast_equal(ck, img0, sizes, edge):
    """``orb_fast`` against its plain twin on ``img0``: (every level's
    image, scores and masked maps equal bit for bit, the counts equal), the
    kernel's outputs."""
    out = ck.orb_fast(img0, sizes, 20.0, 7.0, edge)
    ref = ck.orb_fast_plain(img0, sizes, 20.0, 7.0, edge)
    torch.cuda.synchronize()
    lk, lp = ck.level_views(out[0], sizes), ck.level_views(ref[0], sizes)
    same = [torch.equal(lk[i], lp[i]) and torch.equal(out[1][i], ref[1][i])
            and torch.equal(out[2][i], ref[2][i]) for i in range(len(sizes))]
    return same, torch.equal(out[3], ref[3]), out


def orb_odd_shape_checks(ck, orb, dev):
    """The two ORB kernels against their twins where their indexing is
    hardest: levels narrower than a tile (a 40x24 frame), a portrait frame whose levels resize W first
    (72x40), integer corners on the wrap seam of a 64x80 frame (a bright
    blob at x=1 whose circle wraps to the right edge, one at the frame's
    corner) and its resized levels, whose tiles' halos wrap on both axes,
    and levels smaller than the halo (7x5, wrapped more than once); then
    ``orb_describe`` on a frame and one resized level with keypoints at the
    corners, 15 px from them, on the last row and column, and padding
    slots (flag off, keypoint (0, 0)), and on the same levels less 128
    (negative pixels: every pair from the float64 blur)."""
    rng = np.random.default_rng(5)
    seam = np.full((64, 80), 40.0, np.float32)
    for y, x in ((32, 1), (0, 0), (63, 79), (20, 78)):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                seam[(y + dy) % 64, (x + dx) % 80] = 220.0
    cases = {
        "40x24": (rng.integers(0, 256, (40, 24)), [(40, 24), (33, 20),
                                                    (28, 17)]),
        "72x40 (W first)": (rng.integers(0, 256, (72, 40)),
                            [(72, 40), (60, 33), (50, 28)]),
        "64x80 seam": (seam, [(64, 80), (53, 67), (44, 56)]),
        "7x5": (rng.integers(0, 256, (7, 5)), [(7, 5), (6, 4), (5, 3)]),
    }
    bad = []
    for name, (img, sizes) in cases.items():
        x0 = torch.from_numpy(np.asarray(img, np.float32)).to(dev)
        same, counts, out = _orb_fast_equal(ck, x0, sizes, 2)
        if not (all(same) and counts):
            bad.append((name, same, counts))
        if name == "64x80 seam":
            seam_out = out
    print(f"orb_fast odd shapes ({', '.join(cases)}; {ck.ORB_FAST_TILE} "
          f"tiles): levels, scores, survivors "
          f"and counts equal to the plain twin except {bad}; seam frame "
          f"corners at t1 {int((seam_out[1][0][1] > 0).sum())}, survivors "
          f"{int((seam_out[2][0][1] >= 0).sum())}")
    check(not bad, "orb_fast differs from its plain twin at odd shapes")
    img = torch.from_numpy(rng.integers(0, 256, (64, 80)).astype(
        np.float32)).to(dev)
    lv, _, _, _ = ck.orb_fast(img, [(64, 80), (53, 67)], 20.0, 7.0, 2)
    levels = ck.level_views(lv, [(64, 80), (53, 67)])
    kps, vas = [], []
    for h, w in ((64, 80), (53, 67)):
        kps.append(torch.tensor(
            [[0.0, 0.0], [w - 1.0, h - 1.0], [15.0, 15.0],
             [w - 16.0, h - 16.0], [15.9, h / 2 + 0.2], [w - 1.0, 15.0],
             [w / 2 + 0.99, h - 1.0], [0.0, h - 1.0], [-3.0, h + 4.0],
             [0.0, 0.0], [0.0, 0.0]], device=dev))
        va = torch.ones(kps[-1].shape[0], dtype=torch.bool, device=dev)
        va[-3:] = False
        vas.append(va)
    # the same keypoints on levels shifted below 0, whose pairs all take
    # the kernel's float64 blur
    for label, lv_in in (("", levels), (", levels - 128", [
            (x - 128.0).contiguous() for x in levels])):
        dk = ck.orb_describe(lv_in, kps, vas)
        dp = ck.orb_describe_plain(lv_in, kps, vas)
        torch.cuda.synchronize()
        l0 = (torch.equal(dk[0][1], dp[0][1])
              and torch.equal(dk[0][0], dp[0][0]))
        gap = float((dk[1][1] - dp[1][1]).abs().max())
        bits = float((dk[1][0] == dp[1][0]).float().mean())
        print(f"orb_describe odd keypoints{label} (at the corners, 15 px "
              f"from them, on the last row and column, outside the level, "
              f"three padding slots): level 0 angles and bits equal to the "
              f"plain twin {l0}; resized level max angle gap {gap:.3e}, "
              f"bits equal {bits}")
        check(l0 and gap <= 1e-4 and bits >= 0.999,
              f"orb_describe differs from its plain twin at odd "
              f"keypoints{label}")


def orb_fast_work(ck, H0, W0, sizes):
    """(bytes, float32 ops, float64 ops) of ``orb_fast`` on one frame: the
    frame read once, each level pixel's image, scores and masked values
    written once (20 B) and the counts; ORB_FAST_OPS_PER_PIXEL per level
    pixel; and the resize's taps (``image.resize_bilinear``'s: the first
    axis over the frame's other axis, the second over the level), a
    multiply and an add each."""
    from xfeatslam_tpu_torch.ops import image

    npx = sum(h * w for h, w in sizes)
    taps = 0
    for h, w in sizes[1:]:
        th = int(ck.orb_axis_arrays(H0, h)[1].sum())  # taps over all rows
        tw = int(ck.orb_axis_arrays(W0, w)[1].sum())
        taps += (th * W0 + tw * h if image.resize_h_first(H0, W0, h, w)
                 else tw * H0 + th * w)
    return (H0 * W0 * 4 + npx * 20 + 4 * len(sizes),
            ORB_FAST_OPS_PER_PIXEL * npx, 2 * taps)


def orb_describe_work(orb, sizes, kp_d, va_d, angles, pattern):
    """(bytes, float32 ops, float64 ops, distinct positions) that
    ``orb_describe`` must do on this run's keypoints: per level the union
    of the in-level pixels it reads, the discs at the distinct integer
    keypoint positions (the padding slots share one) and the 7x7 windows
    at the distinct rotated sample positions of the valid slots, 4 bytes
    each; per slot its keypoint (8), flag (1), bits (1024) and angle (4);
    the pattern once. The operations: the disc's moments per distinct
    position, and per valid slot the rotation of each distinct pattern
    point and the blur at each distinct sample position (the samples that
    coincide after the rotation blurred once)."""
    mask, dxs, dys = orb._circle_mask(orb.PATCH_RADIUS)
    on = mask > 0
    dev = pattern.device
    dx = torch.as_tensor(dxs[on], device=dev)
    dy = torch.as_tensor(dys[on], device=dev)
    wy, wx = (torch.as_tensor(a.reshape(-1), device=dev)
              for a in np.mgrid[-3:4, -3:4])
    pts = torch.unique(pattern.reshape(-1, 2), dim=0)
    nbytes, n_pos, f32, f64 = pattern.numel() * 4, 0, 0, 0
    for (h, w), k, v, a in zip(sizes, kp_d, va_d, angles):
        if k.shape[0] == 0:
            continue
        xi = k[:, 0].to(torch.int32).clamp(0, w - 1).long()
        yi = k[:, 1].to(torch.int32).clamp(0, h - 1).long()
        pos = torch.unique(yi * w + xi)
        px, py = pos % w, pos // w
        gx, gy = px[:, None] + dx[None], py[:, None] + dy[None]
        inside = (gx >= 0) & (gx < w) & (gy >= 0) & (gy < h)
        read = [(gy * w + gx)[inside]]
        ca, sa = torch.cos(a[v])[:, None], torch.sin(a[v])[:, None]
        qx, qy = pts[None, :, 0], pts[None, :, 1]
        sx = (xi[v][:, None] + torch.round(ca * qx - sa * qy).long()).clamp(
            0, w - 1)
        sy = (yi[v][:, None] + torch.round(sa * qx + ca * qy).long()).clamp(
            0, h - 1)
        samples = sy * w + sx  # (valid slots, distinct points)
        srt = samples.sort(1).values
        n_samples = int((srt[:, 1:] != srt[:, :-1]).sum()) + srt.shape[0]
        uniq = torch.unique(samples)
        ux, uy = uniq % w, uniq // w
        bx, by = ux[:, None] + wx[None], uy[:, None] + wy[None]
        inb = (bx >= 0) & (bx < w) & (by >= 0) & (by < h)
        read.append((by * w + bx)[inb])
        nbytes += torch.unique(torch.cat(read)).numel() * 4
        nbytes += k.shape[0] * (8 + 1 + 256 * 4 + 4)
        n_pos += pos.numel()
        f64 += ORB_DISC_OPS_PER_POSITION * pos.numel()
        f64 += ORB_BLUR_OPS_PER_SAMPLE * n_samples
        f32 += int(v.sum()) * (ORB_DESCRIBE_OPS_PER_SAMPLE * len(pts) + 256)
    return nbytes, f32, f64, n_pos


def orb_kernel_checks(ck, orb, x_dev, sizes, kp_d, va_d):
    """``csrc/orb_fast.cu`` and ``csrc/orb_describe.cu`` against their
    plain twins on the card, on one 640x480 frame and the extractor's
    keypoints: ``orb_fast`` bit for bit at every level (the level images,
    which must be ``image.resize_bilinear``'s, the scores, the masked maps
    and the counts); ``orb_describe`` on the
    kernel's levels, level 0 exact (angles and bits), the other levels'
    angles within 1e-4 rad and >= 0.999 of the bits; then the odd shapes;
    then each kernel's times (CUDA events, device by graph replay), the
    twin's, the moment convolutions' (the library call for orb_describe)
    and the bounds. Returns the two
    kernels' rows."""
    dev = x_dev.device
    thr = (20.0, 7.0)
    H0, W0 = x_dev.shape
    same, counts, out = _orb_fast_equal(ck, x_dev, sizes, orb.EDGE)
    lv, sk = out[0], out[1]
    ref = ck.orb_fast_plain(x_dev, sizes, *thr, orb.EDGE)
    fast_err = max(float((a - b).abs().max()) for a, b in zip(sk, ref[1]))
    print(f"orb_fast against its plain twin ({len(sizes)} levels built from "
          f"the frame, one launch): levels, scores and survivors equal per "
          f"level {same}, counts equal {counts}; counts {ref[3].tolist()}")
    check(all(same) and counts, "orb_fast differs from its plain twin")
    levels = ck.level_views(lv, sizes)
    dk = ck.orb_describe(levels, kp_d, va_d)
    dp = ck.orb_describe_plain(levels, kp_d, va_d)
    torch.cuda.synchronize()
    gaps = [float((a[1] - b[1]).abs().max()) if a[1].numel() else 0.0
            for a, b in zip(dk, dp)]
    bits = [float((a[0] == b[0]).float().mean()) if a[0].numel() else 1.0
            for a, b in zip(dk, dp)]
    l0 = torch.equal(dk[0][1], dp[0][1]) and torch.equal(dk[0][0], dp[0][0])
    print(f"orb_describe against its plain twin ({sum(k.shape[0] for k in kp_d)}"
          f" keypoint slots, one launch, from orb_fast's levels): level 0 "
          f"angles and bits equal {l0}; max angle gap per level "
          f"{[f'{g:.3e}' for g in gaps]}, bits equal per level {bits}")
    check(l0, "orb_describe: level 0 differs from its plain twin")
    check(max(gaps) <= 1e-4 and min(bits) >= 0.999,
          "orb_describe: angles or bits part from the plain twin")
    orb_odd_shape_checks(ck, orb, dev)

    fast = lambda: ck.orb_fast(x_dev, sizes, *thr, orb.EDGE)  # noqa: E731
    desc = lambda: ck.orb_describe(levels, kp_d, va_d)  # noqa: E731
    times = {
        "orb_fast_ms": cuda_ms(fast),
        "orb_fast_device_ms": graph_ms(fast),
        "orb_fast_plain_ms": cuda_ms(
            lambda: ck.orb_fast_plain(x_dev, sizes, *thr, orb.EDGE), iters=5,
            warmup=1),
        "orb_describe_ms": cuda_ms(desc),
        "orb_describe_device_ms": graph_ms(desc),
        "orb_describe_plain_ms": cuda_ms(
            lambda: ck.orb_describe_plain(levels, kp_d, va_d),
            iters=5, warmup=1),
        # the two 31x31 moment convolutions per level, which compute the
        # same moments at every pixel
        "moment_convs_ms": cuda_ms(
            lambda: [orb.orientation_maps(x) for x in levels], iters=5,
            warmup=1),
    }
    fast_bytes, fast_f32, fast_f64 = orb_fast_work(ck, H0, W0, sizes)
    desc_bytes, desc_f32, desc_f64, n_pos = orb_describe_work(
        orb, sizes, kp_d, va_d, [a[1] for a in dk],
        torch.from_numpy(orb._PATTERN.astype(np.float32)).to(dev))
    n_slots = sum(k.shape[0] for k in kp_d)
    print(f"orb kernels' work on this frame: orb_fast {fast_bytes} bytes, "
          f"{fast_f32} float32 and {fast_f64} float64 ops (the resize's "
          f"taps); orb_describe {n_slots} slots at {n_pos} distinct "
          f"positions, {desc_bytes} bytes, {desc_f32} float32 and "
          f"{desc_f64} float64 ops")
    bounds = {
        "orb_fast": bound_ms(fast_bytes, fast_f32, fast_f64),
        "orb_describe": bound_ms(desc_bytes, desc_f32, desc_f64),
    }
    print("orb kernel timings (640x480, 1000 features; CUDA events, device "
          "alone by graph replay): " + json.dumps(
              {k: round(v, 5) for k, v in times.items()})
          + f"; bounds {json.dumps(bounds)}")
    return {
        "orb_fast": {"max_abs_err": fast_err, "ms": times["orb_fast_ms"],
                     "device_ms": times["orb_fast_device_ms"],
                     "plain_ms": times["orb_fast_plain_ms"],
                     "bound": bounds["orb_fast"], "library_ms": None},
        "orb_describe": {"max_abs_err": max(gaps), "bits_equal": min(bits),
                         "ms": times["orb_describe_ms"],
                         "device_ms": times["orb_describe_device_ms"],
                         "plain_ms": times["orb_describe_plain_ms"],
                         "bound": bounds["orb_describe"],
                         "library_ms": times["moment_convs_ms"]},
    }


def orb_extractor_phase(ck):
    """The ORB extractor on the card against the port's own CPU run of one
    rendered 640x480 frame (tests/test_torch_orb.py's bars: level-0
    candidates and their quadtree selection equal, per-level keypoint
    Jaccard >= ORB_LEVEL_JACCARD, >= 99% of the shared keypoints'
    descriptor bits; the levels that ``orb_fast`` builds equal the CPU's
    bit for bit), each stage's graph replay against the eager call on the
    card bit for bit, the two kernels against their twins
    (``orb_kernel_checks``), one launch of each per extractor call, and
    the stages' times: candidates and describe by replay (CUDA events,
    with the stage's device events, busy ms and costliest kernels from
    ``torch.profiler``, beside those of commit 5e60de8, which resized the
    levels in both stages and blurred them by cuDNN), the quadtree on the
    host, the whole
    call. Returns the timings and the kernels' rows."""
    from xfeatslam_tpu_torch import _build
    from xfeatslam_tpu_torch.models import orb
    from xfeatslam_tpu_torch.optim.track_step import fetch
    from xfeatslam_tpu_torch.utils import synthetic

    t0 = time.perf_counter()
    _build.load_host("quadtree")
    print(f"orb: quadtree {_build.host_library_path('quadtree').name} "
          f"built and loaded in {time.perf_counter() - t0:.2f} s (g++)")
    img = synthetic.make_sequence(n_frames=1)["images"][0]
    card = orb.ORBExtractor(nfeatures=K)
    cpu = orb.ORBExtractor(nfeatures=K, device="cpu")
    sizes, caps, mins = card.geometry(*img.shape)
    thr = (card.ini_threshold, card.min_threshold)
    x_cpu = torch.from_numpy(img.astype(np.float32))
    x_dev = x_cpu.cuda()
    rep, lv_rep = card.candidates(x_cpu, sizes, caps, mins)
    rep, lv_dev = fetch(rep), lv_rep.clone()
    eager, lv_eager = orb.orb_candidates(x_dev, sizes, caps, mins, *thr)
    eager = fetch(eager)
    ref, lv_ref = orb.orb_candidates(x_cpu, sizes, caps, mins, *thr)
    ref = [tuple(a.numpy() for a in lvl) for lvl in ref]
    check(all(np.array_equal(a, b) for la, lb in zip(rep, eager)
              for a, b in zip(la, lb)),
          "orb: the candidates' replay differs from the eager call")
    check(all(np.array_equal(a, b) for a, b in zip(rep[0], ref[0])),
          "orb: level-0 candidates (xy, score, valid, order) differ from "
          "the CPU's")
    jac = [round(jaccard(pixel_set(rep[lvl][0], rep[lvl][2]),
                         pixel_set(ref[lvl][0], ref[lvl][2])), 4)
           for lvl in range(len(sizes))]
    # the levels orb_fast built on the card against the CPU's resize: the
    # same weights and the same exactly rounded float64 chain, so the same
    # bits (by replay and eagerly)
    level_gap = [float((a.cpu() - b).abs().max()) for a, b in zip(
        ck.level_views(lv_dev, sizes), ck.level_views(lv_ref, sizes))]
    check(max(level_gap) == 0.0 and torch.equal(lv_dev, lv_eager),
          "orb: the card's levels differ from the CPU's by up to "
          f"{max(level_gap)}, or the replay's from the eager call's")
    kp_c, va_c, keep_c = card.select(rep, sizes)
    kp_r, va_r, _ = cpu.select(ref, sizes)
    check(np.array_equal(kp_c[0].numpy(), kp_r[0].numpy())
          and np.array_equal(va_c[0].numpy(), va_r[0].numpy()),
          "orb: the level-0 quadtree selection differs from the CPU's")
    kp_d = [k.cuda() for k in kp_c]
    va_d = [v.cuda() for v in va_c]
    d_rep = fetch(card.descriptors(lv_dev, sizes, kp_d, va_d))
    d_eager = fetch(orb.orb_describe_all(lv_dev, sizes, kp_d, va_d))
    check(all(np.array_equal(a, b) for la, lb in zip(d_rep, d_eager)
              for a, b in zip(la, lb)),
          "orb: the descriptors' replay differs from the eager call")
    rows = orb_kernel_checks(ck, orb, x_dev, sizes, kp_d, va_d)
    ck.reset_launch_counts()
    out_c = card(img)
    path_counts(ck, "ORBExtractor call", {"orb_fast": 1, "orb_describe": 1})
    out_r = cpu(img)
    kc, kr = _orb_keyed(out_c), _orb_keyed(out_r)
    lvl_j = []
    for lvl in range(len(sizes)):
        a = {k for k in kc if k[0] == lvl}
        b = {k for k in kr if k[0] == lvl}
        lvl_j.append(round(jaccard(a, b), 4))
    shared = sorted(set(kc) & set(kr))
    bits = float((out_c["desc"][0][out_c["valid"][0]][[kc[k] for k in shared]]
                  == out_r["desc"][0][out_r["valid"][0]][[kr[k] for k in shared]]
                  ).mean())
    n_valid = int(out_c["valid"].sum())
    print(f"orb: {W}x{H}, {len(sizes)} levels {list(sizes)}; card against "
          f"CPU: level-0 candidates equal (xy, score, valid, order), "
          f"candidate Jaccard per level {jac}, level-0 quadtree selection "
          f"equal; extractor {n_valid} keypoints (CPU "
          f"{int(out_r['valid'].sum())}), keypoint Jaccard per level "
          f"{lvl_j}, descriptor bits equal {bits:.6f} on {len(shared)} "
          f"shared keypoints; both stages' replays bit-identical to the "
          f"eager calls; level images max |card - CPU| "
          f"{[f'{g:.3e}' for g in level_gap]}")
    check(lvl_j[0] == 1.0 and min(jac) >= ORB_LEVEL_JACCARD
          and min(lvl_j) >= ORB_LEVEL_JACCARD,
          "orb: card and CPU keypoints part beyond the test bars")
    check(bits >= 0.99, "orb: descriptor bits part beyond the test bar")
    check(n_valid >= 0.9 * K, f"orb: only {n_valid} keypoints")

    def qt():
        t = time.perf_counter()
        card.select(rep, sizes)
        return (time.perf_counter() - t) * 1e3

    def whole():
        t = time.perf_counter()
        card(img)
        return (time.perf_counter() - t) * 1e3

    for _ in range(3):
        whole()
    ev_c, busy_c, top_c = stage_events(
        lambda: card.candidates(x_dev, sizes, caps, mins))
    ev_d, busy_d, top_d = stage_events(
        lambda: card.descriptors(lv_dev, sizes, kp_d, va_d))
    report = {
        "candidates_replay_ms": round(cuda_ms(
            lambda: card.candidates(x_dev, sizes, caps, mins)), 4),
        "candidates_device_events": ev_c,
        "candidates_device_busy_ms": round(busy_c, 4),
        "candidates_top_kernels": top_c,
        "candidates_eager_ms": round(cuda_ms(
            lambda: orb.orb_candidates(x_dev, sizes, caps, mins, *thr),
            iters=5, warmup=1), 4),
        "quadtree_host_ms": round(float(np.median([qt() for _ in range(20)])),
                                  4),
        "describe_replay_ms": round(cuda_ms(
            lambda: card.descriptors(lv_dev, sizes, kp_d, va_d)), 4),
        "describe_device_events": ev_d,
        "describe_device_busy_ms": round(busy_d, 4),
        "describe_top_kernels": top_d,
        "describe_eager_ms": round(cuda_ms(
            lambda: orb.orb_describe_all(lv_dev, sizes, kp_d, va_d),
            iters=5, warmup=1), 4),
        "extractor_call_wall_ms": round(float(np.median(
            [whole() for _ in range(20)])), 4),
        "capture_s": [round(t, 3) for g in card._graphs or ()
                      for t in g.capture_seconds],
    }
    print(f"orb extractor timings ({W}x{H}, K={K}; CUDA events, "
          "host wall for the quadtree and the whole call): "
          + json.dumps(report))
    print(f"orb stages by replay: candidates {report['candidates_replay_ms']}"
          f" ms in {ev_c} device events (the levels resized in the stage: "
          f"{RESIZING_CANDIDATES[0]} ms, {RESIZING_CANDIDATES[1]} events; "
          f"tensor ops before the kernels: {TENSOR_OPS_CANDIDATES[0]} ms, "
          f"{TENSOR_OPS_CANDIDATES[1]} events); describe "
          f"{report['describe_replay_ms']} ms in {ev_d} device events (the "
          f"levels resized and blurred in the stage: "
          f"{RESIZING_DESCRIBE[0]} ms, {RESIZING_DESCRIBE[1]} events; tensor "
          f"ops: "
          f"{TENSOR_OPS_DESCRIBE[0]} ms, {TENSOR_OPS_DESCRIBE[1]} events)")
    return report, rows


def _orb_map_equal(a, b):
    """Two Systems' maps bit for bit: keyframe poses and bindings, every
    point's position, descriptor and liveness."""
    ma, mb = a.map, b.map
    if sorted(ma.keyframes) != sorted(mb.keyframes):
        return False
    for k, ka in ma.keyframes.items():
        kb = mb.keyframes[k]
        if not (np.array_equal(ka.R, kb.R) and np.array_equal(ka.t, kb.t)
                and np.array_equal(ka.mp_ids, kb.mp_ids)):
            return False
    n = ma.points.n
    return n == mb.points.n and all(
        np.array_equal(getattr(ma.points, f)[:n], getattr(mb.points, f)[:n])
        for f in ("pos", "desc", "alive"))


def orb_slam_phase(ck):
    """``System(backend="orb").track_rgbd`` on the rendered sequence at
    640x480 with the bars of the JAX package's ORB tests
    (test_slam_integration.py): 14 frames with loop closing off (every
    frame OK, max < 1 cm, median < 5 mm, >= 1 keyframe); 40 frames with
    loop closing on, twice in one process, the counters zeroed before each
    (every frame OK, max < 3 cm, >= 3 keyframes, no loop, >= ORB_MIN_TRACKED
    frames through the tracking stages' graph, the second run's poses and
    map bit-identical to the first's). The second run replays the first's
    graphs: its wall per frame, spans and launches (pose_lm 2 per
    graph-tracked frame, local_ba 1 per BA round, no XFeat kernel).
    Returns the second run's launch counts."""
    from xfeatslam_tpu_torch.ops.camera import Pinhole
    from xfeatslam_tpu_torch.slam.settings import Settings
    from xfeatslam_tpu_torch.utils import synthetic

    seq = synthetic.make_sequence(n_frames=ORB_FRAMES_LONG)
    Km = seq["K"]
    settings = Settings(
        cam=Pinhole.from_list([Km[0, 0], Km[1, 1], Km[0, 2], Km[1, 2]]),
        bf=40.0, th_depth=3.0, depth_map_factor=1.0, n_features=K)
    short = _slam_run(ORB_FRAMES_SHORT, seq, settings, backend="orb",
                      loop=False)
    errs = short["errs"]
    kfs = short["system"].map.num_keyframes()
    print(f"orb slam, {ORB_FRAMES_SHORT} frames, loop closing off: "
          f"{short['states'].count('OK')} OK, camera centre error max "
          f"{errs.max() * 1e3:.3f} mm, median {np.median(errs) * 1e3:.3f} "
          f"mm; {kfs} keyframes")
    check(short["states"] == ["OK"] * ORB_FRAMES_SHORT,
          f"orb slam short: a frame was not OK: {short['states']}")
    check(errs.max() < 0.01 and np.median(errs) < 0.005 and kfs >= 1,
          "orb slam short: beyond the JAX package's 14-frame bars")
    runs = []
    for r in range(2):
        prev = runs[0]["system"] if runs else None
        calls0 = prev.tracking._track_graph.calls if prev else 0
        ck.reset_launch_counts()
        run = _slam_run(ORB_FRAMES_LONG, seq, settings, backend="orb",
                        graphs_from=prev)
        run["counts"] = path_counts(
            ck, f"System(backend='orb').track_rgbd, {ORB_FRAMES_LONG} "
            f"frames, run {r + 1}", ORB_SLAM_KERNELS)
        run["tracked"] = run["system"].tracking._track_graph.calls - calls0
        st = run["stats"] = run["system"].shutdown()
        errs = run["errs"]
        rounds = len(run["system"].local_mapping.ba_seconds)
        n_lm = run["counts"]["pose_lm"]
        print(f"orb slam run {r + 1}: {run['states'].count('OK')} of "
              f"{ORB_FRAMES_LONG} OK, camera centre error max "
              f"{errs.max() * 1e3:.3f} mm, median "
              f"{np.median(errs) * 1e3:.3f} mm; {st['keyframes']} keyframes, "
              f"{st['map_points']} map points, loops closed "
              f"{st['loops_closed']}; {run['tracked']} frames through the "
              f"tracking stages' graph; pose_lm {n_lm} launches "
              f"({2 * run['tracked']} by those replays, "
              f"{n_lm - 2 * run['tracked']} eager); local_ba "
              f"{run['counts']['local_ba']} launches in {rounds} BA rounds")
        check(run["states"] == ["OK"] * ORB_FRAMES_LONG,
              f"orb slam run {r + 1}: a frame was not OK: {run['states']}")
        check(errs.max() < 0.03 and st["keyframes"] >= 3,
              f"orb slam run {r + 1}: beyond the JAX package's 40-frame "
              "bars")
        check(st["loops_closed"] == 0,
              f"orb slam run {r + 1}: {st['loops_closed']} loops closed")
        check(run["tracked"] >= ORB_MIN_TRACKED and n_lm >= 2 * run["tracked"],
              f"orb slam run {r + 1}: too few frames through the graph")
        # run 1's counts hold its captures' warm-up calls too
        per_round = ck.local_ba_launches((5, 0), 40)
        check(r == 0 or run["counts"]["local_ba"] == per_round * rounds,
              f"orb slam run {r + 1}: local_ba launches are not {per_round} "
              "per round")
        runs.append(run)
    a, b = runs
    same = all(np.array_equal(p[0], q[0]) and np.array_equal(p[1], q[1])
               for p, q in zip(a["poses"], b["poses"]))
    same_map = _orb_map_equal(a["system"], b["system"])
    print(f"orb slam: run 2 against run 1: every pose bit-identical {same}, "
          f"map bit-identical {same_map}")
    check(same and same_map, "orb slam: run 2 differs from run 1")

    def pct(xs, q):
        return round(float(np.percentile(np.asarray(xs) * 1e3, q)), 4)

    spans = b["system"].timer.samples
    walls = b["walls"]
    report = {
        "wall_per_frame_ms": {"median": pct(walls[2:], 50),
                              "p90": pct(walls[2:], 90)},
        "track_ms": {"median": pct(spans["track"][2:], 50),
                     "p90": pct(spans["track"][2:], 90)},
        "backend_ms": {"median": pct(spans["backend"][2:], 50),
                       "p90": pct(spans["backend"][2:], 90)},
        # inside track: the frame built (track.frame_build), of it the
        # extractor call (its two replays and the quadtree; the rest is
        # undistortion, the depth gate and the frame's read), the host's
        # inputs of the tracking stages, their replay with its one read
        "track_frame_build_ms": {
            "median": pct(spans["track.frame_build"][2:], 50),
            "p90": pct(spans["track.frame_build"][2:], 90)},
        "track_extract_ms": {"median": pct(spans["track.extract"][2:], 50),
                             "p90": pct(spans["track.extract"][2:], 90)},
        "track_snapshot_ms": {"median": pct(spans["track.snapshot"][1:], 50),
                              "p90": pct(spans["track.snapshot"][1:], 90)},
        "track_stages_ms": {"median": pct(spans["track.frame_step"][1:], 50),
                            "p90": pct(spans["track.frame_step"][1:], 90)},
        "frame_0_ms": round(walls[0] * 1e3, 4),
        "run_1_frame_1_ms": round(a["walls"][1] * 1e3, 4),
        "local_ba_ms": [round(t * 1e3, 4)
                        for _, t, _ in b["system"].local_mapping.ba_seconds],
    }
    print(f"orb slam timings (host wall, run 2, {ORB_FRAMES_LONG} frames at "
          f"{W}x{H}, K={K}): " + json.dumps(report))
    return b, seq


def orb_readers_phase(root, cfg, seq):
    """BASELINE config 1's shape: ``examples/rgbd_tum --backend orb`` on the
    TUM directory the readers phase wrote (the camera trajectory within 1
    cm of the truth, as the XFeat run), then ``examples/mono_tum --backend
    orb`` on it (>= 1 keyframe, the bar of the JAX package's
    test_examples_cli.py)."""
    from xfeatslam_tpu_torch.examples import mono_tum, rgbd_tum
    from xfeatslam_tpu_torch.utils import io as io_utils

    gt_xyz = np.stack([-R.T @ t for (R, t) in seq["poses"]])
    out = os.path.join(root, "out_rgbd_orb")
    run_example("orb readers", rgbd_tum,
                [cfg, root, os.path.join(root, "associations.txt"),
                 "--backend", "orb"], out)
    est_t, est = io_utils.load_trajectory_tum(
        os.path.join(out, "CameraTrajectory.txt"))
    kf_t, _ = io_utils.load_trajectory_tum(
        os.path.join(out, "KeyFrameTrajectory.txt"))
    ate = io_utils.ate_rmse(np.asarray(seq["timestamps"]), gt_xyz, est_t,
                            est[:, :3])
    print(f"orb readers: rgbd_tum --backend orb wrote {len(est_t)} camera "
          f"poses and {len(kf_t)} keyframes; ATE RMSE {ate * 1e3:.4f} mm")
    check(len(est_t) == READER_FRAMES and len(kf_t) >= 1,
          "orb readers: rgbd_tum's trajectories are incomplete")
    check(ate < 0.01, "orb readers: rgbd_tum's trajectory is off by >= 1 cm")
    out = os.path.join(root, "out_mono_orb")
    run_example("orb readers", mono_tum, [cfg, root, "--backend", "orb"], out)
    kf_t, kf = io_utils.load_trajectory_tum(
        os.path.join(out, "KeyFrameTrajectory.txt"))
    ate = (io_utils.ate_rmse(np.asarray(seq["timestamps"]), gt_xyz, kf_t,
                             kf[:, :3], scale=True) if len(kf_t) >= 2
           else float("nan"))
    print(f"orb readers: mono_tum --backend orb wrote {len(kf_t)} "
          f"keyframes; similarity-aligned ATE RMSE {ate * 1e3:.4f} mm")
    check(len(kf_t) >= 1 and np.isfinite(kf).all(),
          f"orb readers: mono_tum wrote {len(kf_t)} keyframes")


def orb_phase(ck, root, cfg, seq):
    """The ORB backend: the extractor and its kernels, RGB-D SLAM, then on
    the SLAM run's System relocalization from LOST and RECENTLY_LOST and
    localization mode (as the XFeat System's phases: each frame OK within
    1 cm, the map unchanged, the pose LM against its plain version on every
    relocalization call), the readers. Returns the SLAM run's launch
    counts, the kernels' rows and the relocalizations' pose-LM gap."""
    _, rows = orb_extractor_phase(ck)
    run, slam_seq = orb_slam_phase(ck)
    counts = run["counts"]
    run["errs"] = np.asarray(run["errs"])
    t_next, last, lm_err = relocalization_phase(
        ck, run, slam_seq, kernels=ORB_FRAME_KERNELS,
        label="orb relocalization")
    localization_phase(ck, run, slam_seq, t_next, last,
                       kernels=ORB_FRAME_KERNELS,
                       label="orb localization mode")
    orb_readers_phase(root, cfg, seq)
    return counts, rows, lm_err


def stereo_sequence(n):
    """The JAX package's stereo test rig (test_slam_integration.py
    TestStereoSlam): ``n`` frames of the rendered room at 640x480 and each
    frame's right view, rendered STEREO_BASELINE along the left camera's
    +x (a rectified pair by construction)."""
    from xfeatslam_tpu_torch.utils import synthetic

    seq = synthetic.make_sequence(n_frames=n)
    scene = synthetic.RoomScene(seed=0)
    shift = np.array([STEREO_BASELINE, 0, 0], np.float32)
    seq["rights"] = [scene.render(seq["K"], R, (t - shift).astype(np.float32),
                                  (H, W))[0] for (R, t) in seq["poses"][:n]]
    return seq


def stereo_settings(seq):
    from xfeatslam_tpu_torch.ops.camera import Pinhole
    from xfeatslam_tpu_torch.slam.settings import Settings

    Km = seq["K"]
    return Settings(
        cam=Pinhole.from_list([Km[0, 0], Km[1, 1], Km[0, 2], Km[1, 2]]),
        bf=STEREO_BASELINE * float(Km[0, 0]), th_depth=3.0,
        depth_map_factor=1.0, n_features=K)


class StepRecorder:
    """Stands in for ``StereoFrameStepGraph`` and keeps its last call's
    arguments."""

    def __init__(self, graph):
        self.graph, self.last = graph, None

    def __call__(self, *args, **kwargs):
        self.last = (args, kwargs)
        return self.graph(*args, **kwargs)


def _stereo_run(n, seq, backend, graphs_from=None, record=False):
    """One ``System(Sensor.STEREO).track_stereo`` run (loop closing on, as
    the JAX package's stereo tests) over ``n`` frames: states, the
    camera-centre errors of the frames with a pose, poses, host wall per
    frame. ``graphs_from``: an earlier System whose CUDA graphs (the stereo
    frame step or the ORB extractor's stages, the tracking stages, local
    BA) this run replays; ``record``: keep the stereo step's last inputs."""
    from xfeatslam_tpu_torch.slam.system import Sensor, System

    system = System(stereo_settings(seq), Sensor.STEREO, backend=backend)
    tr = system.tracking
    if graphs_from is not None:
        prev = graphs_from.tracking
        tr._stereo_graph = getattr(prev._stereo_graph, "graph",
                                   prev._stereo_graph)
        tr._track_graph = prev._track_graph
        system.local_mapping._ba_graph = graphs_from.local_mapping._ba_graph
        if backend == "orb":
            system.extractor._graphs = graphs_from.extractor._graphs
    if record:
        tr._stereo_graph = StepRecorder(tr._stereo_graph)
    calls0 = {g: g.calls for g in (getattr(tr._stereo_graph, "graph",
                                           tr._stereo_graph), tr._track_graph)
              if g is not None}
    out = {"system": system, "states": [], "errs": [], "poses": [],
           "walls": []}
    for i in range(n):
        tw = time.perf_counter()
        state, pose = system.track_stereo(seq["images"][i], seq["rights"][i],
                                          seq["timestamps"][i])
        out["walls"].append(time.perf_counter() - tw)
        out["states"].append(state.name)
        out["poses"].append(None if pose is None
                            else (pose[0].copy(), pose[1].copy()))
        if pose is not None:
            Rg, tg = seq["poses"][i]
            out["errs"].append(float(np.linalg.norm(-pose[0].T @ pose[1]
                                                    + Rg.T @ tg)))
    out["graph_calls"] = {type(g).__name__: g.calls - c
                          for g, c in calls0.items()}
    out["errs"] = np.array(out["errs"])
    return out


def _same_poses(a, b):
    return all((p is None and q is None) or (
        p is not None and q is not None and np.array_equal(p[0], q[0])
        and np.array_equal(p[1], q[1])) for p, q in zip(a, b))


def _span_report(system, walls, first=2):
    def pct(xs, q):
        return round(float(np.percentile(np.asarray(xs) * 1e3, q)), 4)

    spans = system.timer.samples
    rep = {"wall_per_frame_ms": {"median": pct(walls[first:], 50),
                                 "p90": pct(walls[first:], 90)}}
    for name in ("track", "backend", "track.frame_build", "track.extract",
                 "track.stereo_match", "track.snapshot", "track.frame_step"):
        xs = spans.get(name, [])
        xs = xs[first:] if name in ("track", "backend") else xs[1:]
        if xs:
            rep[name.replace(".", "_") + "_ms"] = {"median": pct(xs, 50),
                                                    "p90": pct(xs, 90)}
    return rep


def stereo_phase(ck):
    """XFeat stereo SLAM: ``System(Sensor.STEREO).track_stereo`` on the 10
    frames of the JAX package's test_xfeat_stereo_single_dispatch at
    640x480, K=1000, twice in one process (run 2 replays run 1's graphs),
    each with the JAX test's bars (>= n - 2 frames OK, every pose within 8
    cm, >= n - 4 frames through the stereo step by replay, > 50 keypoints
    with depth on the last frame), the two runs bit-identical; the step's
    graph records one detect_candidates, one keypoint_desc and two pose_lm,
    and run 2's counts are that per replayed frame plus two of each
    extraction kernel per pair built eagerly; the last frame's step by
    replay bit-identical to the eager step and held to the step with the
    plain kernels at the frame-step bars (R, t within 1e-4, slots and
    inliers >= 0.99); run 2's wall per frame and spans. Returns run 2's
    launch counts."""
    from xfeatslam_tpu_torch.optim import track_step

    n = STEREO_FRAMES
    t0 = time.perf_counter()
    seq = stereo_sequence(n)
    print(f"stereo: {n} pairs rendered at {W}x{H} in "
          f"{time.perf_counter() - t0:.2f} s")
    runs = []
    for r in range(2):
        ck.reset_launch_counts()
        run = _stereo_run(n, seq, "xfeat",
                          graphs_from=runs[0]["system"] if runs else None,
                          record=not runs)
        run["counts"] = path_counts(
            ck, f"System(STEREO).track_stereo, {n} pairs, run {r + 1}",
            STEREO_KERNELS, allowed=("local_ba",))
        st = run["stats"] = run["system"].shutdown()
        errs, states = run["errs"], run["states"]
        tracked = run["graph_calls"]["StereoFrameStepGraph"]
        print(f"stereo run {r + 1}: {states.count('OK')} of {n} OK, camera "
              f"centre error max {errs.max() * 1e3:.3f} mm, median "
              f"{np.median(errs) * 1e3:.3f} mm; {st['keyframes']} keyframes, "
              f"{st['map_points']} map points; {st.get('fused_grab', 0)} "
              f"pairs through the stereo step ({tracked} by this run's graph "
              f"calls); launches {run['counts']}")
        check(states.count("OK") >= n - 2, f"stereo run {r + 1}: {states}")
        check(len(errs) and errs.max() < 0.08,
              f"stereo run {r + 1}: a camera centre is >= 8 cm off")
        check(st.get("fused_grab", 0) >= n - 4 and tracked >= n - 4,
              f"stereo run {r + 1}: too few pairs through the stereo step")
        f = run["system"].tracking.last_frame
        check((f.depth > 0).sum() > 50,
              f"stereo run {r + 1}: the last frame has too little depth")
        runs.append(run)
    a, b = runs
    graph = a["system"].tracking._stereo_graph.graph
    per_step = graph.captured_launches()
    print(f"stereo: the step's graph records {per_step}; run 2 against run "
          f"1: every pose bit-identical {_same_poses(a['poses'], b['poses'])}")
    check(per_step == [{"detect_candidates": 1, "keypoint_desc": 1,
                        "pose_lm": 2}],
          "stereo: the step's graph does not launch detect and keypoint_desc "
          "once and pose_lm twice")
    check(_same_poses(a["poses"], b["poses"]),
          "stereo: run 2 differs from run 1")
    tracked = b["graph_calls"]["StereoFrameStepGraph"]
    built = n - tracked
    c = b["counts"]
    check(c["detect_candidates"] == tracked + 2 * built
          and c["keypoint_desc"] == tracked + 2 * built
          and c["pose_lm"] >= 2 * tracked,
          f"stereo run 2: launches {c} are not one detect and keypoint_desc "
          f"and two pose_lm per replayed pair ({tracked}) and two extraction "
          f"launches each per built pair ({built})")

    args, kwargs = a["system"].tracking._stereo_graph.last
    rep = track_step.fetch(graph(*args, **kwargs))
    eager = track_step.fetch(track_step.xfeat_stereo_frame_step(
        graph.model, *args, **kwargs))
    same = all(np.array_equal(x, y) for x, y in zip(
        _flat(rep), _flat(eager)))
    with plain_kernels(ck):
        plain = track_step.fetch(track_step.xfeat_stereo_frame_step(
            graph.model, *args, **kwargs))
    gaps = []
    for rr, pr in zip(rep[1:], plain[1:]):
        gaps.append((float(np.abs(rr.R - pr.R).max()),
                     float(np.abs(rr.t - pr.t).max()),
                     float((rr.slot_mp == pr.slot_mp).mean()),
                     float((rr.inlier == pr.inlier).mean())))
    print(f"stereo step (the last pair): replay against eager bit-identical "
          f"{same}; against the plain kernels per stage (R gap, t gap, slots "
          f"equal, inliers equal) {gaps}")
    check(same, "stereo: the step's replay differs from the eager step")
    check(all(g[0] <= 1e-4 and g[1] <= 1e-4 and g[2] >= 0.99 and g[3] >= 0.99
              for g in gaps), "stereo: the step parts from the plain kernels")
    report = _span_report(b["system"], b["walls"])
    report["frame_0_ms"] = round(b["walls"][0] * 1e3, 4)
    report["run_1_frame_1_capture_ms"] = round(a["walls"][1] * 1e3, 4)
    print(f"stereo timings (host wall, run 2, {n} pairs at {W}x{H}, K={K}): "
          + json.dumps(report))
    return c


def _flat(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for x in tree for v in _flat(x)]
    return [tree]


def orb_stereo_phase(ck):
    """ORB stereo SLAM: ``System(Sensor.STEREO, backend="orb")`` on the 8
    frames of the JAX package's test_stereo_tracks at 640x480, twice in
    one process (run 2 replays run 1's graphs), each with the JAX test's
    bars (every state OK or NOT_INITIALIZED, >= 6 poses, every pose within
    8 cm, > 100 keypoints with depth on the last frame, their median depth
    error < 5% against the rendered depth), the two runs bit-identical;
    run 2's orb_fast and orb_describe launches, two of each per pair (one
    extractor call per view); run 2's spans. Returns run 2's counts."""
    n = ORB_STEREO_FRAMES
    seq = stereo_sequence(n)
    runs = []
    for r in range(2):
        ck.reset_launch_counts()
        run = _stereo_run(n, seq, "orb",
                          graphs_from=runs[0]["system"] if runs else None)
        run["counts"] = path_counts(
            ck, f"System(STEREO, backend='orb').track_stereo, {n} pairs, "
            f"run {r + 1}", ORB_STEREO_KERNELS, allowed=("local_ba",))
        st = run["system"].shutdown()
        errs, states = run["errs"], run["states"]
        f = run["system"].tracking.last_frame
        sel = f.valid & (f.depth > 0)
        d_gt = seq["depths"][n - 1]
        xi = np.clip(f.kpts[sel, 0].astype(int), 0, W - 1)
        yi = np.clip(f.kpts[sel, 1].astype(int), 0, H - 1)
        rel = float(np.median(np.abs(f.depth[sel] - d_gt[yi, xi])
                              / d_gt[yi, xi]))
        print(f"orb stereo run {r + 1}: states {states}; camera centre error "
              f"max {errs.max() * 1e3:.3f} mm over {len(errs)} poses; "
              f"{st['keyframes']} keyframes; last frame {int(sel.sum())} "
              f"keypoints with depth, median depth error {rel:.4f}; launches "
              f"{run['counts']}")
        check(set(states) <= {"OK", "NOT_INITIALIZED"} and len(errs) >= 6
              and errs.max() < 0.08,
              f"orb stereo run {r + 1}: beyond the JAX package's bars")
        check(sel.sum() > 100 and rel < 0.05,
              f"orb stereo run {r + 1}: the last frame's depth is off")
        runs.append(run)
    a, b = runs
    check(_same_poses(a["poses"], b["poses"]),
          "orb stereo: run 2 differs from run 1")
    c = b["counts"]
    check(c["orb_fast"] == c["orb_describe"] == 2 * n,
          f"orb stereo run 2: orb_fast {c['orb_fast']} and orb_describe "
          f"{c['orb_describe']} launches, expected {2 * n} (two per pair)")
    report = _span_report(b["system"], b["walls"])
    print(f"orb stereo: run 2 bit-identical to run 1; timings (host wall, "
          f"run 2, {n} pairs at {W}x{H}): " + json.dumps(report))
    return c


def fisheye_phase(ck):
    """``FramePipeline.build_stereo_fisheye`` (ORB) on the rendered fisheye
    rig of tests/test_fisheye.py (512x512, two KB8 cameras, 11 cm): >= 100
    keypoints with depth, median depth error < 5% against the rendered
    depth (the JAX test's bars), the two ORB kernels launched once per
    view."""
    from xfeatslam_tpu_torch.models.orb import ORBExtractor
    from xfeatslam_tpu_torch.ops.camera import KannalaBrandt8, kb8_unproject
    from xfeatslam_tpu_torch.slam.frame import FramePipeline
    from xfeatslam_tpu_torch.utils import synthetic

    kb1 = KannalaBrandt8.from_list(FISHEYE_KB1)
    kb2 = KannalaBrandt8.from_list(FISHEYE_KB2)
    hw = FISHEYE_HW
    yaw = 0.02
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                          [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
    T[0, 3] = 0.11
    T21 = np.linalg.inv(T)
    u, v = np.meshgrid(np.arange(hw[1], dtype=np.float32),
                       np.arange(hw[0], dtype=np.float32))
    uv = torch.from_numpy(np.stack([u, v], -1).reshape(-1, 2))

    def rays(cam):
        return kb8_unproject(cam, uv).numpy().reshape(hw[0], hw[1], 3)

    scene = synthetic.RoomScene(seed=3)
    img1, dep1 = scene.render(None, np.eye(3, dtype=np.float32),
                              np.zeros(3, np.float32), hw, rays_c=rays(kb1))
    img2, _ = scene.render(None, T21[:3, :3].astype(np.float32),
                           T21[:3, 3].astype(np.float32), hw,
                           rays_c=rays(kb2))
    pipe = FramePipeline(ORBExtractor(nfeatures=1000), kb1, bf=21.0,
                         depth_factor=1.0)
    lap = (0, hw[1] - 1)
    pipe.build_stereo_fisheye(img1, img2, 0.0, kb2, T, lap, lap)  # warm-up
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    f = pipe.build_stereo_fisheye(img1, img2, 0.0, kb2, T, lap, lap)
    ms = (time.perf_counter() - t0) * 1e3
    path_counts(ck, "build_stereo_fisheye", {"orb_fast": 2,
                                             "orb_describe": 2})
    sel = f.valid & (f.depth > 0)
    xi = np.clip(np.round(f.kpts[sel, 0]).astype(int), 0, hw[1] - 1)
    yi = np.clip(np.round(f.kpts[sel, 1]).astype(int), 0, hw[0] - 1)
    gt = dep1[yi, xi]
    good = gt > 0
    rel = float(np.median(np.abs(f.depth[sel][good] - gt[good]) / gt[good]))
    print(f"fisheye: build_stereo_fisheye on the {hw[1]}x{hw[0]} KB8 rig: "
          f"{int(sel.sum())} of {int(f.valid.sum())} keypoints with depth, "
          f"median depth error {rel:.4f}; {ms:.3f} ms of host wall")
    check(sel.sum() >= 100 and rel < 0.05,
          "fisheye: beyond the JAX package's bars")

    # the System through a KB8 camera (RGB-D, XFeat): frames keep their raw
    # keypoints and are tracked the split way, never by the frame step
    from xfeatslam_tpu_torch.slam.settings import Settings
    from xfeatslam_tpu_torch.slam.system import Sensor, System

    cam = KannalaBrandt8.from_list(FISHEYE_TRACK_KB8)
    hw, n = FISHEYE_TRACK_HW, FISHEYE_TRACK_FRAMES
    u, v = np.meshgrid(np.arange(hw[1], dtype=np.float32),
                       np.arange(hw[0], dtype=np.float32))
    r = kb8_unproject(cam, torch.from_numpy(
        np.stack([u, v], -1).reshape(-1, 2))).numpy().reshape(hw[0], hw[1], 3)
    r = r / r[..., 2:3]
    scene = synthetic.RoomScene(seed=0)
    poses = synthetic.orbit_trajectory(n, period=120, forward_per_frame=0.005)
    frames = [scene.render(None, R, t, hw, rays_c=r) for R, t in poses]
    system = System(Settings(cam=cam, camera_type="KannalaBrandt8", bf=24.0,
                             th_depth=3.0, depth_map_factor=1.0,
                             n_features=500, fps=30.0),
                    Sensor.RGBD, enable_loop_closing=False)
    ck.reset_launch_counts()
    states, errs = [], []
    for i, ((gray, depth), (Rg, tg)) in enumerate(zip(frames, poses)):
        state, pose = system.track_rgbd(gray, depth, i / 30.0)
        states.append(state.name)
        errs.append(float(np.linalg.norm(-pose[0].T @ pose[1] + Rg.T @ tg)))
    path_counts(ck, f"System(RGBD) through a KB8 camera, {n} frames",
                {"detect_candidates": n, "keypoint_desc": n, "pose_lm": None},
                allowed=("local_ba",))
    st = system.shutdown()
    print(f"fisheye System: {n} RGB-D frames at {hw[1]}x{hw[0]} through a "
          f"KB8 camera: {states.count('OK')} OK, camera centre error max "
          f"{max(errs) * 1e3:.3f} mm; {st['keyframes']} keyframes, "
          f"{st.get('fused_grab', 0)} frames through the frame step")
    check(states == ["OK"] * n and max(errs) < 0.05
          and st.get("fused_grab", 0) == 0,
          "fisheye System: a frame lost, > 5 cm off, or through the pinhole "
          "frame step")


def rectification_phase(root):
    """An unrectified EuRoC-style pinhole rig (tests/test_settings.py's)
    read by ``Settings.from_yaml`` without cv2: the
    host ms of the read with ``precompute_rectification`` and of
    ``rectify`` per 752x480 pair (medians of 3 and 5), the maps' shape and
    range and the rectified camera."""
    from xfeatslam_tpu_torch.slam.settings import Settings

    path = os.path.join(root, "euroc_stereo.yaml")
    with open(path, "w") as f:
        f.write(EUROC_STEREO_YAML)
    reads = []
    for _ in range(3):
        t0 = time.perf_counter()
        s = Settings.from_yaml(path, sensor="STEREO")
        reads.append((time.perf_counter() - t0) * 1e3)
    rng = np.random.default_rng(0)
    left = rng.integers(0, 256, (480, 752), np.uint8)
    right = rng.integers(0, 256, (480, 752), np.uint8)
    pairs = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = s.rectify(left, right)
        pairs.append((time.perf_counter() - t0) * 1e3)
    M1l = s.rect_maps[0]
    print(f"rectification (host, numpy, no cv2: {'cv2' in sys.modules}): "
          f"from_yaml with precompute_rectification median "
          f"{np.median(reads):.3f} ms, rectify per 752x480 pair median "
          f"{np.median(pairs):.3f} ms; rectified fx {s.cam.fx:.6f} cx "
          f"{s.cam.cx:.6f} cy {s.cam.cy:.6f} bf {s.bf:.6f}; map x in "
          f"[{M1l.min():.3f}, {M1l.max():.3f}]")
    check("cv2" not in sys.modules, "rectification: cv2 was imported")
    check(all(m.shape == (480, 752) and np.isfinite(m).all()
              for m in s.rect_maps) and all(
                  o.shape == (480, 752) and o.dtype == np.uint8 for o in out),
          "rectification: maps or images of the wrong shape")


# the inertial phase: tests/test_inertial_slam.py::TestImuRgbd's run at its
# size (60 frames at 640x480, 10 fps, 200 Hz IMU, its injected biases and
# noise, its Settings) and its bars
VI_FRAMES = 60
VI_BG = np.array([0.004, -0.003, 0.002], np.float32)
VI_BA = np.array([0.03, -0.02, 0.04], np.float32)
# the captured inertial solvers: (System attribute path, function) of each
VI_GRAPHS = {
    "preintegrate": ("tracking", "_pre_graph"),
    "pose_inertial": ("tracking", "_pose_inertial_graph"),
    "pose_inertial_last_frame": ("tracking", "_pose_inertial_lf_graph"),
    "inertial_init": ("local_mapping", "_init_graph"),
    "local_inertial_ba": ("local_mapping", "_viba_graph"),
}
# the kernels of an ORB IMU_RGBD run: the extractor's two, the visual pose
# LM before IMU initialization and in relocalization, local BA before it
VI_ORB_KERNELS = {"orb_fast": None, "orb_describe": None}
VI_ORB_ALLOWED = ("pose_lm", "local_ba")


class _Recorder:
    """Stands in for a captured solver and keeps a copy of the inputs of
    its first and its latest call (while ``store`` is a list), and of the
    first call of each static signature (``by_static``)."""

    def __init__(self, graph):
        self.graph, self.store, self.by_static = graph, [], {}

    def __call__(self, tensors, **static):
        if self.store is not None:
            call = (tuple(a.clone() for a in tensors), dict(static))
            self.store[1:] = [call]
            self.by_static.setdefault(tuple(sorted(static.items())), call)
        return self.graph(tensors, **static)


@functools.lru_cache(maxsize=1)
def vi_sequence():
    """The VI sequence, rendered once for every inertial phase."""
    from xfeatslam_tpu_torch.utils import synthetic

    return synthetic.make_vi_sequence(
        n_frames=VI_FRAMES, fps=10.0, imu_rate=200.0, hw=(H, W), seed=0,
        bg=VI_BG, ba=VI_BA, noise_gyro=2e-4, noise_acc=2e-3)


def vi_settings(Km):
    from xfeatslam_tpu_torch.ops.camera import Pinhole
    from xfeatslam_tpu_torch.ops.imu import ImuCalib
    from xfeatslam_tpu_torch.slam.settings import Settings

    calib = ImuCalib(noise_gyro=2e-4, noise_acc=2e-3, walk_gyro=1e-6,
                     walk_acc=1e-5, R_bc=np.eye(3, dtype=np.float32),
                     t_bc=np.zeros(3, np.float32))
    return Settings(cam=Pinhole.from_list([Km[0, 0], Km[1, 1], Km[0, 2],
                                           Km[1, 2]]),
                    bf=40.0, th_depth=3.0, depth_map_factor=1.0, imu=calib,
                    fps=10.0, imu_init_time=1.0, viba1_time=2.5,
                    viba2_time=3.5)


def _vi_run(seq, backend, graphs_from=None, record=False,
            sensor="IMU_RGBD", rights=None):
    """One inertial System run (``sensor``: IMU_RGBD, IMU_MONOCULAR, or
    IMU_STEREO with the right views ``rights``) over the VI sequence, each
    frame with its IMU samples: states, poses, host wall per frame. The
    captured solvers (and the BA and, for ORB, the extractor graphs) of
    ``graphs_from`` are replayed; ``record`` keeps the inputs of each
    solver's first calls."""
    from xfeatslam_tpu_torch.slam.system import Sensor, System

    settings = vi_settings(seq["K"])
    if sensor == "IMU_STEREO":
        settings.bf = VI_BASELINE * float(seq["K"][0, 0])
    system = System(settings, Sensor[sensor], backend=backend,
                    enable_loop_closing=False)
    if graphs_from is not None:
        if backend == "orb" and graphs_from.backend == "orb":
            system.extractor._graphs = graphs_from.extractor._graphs
        system.local_mapping._ba_graph = graphs_from.local_mapping._ba_graph
        for part, attr in VI_GRAPHS.values():
            g = getattr(getattr(graphs_from, part), attr)
            setattr(getattr(system, part), attr, getattr(g, "graph", g))
    if record:
        for part, attr in VI_GRAPHS.values():
            obj = getattr(system, part)
            setattr(obj, attr, _Recorder(getattr(obj, attr)))
    out = {"system": system, "states": [], "poses": [], "walls": []}
    for i in range(len(seq["timestamps"])):
        tw = time.perf_counter()
        if sensor == "IMU_RGBD":
            state, pose = system.track_rgbd(
                seq["images"][i], seq["depths"][i], seq["timestamps"][i],
                imu=seq["imu"][i])
        elif sensor == "IMU_STEREO":
            state, pose = system.track_stereo(
                seq["images"][i], rights[i], seq["timestamps"][i],
                imu=seq["imu"][i])
        else:
            state, pose = system.track_monocular(
                seq["images"][i], seq["timestamps"][i], imu=seq["imu"][i])
        out["walls"].append(time.perf_counter() - tw)
        out["states"].append(state.name)
        out["poses"].append(None if pose is None
                            else (pose[0].copy(), pose[1].copy()))
    if record:
        out["inputs"] = {}
        out["by_static"] = {}
        for name, (part, attr) in VI_GRAPHS.items():
            rec = getattr(getattr(system, part), attr)
            out["inputs"][name] = rec.store
            out["by_static"][name] = rec.by_static
            rec.store = None
    return out


def _umeyama(src, dst, with_scale=False):
    mu_s, mu_d = src.mean(0), dst.mean(0)
    X, Y = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(Y.T @ X / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = (float((D * np.diagonal(S)).sum() / ((X * X).sum() / len(src)))
         if with_scale else 1.0)
    return s, R, mu_d - s * R @ mu_s


def vi_figures(seq, system):
    """TestImuRgbd's figures of a run: gravity error, keyframes, scale,
    ATE, the last 3 keyframes' velocity error, bias errors."""
    m = system.map
    kfs = sorted(m.keyframes.values(), key=lambda k: k.timestamp)
    idx = [int(round(kf.timestamp * 10.0)) for kf in kfs]
    est = np.stack([kf.center() for kf in kfs])
    gt = np.stack([-seq["poses"][i][0].T @ seq["poses"][i][1] for i in idx])
    Rg, _ = seq["poses"][idx[-1]]
    g_m = (kfs[-1].R.T @ Rg) @ seq["g_w"]
    s, R, t = _umeyama(est, gt, with_scale=True)
    _s1, R_mw, _t1 = _umeyama(est, gt)
    vel = max((float(np.linalg.norm(R_mw @ kf.vel - seq["v_w"][i]))
               if kf.vel is not None else float("inf"))
              for kf, i in zip(kfs[-3:], idx[-3:]))
    return {
        "imu_initialized": m.imu_initialized, "imu_ba1": m.imu_ba1,
        "imu_ba2": m.imu_ba2,
        "gravity_err": float(np.linalg.norm(g_m - [0, 0, -9.81])),
        "keyframes": len(kfs), "scale_err": abs(s - 1.0),
        "ate_max_m": float(np.linalg.norm((est @ R.T) * s + t - gt,
                                          axis=1).max()),
        "vel_err_last3": vel,
        "bg_err": float(np.linalg.norm(m.imu_bg - VI_BG)),
        "ba_err": float(np.linalg.norm(m.imu_ba - VI_BA)),
    }


def check_vi_bars(label, states, f):
    """TestImuRgbd's bars."""
    check(f["imu_initialized"] and f["imu_ba1"] and f["imu_ba2"],
          f"{label}: the IMU schedule did not complete")
    check(f["gravity_err"] < 0.35, f"{label}: gravity off by "
          f"{f['gravity_err']}")
    check(f["keyframes"] >= 6, f"{label}: {f['keyframes']} keyframes")
    check(f["scale_err"] < 0.03, f"{label}: scale off by {f['scale_err']}")
    check(f["ate_max_m"] < 0.05, f"{label}: ATE max {f['ate_max_m']}")
    check(f["vel_err_last3"] < 0.08, f"{label}: velocity off by "
          f"{f['vel_err_last3']}")
    check(f["bg_err"] < 2e-3 and f["ba_err"] < 4e-2,
          f"{label}: biases off by {f['bg_err']}, {f['ba_err']}")
    check(all(s == "OK" for s in states[1:]),
          f"{label}: a frame from 1 was not OK: {states}")


def _vi_same(a, b):
    """Every pose and the map (keyframe poses, velocities, biases, map
    points) bit for bit."""
    same = all((p is None and q is None) or (
        p is not None and q is not None and np.array_equal(p[0], q[0])
        and np.array_equal(p[1], q[1])) for p, q in zip(a["poses"],
                                                         b["poses"]))
    ma, mb = a["system"].map, b["system"].map
    same &= sorted(ma.keyframes) == sorted(mb.keyframes)
    for k in ma.keyframes if same else ():
        ka, kb = ma.keyframes[k], mb.keyframes[k]
        for f in ("R", "t", "vel", "bg", "ba"):
            same &= np.array_equal(getattr(ka, f), getattr(kb, f))
    n = ma.points.n
    return bool(same and n == mb.points.n
                and np.array_equal(ma.points.pos[:n], mb.points.pos[:n]))


def _vi_report(run):
    def pct(xs, q):
        return round(float(np.percentile(np.asarray(xs) * 1e3, q)), 4)

    spans = run["system"].timer.samples
    return {"wall_per_frame_ms": {"median": pct(run["walls"][2:], 50),
                                  "p90": pct(run["walls"][2:], 90)},
            "track_ms": {"median": pct(spans["track"][2:], 50),
                         "p90": pct(spans["track"][2:], 90)},
            "backend_ms": {"median": pct(spans["backend"][2:], 50),
                           "p90": pct(spans["backend"][2:], 90)},
            "backend_max_ms": pct(spans["backend"][2:], 100)}


def _solver_fn(name):
    from xfeatslam_tpu_torch.ops import imu
    from xfeatslam_tpu_torch.optim import inertial, viba

    return {"preintegrate": imu.preintegrate,
            "pose_inertial": inertial.pose_inertial_flat,
            "pose_inertial_last_frame": inertial.pose_inertial_last_frame_flat,
            "inertial_init": inertial.inertial_init,
            "local_inertial_ba": viba.solve_flat}[name]


# where a float32 accept-or-reject decision of a solver's LM differs
# between the card and the CPU, its bias fields are held to TestImuRgbd's
# bias bars instead (gyro 2e-3, acc 4e-2): the field index of each
VI_BIAS_FIELDS = {"pose_inertial": (3, 4), "pose_inertial_last_frame": (3, 4),
                  "inertial_init": (2, 3), "local_inertial_ba": (3, 4)}


def lm_decisions(name, tensors, static):
    """The accept-or-reject decisions of a solver's LM iterations on these
    tensors (eager): [(kept, cost before, cost of the step)]."""
    from xfeatslam_tpu_torch.optim import inertial

    store = []
    fn = _solver_fn(name)
    if name == "local_inertial_ba":
        fn(*tensors, trace=store, **static)
    else:
        orig = inertial._dense_lm
        inertial._dense_lm = functools.partial(orig, trace=store)
        try:
            fn(*tensors, **static)
        finally:
            inertial._dense_lm = orig
    return [tuple(float(v) for v in t.cpu()) for t in store]


def _solver_gap(name, a, b, bias_bars=None, free_scale=False):
    """The largest gap between two results of a solver, field by field,
    with the CPU tests' bars (or ``bias_bars`` on the bias fields, and for
    a scale-free ``inertial_init`` TestInertialInit's bars on the scale,
    the gravity direction and the velocities): (worst ratio gap/bar,
    report)."""
    a, b = tuple(a), tuple(b)
    if name == "preintegrate":
        bars = [1e-5] * len(a)
        bars[4] = 1e-5 * float(b[4].abs().max())  # the covariance, relative
    elif name.startswith("pose_inertial"):
        bars = [1e-4] * 5 + [None, None, 1e-4 * float(b[7].abs().max())]
    elif name == "inertial_init":
        bars = [1e-4 * float(b[0].abs()), 1e-4, 1e-5, 1e-5, 1e-4, None]
    else:  # local_inertial_ba: states 1e-4, landmarks 2e-3 m
        bars = [1e-4] * 5 + [2e-3, None, None]
    if bias_bars is not None:
        for i, bar in zip(VI_BIAS_FIELDS[name], bias_bars):
            bars[i] = bar
        if free_scale and name == "inertial_init":
            # scale within 2%, gravity cosine above 0.999, velocities
            # within 0.05 m/s
            bars[0], bars[1], bars[4] = (0.02 * float(b[0].abs()), 0.0447,
                                         0.05)
    worst, rep = 0.0, []
    for i, (x, y, bar) in enumerate(zip(a, b, bars)):
        if x.dtype == torch.bool:
            agree = float((x.cpu() == y.cpu()).float().mean())
            rep.append(round(agree, 6))
            worst = max(worst, 0.0 if agree >= 0.99 else float("inf"))
            continue
        gap = float((x.cpu().double() - y.cpu().double()).abs().max())
        rep.append(float(f"{gap:.3e}"))
        if bar is not None:
            worst = max(worst, gap / bar if bar > 0 else
                        (0.0 if gap == 0 else float("inf")))
    return worst, rep


def _solver_bound(name, tensors, static):
    """Bytes and float32 operations the solver's call needs at its least:
    its inputs read once and its outputs written once; the operations of
    its loops counted from its algorithm (per element of the residuals and
    Jacobians it forms)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    if name == "preintegrate":
        n = int(tensors[3].sum())  # valid samples
        # per sample: three 9x9 products and the 6x6 one (~2,200), the
        # exp, the right Jacobian and the bias Jacobians (~400)
        flops = n * 2600
    elif name.startswith("pose_inertial"):
        n_dir = 15 if name == "pose_inertial" else 30
        n_edges = int(tensors[-3].sum())  # valid visual edges
        m = 3 * n_edges + 15 + (15 if n_dir == 30 else 0)
        # 3 rounds x 8 LM iterations: the residuals and their derivative
        # in n_dir directions (~60 ops per edge each), J^T J, the solve
        flops = 24 * (m * n_dir * (60 + 2 * n_dir) + 2 * n_dir ** 3)
    elif name == "inertial_init":
        E = int(tensors[12].sum())
        n = 9 + 3 * tensors[0].shape[0]
        m = 9 * E + 6
        flops = 60 * (m * n * (200 + 2 * n) + 2 * n ** 3)
    else:
        O = int(tensors[14].sum())
        K, E = tensors[0].shape[0], int(tensors[27].sum())
        iters = sum(static["stage_iters"])
        cg = static["cg_iters"]
        # per LM iteration the linearization (~400 per observation, the
        # chain's 15x30 Jacobian ~30x300 per edge) and per CG step the
        # products (~110 per observation, ~2x450 per edge, ~450 per state)
        flops = iters * (O * 400 + E * 9000
                         + cg * (O * 110 + E * 900 + K * 450))
    return bound_ms(nbytes, flops)


def inertial_solver_checks(inputs, graphs):
    """Each inertial solver on the card against the same function on CPU
    tensors, on the inputs the ORB run recorded (the first and the last of
    its recorded calls), at the CPU tests' bars: the eager call's wall ms
    (synchronized), the captures' wall ms (warm-up included) of the run's
    graph, its replay ms (CUDA events around replays) and device events per
    call (``torch.profiler``). ``graphs`` maps a solver to the run's
    captured graph, which replays the recorded inputs. Returns rows by
    name."""
    rows, failed = {}, []
    for name, calls in inputs.items():
        check(calls, f"inertial solvers: the run made no {name} call")
        graph = graphs[name]
        for c in sorted({0, len(calls) - 1}):
            tensors, static = calls[c]
            fn = _solver_fn(name)

            def eager():
                return fn(*tensors, **static)

            def replay():
                return graph(tensors, **static)

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = eager()
            torch.cuda.synchronize()
            eager_wall = (time.perf_counter() - t0) * 1e3
            cpu_tensors = tuple(t.cpu() for t in tensors)
            ref = fn(*cpu_tensors, **static)
            worst, gaps = _solver_gap(name, got, ref)
            flip = None
            if worst > 1.0 and name in VI_BIAS_FIELDS:
                # show where the card's LM and the CPU's part
                dc = lm_decisions(name, tensors, static)
                dh = lm_decisions(name, cpu_tensors, static)
                flip = next(((i, c, h) for i, (c, h) in enumerate(zip(dc, dh))
                             if c[0] != h[0]), None)
                if flip is not None:
                    worst, gaps = _solver_gap(
                        name, got, ref, (2e-3, 4e-2),
                        free_scale=not static.get("fix_scale", True))
            n_captured = len(graph.capture_seconds)
            rep = replay()
            same = all(torch.equal(x, y) for x, y in zip(tuple(got),
                                                         tuple(rep)))
            check(len(graph.capture_seconds) == n_captured,
                  f"inertial solver {name}: the recorded call's shapes have "
                  "no graph from the run")
            replay_ms = cuda_ms(replay, iters=10, warmup=1)
            n_ev, dev_ms, top = stage_events(replay)
            b_ms, b_by = _solver_bound(name, tensors, static)
            key = name if c == 0 else f"{name}[{c}]"
            rows[key] = {"eager_wall_ms": round(eager_wall, 2),
                         "captures_wall_ms": [round(t * 1e3, 1) for t in
                                              graph.capture_seconds],
                         "replay_ms": round(replay_ms, 4),
                         "device_events": n_ev,
                         "device_ms": round(dev_ms, 4),
                         "bound_ms": b_ms, "bound_by": b_by,
                         "replay_vs_eager_bits": same, "gaps_vs_cpu": gaps,
                         "top": top}
            if flip is not None:
                rows[key]["lm_decision_differs"] = {
                    "iteration": flip[0], "card": flip[1], "cpu": flip[2]}
            print(f"inertial solver {key} (shapes "
                  f"{[tuple(t.shape) for t in tensors[:2]]}): card vs CPU "
                  f"gaps {gaps} (worst {worst:.3f} of the bars), replay "
                  f"bit-identical to eager {same}; " + json.dumps(
                      {k: v for k, v in rows[key].items()
                       if k not in ("gaps_vs_cpu",)}))
            if flip is not None:
                print(f"inertial solver {key}: the LM's accept-or-reject "
                      f"decision differs at iteration {flip[0]}: card (kept, "
                      f"cost, step's cost) {flip[1]}, CPU {flip[2]}; biases "
                      "held to TestImuRgbd's bars" + (
                          ", scale, gravity and velocities to "
                          "TestInertialInit's" if name == "inertial_init"
                          and not static.get("fix_scale", True) else ""))
            if worst > 1.0:
                failed.append(f"{key} ({gaps})")
    check(not failed, "inertial solvers: card and CPU disagree beyond the "
          "bars: " + "; ".join(failed))
    return rows


def pose_graph_4dof_check(dev):
    """The 4-DoF essential graph on one problem (a 12-keyframe circle whose
    odometry drifts in yaw and translation, closed by one loop edge): the
    card against the CPU, poses within 1e-4."""
    from xfeatslam_tpu_torch.ops import lie
    from xfeatslam_tpu_torch.optim import pose_graph as pg

    C = 12
    R_gt, t_gt = [], []
    for i in range(C):
        ang = 2 * np.pi * i / C
        xi = torch.tensor([np.sin(ang), 0.0, np.cos(ang) - 1.0, 0.0,
                           ang if ang < np.pi else ang - 2 * np.pi, 0.0],
                          dtype=torch.float32)
        R, t = lie.se3_exp(xi)
        R_gt.append(R.numpy())
        t_gt.append(t.numpy())
    drift = torch.tensor([0.0, 0.012, -0.008, 0.002, 0.0, -0.006, 0.0])
    dR = lie.so3_exp(drift[3:6]).numpy()
    dt = drift[:3].numpy()
    m_R, m_t = [], []
    edges = [(i, i + 1) for i in range(C - 1)] + [(0, C - 1)]
    for k, (i, j) in enumerate(edges):
        mR = R_gt[j] @ R_gt[i].T
        mt = t_gt[j] - mR @ t_gt[i]
        if k < C - 1:
            mR, mt = dR @ mR, dR @ mt + dt
        m_R.append(mR)
        m_t.append(mt)
    R0, t0 = [R_gt[0]], [t_gt[0]]
    for k in range(C - 1):
        R0.append(m_R[k] @ R0[-1])
        t0.append(m_R[k] @ t0[-1] + m_t[k])
    arrays = dict(
        s=np.ones(C, np.float32), R=np.stack(R0).astype(np.float32),
        t=np.stack(t0).astype(np.float32), fixed=np.arange(C) == 0,
        cam_valid=np.ones(C, bool),
        edge_i=np.array([e[0] for e in edges], np.int32),
        edge_j=np.array([e[1] for e in edges], np.int32),
        m_s=np.ones(C, np.float32), m_R=np.stack(m_R).astype(np.float32),
        m_t=np.stack(m_t).astype(np.float32), e_valid=np.ones(C, bool))
    cpu = pg.optimize_pose_graph(pg.PoseGraphProblem(
        **{k: torch.from_numpy(v) for k, v in arrays.items()}), mode="4dof")
    prob = pg.PoseGraphProblem(**{k: torch.from_numpy(v).to(dev)
                                  for k, v in arrays.items()})
    card = pg.optimize_pose_graph(prob, mode="4dof")
    gap = max(float((a.cpu() - b).abs().max()) for a, b in zip(card, cpu))
    drift_before = float(np.linalg.norm(arrays["t"][-1] - t_gt[-1]))
    drift_after = float(np.linalg.norm(card[2][-1].cpu().numpy() - t_gt[-1]))
    ms = cuda_ms(lambda: pg.optimize_pose_graph(prob, mode="4dof"),
                 iters=2, warmup=0)
    n_ev, dev_ms, _ = stage_events(lambda: pg.optimize_pose_graph(
        prob, mode="4dof"))
    # 20 LM iterations: per edge the residual and its derivative in the 4
    # directions of both vertices (~250 ops each), then 50 CG steps of
    # ~120 ops an edge and ~50 a vertex; the inputs read, the poses written
    b_ms, b_by = bound_ms(
        sum(v.nbytes for v in arrays.values()) + C * 13 * 4,
        20 * (len(edges) * 8 * 250 + 50 * (len(edges) * 120 + C * 50)))
    print(f"4-DoF essential graph ({C} keyframes, {len(edges)} edges): card "
          f"vs CPU max gap {gap:.3e}; the last keyframe's drift "
          f"{drift_before * 1e3:.3f} -> {drift_after * 1e3:.3f} mm; eager "
          f"{ms:.3f} ms, {n_ev} device events, {dev_ms:.3f} device ms")
    check(gap <= 1e-4, "4-DoF essential graph: card and CPU disagree")
    check(drift_after < 0.3 * drift_before,
          "4-DoF essential graph: the drift was not redistributed")
    return {"eager_ms": round(ms, 4), "device_events": n_ev,
            "device_ms": round(dev_ms, 4), "bound_ms": b_ms, "bound_by": b_by,
            "gap_vs_cpu": gap}


def inertial_atlas_check(system):
    """The inertial atlas round trip: the run's atlas saved on the card's
    host and loaded back, every keyframe's velocity, biases, chain link
    and preintegration and the map's IMU flags and biases equal."""
    from xfeatslam_tpu_torch.slam import serialization

    m1 = system.map
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "atlas_imu.zip")
        system.save_atlas(path)
        m2 = serialization.load_atlas(path).active
    same = (m2.imu_initialized, m2.imu_ba1, m2.imu_ba2) == (
        m1.imu_initialized, m1.imu_ba1, m1.imu_ba2)
    same &= (np.array_equal(m1.imu_bg, m2.imu_bg)
             and np.array_equal(m1.imu_ba, m2.imu_ba))
    same &= sorted(m1.keyframes) == sorted(m2.keyframes)
    n_pre = 0
    for k in (m1.keyframes if same else ()):
        a, b = m1.keyframes[k], m2.keyframes[k]
        same &= a.prev_kf == b.prev_kf
        same &= (a.vel is None) == (b.vel is None)
        if a.vel is not None:
            same &= np.array_equal(a.vel, b.vel)
        same &= np.array_equal(a.bg, b.bg) and np.array_equal(a.ba, b.ba)
        same &= (a.pre_kf is None) == (b.pre_kf is None)
        if a.pre_kf is not None and b.pre_kf is not None:
            n_pre += 1
            same &= all(np.array_equal(np.asarray(x, np.float32), y)
                        for x, y in zip(a.pre_kf, b.pre_kf))
    print(f"inertial atlas round trip: {len(m1.keyframes)} keyframes, "
          f"{n_pre} preintegrations; IMU state equal {same}")
    check(same and n_pre == len(m1.keyframes) - 1,
          "inertial atlas: the loaded map's IMU state differs")


def inertial_phase(ck):
    """``System(Sensor.IMU_RGBD)``: the ORB System on TestImuRgbd's run
    twice (run 2 replaying run 1's graphs), each held to TestImuRgbd's bars,
    run 2 bit-identical to run 1, its wall, spans and launches per frame;
    the ORB run's atlas saved and loaded with its IMU state; the XFeat
    System on the same run once (IMU initialized, every frame from 1 OK,
    detect_candidates and keypoint_desc once per frame; its figures printed
    without bars); each inertial solver on the card against the same
    function on CPU tensors with run 1's inputs, eager, captured and
    replayed; the 4-DoF essential graph card against CPU. Returns the ORB
    run 2's launch counts, the solver rows and the ORB run 2's System."""
    seq = vi_sequence()
    dev = torch.device("cuda")
    runs, calls1 = [], {}
    for r in range(2):
        prev = runs[0]["system"] if runs else None
        if prev is not None:
            calls1 = {name: getattr(getattr(prev, part), attr).graph.calls
                      for name, (part, attr) in VI_GRAPHS.items()}
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        run = _vi_run(seq, "orb", graphs_from=prev, record=r == 0)
        wall = time.perf_counter() - t0
        run["counts"] = path_counts(
            ck, f"System(IMU_RGBD, backend='orb'), {VI_FRAMES} frames, run "
            f"{r + 1}", VI_ORB_KERNELS, allowed=VI_ORB_ALLOWED)
        f = run["figures"] = vi_figures(seq, run["system"])
        print(f"inertial orb run {r + 1} ({wall:.1f} s): states "
              f"{run['states'].count('OK')} of {VI_FRAMES} OK; "
              + json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                            for k, v in f.items()}))
        check_vi_bars(f"inertial orb run {r + 1}", run["states"], f)
        runs.append(run)
    a, b = runs
    same = _vi_same(a, b)
    print(f"inertial orb: run 2 against run 1: poses and map bit-identical "
          f"{same}")
    check(same, "inertial orb: run 2 differs from run 1")
    inertial_atlas_check(b["system"])
    per_frame = {k: round(v / VI_FRAMES, 4) for k, v in b["counts"].items()
                 if v}
    calls = {name: getattr(getattr(b["system"], part), attr).calls
             - calls1[name] for name, (part, attr) in VI_GRAPHS.items()}
    print("inertial orb timings (host wall, run 2, "
          f"{VI_FRAMES} frames at {W}x{H}): " + json.dumps(_vi_report(b))
          + f"; kernel launches per frame {json.dumps(per_frame)}; solver "
          f"calls in run 2 {json.dumps(calls)}")

    # the XFeat System once (since the monocular and stereo inertial phase
    # joined the script: the script's time limit)
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    run = _vi_run(seq, "xfeat", graphs_from=a["system"])
    wall = time.perf_counter() - t0
    counts = path_counts(
        ck, f"System(IMU_RGBD, backend='xfeat'), {VI_FRAMES} frames",
        {"detect_candidates": VI_FRAMES, "keypoint_desc": VI_FRAMES},
        allowed=VI_ORB_ALLOWED)
    f = vi_figures(seq, run["system"])
    print(f"inertial xfeat ({wall:.1f} s): states "
          f"{run['states'].count('OK')} of {VI_FRAMES} OK; figures "
          "(no bars) " + json.dumps(
              {k: (round(v, 6) if isinstance(v, float) else v)
               for k, v in f.items()}) + f"; launches {counts}; timings "
          + json.dumps(_vi_report(run)))
    check(f["imu_initialized"], "inertial xfeat: the IMU was not initialized")
    check(all(s == "OK" for s in run["states"][1:]),
          "inertial xfeat: a frame from 1 was not OK")

    rows = inertial_solver_checks(a["inputs"], {
        name: getattr(getattr(b["system"], part), attr)
        for name, (part, attr) in VI_GRAPHS.items()})
    rows["pose_graph_4dof"] = pose_graph_4dof_check(dev)
    print("inertial solvers: " + json.dumps(rows))
    return b["counts"], rows, b["system"]



# the monocular and stereo inertial phase: tests/test_inertial_slam.py's
# TestImuMonocular run (VI_FRAMES frames) and TestImuStereo run
# (VI_STEREO_FRAMES pairs, the right view VI_BASELINE along camera +x,
# bf = VI_BASELINE * fx), each at its size, with its bars: scale error,
# ATE max (m), gravity error
VI_STEREO_FRAMES = 50
VI_BASELINE = 0.08
VI_SENSOR_BARS = {"IMU_MONOCULAR": (0.08, 0.08, 0.5),
                  "IMU_STEREO": (0.03, 0.06, 0.4)}


def vi_prefix(seq, n):
    """The first n frames of a VI sequence, which is make_vi_sequence's
    n-frame sequence (the same trajectory, IMU samples and images)."""
    m = len(seq["timestamps"])
    return {k: v[:n] if isinstance(v, (list, np.ndarray)) and len(v) == m
            else v for k, v in seq.items()}


def vi_stereo_rights(seq):
    """TestImuStereo's right views: the room rendered VI_BASELINE along
    each left camera's +x."""
    from xfeatslam_tpu_torch.utils import synthetic

    scene = synthetic.RoomScene(seed=0)
    return [scene.render(seq["K"], R, (t - np.array(
        [VI_BASELINE, 0, 0], np.float32)).astype(np.float32), (H, W))[0]
        for R, t in seq["poses"]]


def check_vi_sensor_bars(label, sensor, f):
    """TestImuMonocular's or TestImuStereo's bars."""
    scale, ate, grav = VI_SENSOR_BARS[sensor]
    check(f["imu_initialized"], f"{label}: the IMU was not initialized")
    check(f["keyframes"] >= 6, f"{label}: {f['keyframes']} keyframes")
    check(f["scale_err"] < scale, f"{label}: scale off by {f['scale_err']}")
    check(f["ate_max_m"] < ate, f"{label}: ATE max {f['ate_max_m']}")
    check(f["gravity_err"] < grav, f"{label}: gravity off by "
          f"{f['gravity_err']}")


def _vi_sensor_runs(ck, seq, sensor, backend, expect, n_runs, rights=None,
                    record=False, graphs_from=None, exact_first=False):
    """``n_runs`` runs of one inertial System over ``seq``, each counted
    (``expect``, exact from run 2 on, or from run 1 with ``exact_first``:
    run 1 also counts the launches of its captures' warm-ups; pose_lm and
    local_ba allowed), run 2 replaying run 1's graphs; the figures of each
    run printed."""
    runs = []
    n = len(seq["timestamps"])
    for r in range(n_runs):
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        run = _vi_run(seq, backend, graphs_from=runs[0]["system"] if runs
                      else graphs_from, record=record and r == 0,
                      sensor=sensor, rights=rights)
        run["wall"] = time.perf_counter() - t0
        run["counts"] = path_counts(
            ck, f"System({sensor}, backend='{backend}'), {n} frames, run "
            f"{r + 1}", expect if r or exact_first
            else dict.fromkeys(expect), allowed=VI_ORB_ALLOWED)
        f = run["figures"] = vi_figures(seq, run["system"])
        print(f"{sensor} {backend} run {r + 1} ({run['wall']:.1f} s): states "
              f"{run['states'].count('OK')} of {n} OK; " + json.dumps(
                  {k: (round(v, 6) if isinstance(v, float) else v)
                   for k, v in f.items()}))
        runs.append(run)
    return runs


def _weld_scene(dev):
    """tests/test_inertial.py::TestMergeInertialBA::test_weld_refinement's
    welded 13-keyframe scene in the port's classes: keyframes 0-5 the old
    map, 6-12 the moved one (its IMU chain cut at 6), the moved free states
    7-12 off by 3 degrees of yaw and 8 cm, landmarks that consecutive
    keyframes share, the preintegrations the port's own. Returns the map,
    its monocular inertial LocalMapping on ``dev`` and the truth."""
    from xfeatslam_tpu_torch.ops import imu
    from xfeatslam_tpu_torch.ops.camera import Pinhole
    from xfeatslam_tpu_torch.optim.inertial import np_body_to_cam
    from xfeatslam_tpu_torch.slam.local_mapping import LocalMapping
    from xfeatslam_tpu_torch.slam.map import KeyFrame, SlamMap
    from xfeatslam_tpu_torch.utils.synthetic import make_imu_trajectory

    n_kf, split, n_pts, slots = 13, 6, 60, 128
    I3, Z3 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    traj = make_imu_trajectory(n_kf=n_kf, g_dir=np.array([0, 0, -1.0]))
    pres = [imu.to_numpy(imu.preintegrate(
        torch.from_numpy(np.asarray(g["acc"])),
        torch.from_numpy(np.asarray(g["gyro"])),
        torch.from_numpy(np.asarray(g["dts"])),
        torch.ones(len(g["acc"]), dtype=torch.bool), torch.zeros(3),
        torch.zeros(3), noise_gyro=1e-3, noise_acc=1e-2))
        for g in traj["imu"]]
    rng = np.random.default_rng(0)
    banks = []
    for k in range(n_kf - 1):
        R_cw, t_cw = np_body_to_cam(traj["R_wb"][k], traj["p_wb"][k], I3, Z3)
        dirs = rng.standard_normal((n_pts, 3))
        dirs[:, 2] = np.abs(dirs[:, 2]) + 1.5
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        Xc = dirs * rng.uniform(2.0, 6.0, n_pts)[:, None]
        rng.standard_normal((n_pts, 2))
        banks.append((Xc @ R_cw - R_cw.T @ t_cw).astype(np.float32))
    yaw = np.deg2rad(3.0)
    R_off = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                      [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]], np.float32)
    t_off = np.array([0.08, -0.05, 0.03], np.float32)
    c0 = traj["p_wb"][7].astype(np.float32)
    m = SlamMap(desc_dim=64)
    m.imu_initialized = True
    mp_of = {}
    for k in range(n_kf):
        R_cw, t_cw = np_body_to_cam(traj["R_wb"][k], traj["p_wb"][k], I3, Z3)
        uv_all, key_all = [], []
        for b in ([k - 1] if k else []) + ([k] if k < n_kf - 1 else []):
            Xc = banks[b] @ R_cw.T + t_cw
            z = np.maximum(Xc[:, 2], 1e-6)
            uv = np.stack([517.3 * Xc[:, 0] / z + 318.6,
                           516.5 * Xc[:, 1] / z + 255.3], -1)
            for j in np.nonzero(Xc[:, 2] > 0.2)[0]:
                if len(uv_all) < slots:
                    uv_all.append(uv[j])
                    key_all.append((b, int(j)))
        kpts = np.zeros((slots, 2), np.float32)
        kpts[:len(uv_all)] = np.asarray(uv_all, np.float32)
        valid = np.arange(slots) < len(uv_all)
        R_wb, p_wb = traj["R_wb"][k], traj["p_wb"][k]
        v_w = traj["v_w"][k]
        if k >= 7:
            R_wb, p_wb = R_off @ R_wb, R_off @ (p_wb - c0) + c0 + t_off
            v_w = R_off @ v_w
        R_c, t_c = np_body_to_cam(R_wb.astype(np.float32),
                                  p_wb.astype(np.float32), I3, Z3)
        kf = KeyFrame(kid=k, frame_id=k, timestamp=float(traj["t_kf"][k]),
                      kpts_un=kpts, desc=np.zeros((slots, 64), np.float32),
                      valid=valid, ur=np.full(slots, -1.0, np.float32),
                      depth=np.zeros(slots, np.float32), R=R_c, t=t_c)
        kf.prev_kf = -1 if k in (0, split) else k - 1
        if k not in (0, split):
            kf.pre_kf = pres[k - 1]
        kf.vel = np.asarray(v_w, np.float32)
        m.keyframes[k] = kf
        m.covis.setdefault(k, {})
        if m.kf_origin is None:
            m.kf_origin = k
        for slot, key in enumerate(key_all):
            if key not in mp_of:
                mp_of[key] = m.create_point(banks[key[0]][key[1]],
                                            np.zeros(64, np.float32), k)
            m.add_observation(mp_of[key], k, slot, update_links=False)
        m.update_connections(k)
    calib = imu.ImuCalib(noise_gyro=1e-3, noise_acc=1e-2, walk_gyro=1e-6,
                         walk_acc=1e-5, R_bc=I3, t_bc=Z3)
    lm = LocalMapping(m, Pinhole.from_list([517.3, 516.5, 318.6, 255.3]),
                      0.0, dev, imu_calib=calib, mono=True)
    return m, lm, traj


def merge_inertial_ba_check(dev):
    """``LocalMapping.merge_inertial_ba`` on the card on the welded scene:
    the moved side pulled back onto the welding-region landmarks (the JAX
    test's bar, err1 < 0.5 err0); returns the 24-slot solve's recorded
    call and its graph."""
    m, lm, traj = _weld_scene(dev)

    def err():
        return max(float(np.linalg.norm(m.keyframes[k].center()
                                         - traj["p_wb"][k]))
                   for k in range(7, 13))

    rec = lm._viba_graph = _Recorder(lm._viba_graph)
    err0 = err()
    t0 = time.perf_counter()
    lm.merge_inertial_ba(12, 5)
    wall = (time.perf_counter() - t0) * 1e3
    err1 = err()
    print(f"merge_inertial_ba on the welded 13-keyframe scene: moved-side "
          f"error {err0 * 1e3:.3f} -> {err1 * 1e3:.3f} mm (bar: below half), "
          f"{len(rec.store)} solve, shapes "
          f"{[tuple(t.shape) for t in rec.store[0][0][:2]]}, host wall "
          f"{wall:.1f} ms (capture included)")
    check(err0 > 0.05 and err1 < 0.5 * err0,
          "merge_inertial_ba: the weld was not refined")
    check(len(rec.store) == 1 and rec.store[0][0][0].shape[0] == 24,
          "merge_inertial_ba: not one 24-slot solve")
    return rec.store, rec.graph


def inertial_mono_stereo_phase(ck, graphs_from=None):
    """``System(Sensor.IMU_MONOCULAR)`` and ``System(Sensor.IMU_STEREO)``:
    the ORB monocular System on TestImuMonocular's run twice and the ORB
    stereo System on TestImuStereo's twice (run 2 replaying run 1's graphs,
    bit-identical), each run held to its test's bars; the monocular run 2's
    wall, spans and launches per frame; the XFeat stereo System once (IMU
    initialized, every pair from 1 OK, two detect_candidates and two
    keypoint_desc a pair); the new solver calls on the card against the
    CPU: the scale-free first initialization and the scale refinement of
    the monocular run 1, and merge_inertial_ba's 24-slot solve on the
    welded scene. Each System's run 1 starts from the graphs captured
    before it (``graphs_from``, the IMU_RGBD phase's ORB System, then the
    monocular run's), so only new shapes and schedules are captured.
    Returns each path's launch counts and the solver rows."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    seq = vi_sequence()
    n = len(seq["timestamps"])
    mono = _vi_sensor_runs(ck, seq, "IMU_MONOCULAR", "orb",
                           {"orb_fast": n, "orb_describe": n}, 2,
                           record=True, graphs_from=graphs_from)
    for r, run in enumerate(mono):
        check_vi_sensor_bars(f"IMU_MONOCULAR orb run {r + 1}",
                             "IMU_MONOCULAR", run["figures"])
    same = _vi_same(*mono)
    print(f"IMU_MONOCULAR orb: run 2 against run 1: poses and map "
          f"bit-identical {same}")
    check(same, "IMU_MONOCULAR orb: run 2 differs from run 1")
    b = mono[1]
    per_frame = {k: round(v / n, 4) for k, v in b["counts"].items() if v}
    print("IMU_MONOCULAR orb timings (host wall, run 2, "
          f"{n} frames at {W}x{H}): " + json.dumps(_vi_report(b))
          + f"; kernel launches per frame {json.dumps(per_frame)}; "
          "two-view failures before the map started (each keeps the "
          "reference, ROADMAP C.18) "
          f"{b['system'].tracking.stats.get('two_view_fail', 0)}; "
          f"inertial initializations (scale, gravity tilt deg) "
          + json.dumps([(round(rec[1], 6), round(float(np.degrees(np.arccos(
              np.clip(rec[2][2, 2], -1, 1)))), 4))
              for rec in b["system"].local_mapping.init_debug]))

    seq_s = vi_prefix(seq, VI_STEREO_FRAMES)
    rights = vi_stereo_rights(seq_s)
    ns = VI_STEREO_FRAMES
    stereo = _vi_sensor_runs(ck, seq_s, "IMU_STEREO", "orb",
                             {"orb_fast": 2 * ns, "orb_describe": 2 * ns}, 2,
                             rights=rights, graphs_from=mono[1]["system"])
    for r, run in enumerate(stereo):
        check_vi_sensor_bars(f"IMU_STEREO orb run {r + 1}", "IMU_STEREO",
                             run["figures"])
    same = _vi_same(*stereo)
    print(f"IMU_STEREO orb: run 2 against run 1: poses and map bit-identical "
          f"{same}; timings (run 2): " + json.dumps(_vi_report(stereo[1])))
    check(same, "IMU_STEREO orb: run 2 differs from run 1")
    xs, = _vi_sensor_runs(ck, seq_s, "IMU_STEREO", "xfeat",
                          {"detect_candidates": 2 * ns,
                           "keypoint_desc": 2 * ns}, 1, rights=rights,
                          graphs_from=stereo[0]["system"], exact_first=True)
    print("IMU_STEREO xfeat: figures above without bars; timings "
          + json.dumps(_vi_report(xs)))
    check(xs["figures"]["imu_initialized"],
          "IMU_STEREO xfeat: the IMU was not initialized")
    check(all(st == "OK" for st in xs["states"][1:]),
          "IMU_STEREO xfeat: a pair from 1 was not OK")

    # the new solver calls, card against CPU
    by_static = mono[0]["by_static"]["inertial_init"]
    free = [c for c in by_static.values()
            if c[1]["prior_a"] == 1e6 and not c[1]["fix_scale"]]
    refine = [c for c in by_static.values() if c[1]["prior_g"] == 1e8]
    check(free, "IMU_MONOCULAR: no scale-free first initialization recorded")
    check(refine, "IMU_MONOCULAR: no scale refinement recorded")
    graph = getattr(b["system"].local_mapping._init_graph, "graph",
                    b["system"].local_mapping._init_graph)
    rows = inertial_solver_checks({"inertial_init": [free[0], refine[0]]},
                                  {"inertial_init": graph})
    rows["inertial_init_scale_free"] = rows.pop("inertial_init")
    rows["scale_refinement"] = rows.pop("inertial_init[1]")
    weld_calls, weld_graph = merge_inertial_ba_check(dev)
    rows["merge_inertial_ba_24_slots"] = inertial_solver_checks(
        {"local_inertial_ba": weld_calls},
        {"local_inertial_ba": weld_graph})["local_inertial_ba"]
    print("inertial mono/stereo solvers: " + json.dumps(rows))
    print(f"inertial mono/stereo phase: {time.perf_counter() - t_phase:.1f} s")
    return {"imu_mono": b["counts"], "imu_stereo": stereo[1]["counts"],
            "imu_stereo_xfeat": xs["counts"]}, rows


def run(batch: int, root: str):
    t_run = time.perf_counter()
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    sys.path.insert(0, REPO)
    from xfeatslam_tpu_torch import _build
    from xfeatslam_tpu_torch.models import weights
    from xfeatslam_tpu_torch.models.extractor import XFeatExtractor
    from xfeatslam_tpu_torch.ops import cuda_kernels as ck
    from xfeatslam_tpu_torch.ops import detect, matching
    from xfeatslam_tpu_torch.parallel import batched

    # ---- build ----
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(_build.KERNELS)} "
          f"kernel sources (parallel nvcc, sm_90a)")

    dev = torch.device("cuda")
    model = weights.load_npz(os.path.join(REPO, "weights", "xfeat_synthetic.npz"))
    t0 = time.perf_counter()
    images = torch.from_numpy(make_images(batch)).to(dev)
    print(f"images: {tuple(images.shape)} made in "
          f"{time.perf_counter() - t0:.2f} s")

    def main_path():
        o = batched.extract_batch(model, images, K)
        return o, batched.match_consecutive(o["desc"], o["valid"])

    # ---- the main path, counted ----
    ck.reset_launch_counts()
    out, res = main_path()
    torch.cuda.synchronize()
    launches = path_counts(ck, "extract_batch + match_consecutive",
                           BATCHED_KERNELS)
    check(out["kpts"].shape == (batch, K, 2) and out["desc"].shape == (batch, K, 64),
          "main path output shapes")
    for k in ("kpts", "scores", "desc"):
        check(bool(torch.isfinite(out[k]).all()), f"non-finite {k}")
    check(res.idx.shape == (batch - 1, K), "match output shape")
    nvalid = out["valid"].sum(1)
    check(bool((nvalid > 0).all()), "a frame has no keypoint")
    print(f"main path: valid keypoints per frame min {int(nvalid.min())} "
          f"max {int(nvalid.max())}; matches per pair mean "
          f"{float(res.mask.sum(1).float().mean()):.1f}")
    print(f"detect grids: batch {batch} "
          f"{detect_note(ck, batch, H // 8, W // 8)}; batch 1 "
          f"{detect_note(ck, 1, H // 8, W // 8)}")
    print(f"matcher grids: mutual_nn_pairs on the main path (P={batch - 1}, "
          f"N=M={K}) {grid_note(ck, batch - 1, K)}; similarity_top2 at "
          f"N=M={K} {grid_note(ck, 1, K)}")

    # ---- kernels against their plain versions, on the main path's tensors ----
    with torch.no_grad():
        feats, logits, heat = model(images)
    logits, heat = logits.contiguous(), heat.contiguous()
    B, H8, W8, _ = feats.shape
    feats_flat = feats.reshape(B, H8 * W8, 64).contiguous()

    report = {
        "detect_candidates": compare_detect(ck, logits, heat, 9, "main path"),
    }
    l1, h1 = logits[:1].contiguous(), heat[:1].contiguous()
    compare_detect(ck, l1, h1, 9, "main path's frame 0, batch 1")
    vk, ak = ck.detect_candidates(logits, heat)
    report["keypoint_desc"] = {"max_abs_err": max(
        compare_kpdesc(ck, feats_flat, vk, ak, K, sp, "main path")["max_abs_err"]
        for sp in (False, True))}
    idx4, w4 = detect.desc_taps(out["kpts"], out["valid"], H8, W8)
    report["bilinear_desc_sample"] = compare_desc(ck, feats_flat, idx4, w4,
                                                  "main path")
    # the descriptors-at-keypoints path (bilinear_desc_sample), counted
    ck.reset_launch_counts()
    d_s = detect.sample_descriptors(feats, out["kpts"], out["valid"])
    launches["bilinear_desc_sample"] = path_counts(
        ck, "sample_descriptors", {"bilinear_desc_sample": 1})[
            "bilinear_desc_sample"]
    err = float((d_s - out["desc"]).abs().max())
    print(f"sample_descriptors at the main path's keypoints vs its "
          f"descriptors: max abs err {err:.3e}")
    check(err <= 1e-5, "sample_descriptors disagrees with select_keypoints")
    extract_sync_check(ck, l1, h1, feats_flat[:1], vk[:1], ak[:1])
    desc, valid = out["desc"], out["valid"]
    args = (desc[:-1], desc[1:], valid[:-1], valid[1:])
    report["mutual_nn_pairs"] = compare_mnn(ck, args, "main path")
    odd_shape_checks(ck, detect, dev)
    matcher_checks(ck, dev, args)

    # ---- the whole path against the plain path on the same card ----
    with plain_kernels(ck):
        out_p = batched.extract_batch(model, images, K)
        res_p = batched.match_consecutive(out_p["desc"], out_p["valid"])
    mask_agree = float((res.mask == res_p.mask).float().mean())
    check(mask_agree >= 0.999, "match masks disagree with the plain path")
    kk, kp = out["kpts"].cpu().numpy(), out_p["kpts"].cpu().numpy()
    vk_, vp_ = out["valid"].cpu().numpy(), out_p["valid"].cpu().numpy()
    check((vk_.sum(1) == vp_.sum(1)).all(), "valid counts differ from the plain path")
    kj = min(jaccard(pixel_set(kk[b], vk_[b]), pixel_set(kp[b], vp_[b]))
             for b in range(batch))
    ik, ip = res.idx.cpu().numpy(), res_p.idx.cpu().numpy()
    pj = min(jaccard(pair_set(kk, ik, b), pair_set(kp, ip, b))
             for b in range(batch - 1))
    print(f"path vs plain path: keypoint Jaccard min {kj:.6f}, matched-pair "
          f"Jaccard min {pj:.6f}, match mask agreement {mask_agree:.6f}")
    check(kj >= 0.999, "keypoint sets differ from the plain path")
    check(pj >= 0.995, "matched pairs differ from the plain path")

    # ---- the SLAM extractor facade on a frame that needs resizing ----
    frame = (make_images(1)[0, :, :, 0] * 255).astype(np.uint8)
    frame = np.pad(frame, ((10, 10), (30, 30)), mode="reflect")[:500, :700]
    ex = XFeatExtractor()
    fo = ex(frame)
    check(fo["kpts"].shape == (1, 1000, 2) and fo["desc"].shape == (1, 1000, 64),
          "extractor output shapes")
    kv = fo["kpts"][0][fo["valid"][0]]
    check(len(kv) > 0, "extractor found no keypoint")
    lo, hi = kv.min(0), kv.max(0)
    # a border pixel's sub-pixel offset may reach one (resized) pixel out
    check(lo.min() >= -1.1 and hi[0] <= 700 and hi[1] <= 500,
          "extractor coordinates outside the frame")
    print(f"extractor: 500x700 frame -> {len(kv)} valid keypoints, x in "
          f"[{lo[0]:.3f}, {hi[0]:.3f}], y in [{lo[1]:.3f}, {hi[1]:.3f}]")

    # ---- the single-pair matcher path (kernel 4) ----
    launches4, report["similarity_top2"] = single_pair_phase(
        ck, matching, batched, desc, valid, res, dev)
    launches["similarity_top2"] = launches4["similarity_top2"]
    print("kernels: " + json.dumps(launches))

    # ---- the online RGB-D frame step ----
    lm_report = frame_step_phase(model, ck, dev)

    # ---- the RGB-D SLAM host, three runs; relocalization; localization ----
    run, seq, problems, slam_launches = slam_phase(ck, SLAM_FRAMES)
    t_next, last, reloc_lm_err = relocalization_phase(ck, run, seq)
    localization_phase(ck, run, seq, t_next, last)

    # ---- loop closing on bench.py's loop workload; the atlas files ----
    loop_phase(ck, run["system"].settings, dev)

    # ---- monocular SLAM; the dataset readers through the examples ----
    mono_phase(ck)
    reader_cfg, reader_seq = readers_phase(root)

    # ---- local BA on the card, eager and by graph replay ----
    _, ba_row = local_ba_phase(ck, problems, run["system"].settings, dev)

    # ---- timings ----
    P = batch - 1
    times = {}
    times["forward"] = cuda_ms(lambda: model(images))
    times["detect"] = cuda_ms(lambda: ck.detect_candidates(logits, heat))
    times["detect_b1"] = cuda_ms(lambda: ck.detect_candidates(l1, h1))
    times["detect_plain"] = cuda_ms(lambda: ck.detect_candidates_plain(logits, heat))
    times["topk"] = cuda_ms(lambda: torch.topk(vk.reshape(B, -1), K, dim=1))
    scores_k, sel_k = torch.topk(vk.reshape(B, -1), K, dim=1)
    kd_args = (feats_flat, scores_k, sel_k, ak, W8, False)
    times["kpdesc"] = cuda_ms(lambda: ck.keypoint_desc(*kd_args))
    times["kpdesc_plain"] = cuda_ms(lambda: ck.keypoint_desc_plain(*kd_args))
    times["desc"] = cuda_ms(lambda: ck.bilinear_desc_sample(feats_flat, idx4, w4))
    times["desc_plain"] = cuda_ms(
        lambda: ck.bilinear_desc_sample_plain(feats_flat, idx4, w4))
    fn = torch.nn.functional.normalize(feats, dim=-1).permute(0, 3, 1, 2)
    grid = torch.stack([out["kpts"][..., 0] / (W - 1) * 2 - 1,
                        out["kpts"][..., 1] / (H - 1) * 2 - 1], -1)[:, :, None]
    times["desc_library"] = cuda_ms(lambda: torch.nn.functional.grid_sample(
        fn, grid, mode="bilinear", align_corners=False))
    times["mnn"] = cuda_ms(lambda: ck.mutual_nn_pairs(*args))
    times["mnn_plain"] = cuda_ms(lambda: ck.mutual_nn_pairs_plain(*args))
    times["mnn_library"] = cuda_ms(lambda: torch.bmm(desc[:-1],
                                                     desc[1:].transpose(1, 2)))
    a0, b0, vb0 = desc[0], desc[1], valid[1]
    times["top2"] = cuda_ms(lambda: ck.similarity_top2(a0, b0, vb0))
    times["top2_plain"] = cuda_ms(lambda: ck.similarity_top2_plain(a0, b0, vb0))
    times["top2_library"] = cuda_ms(lambda: torch.mm(a0, b0.T))
    times["extract"] = cuda_ms(lambda: batched.extract_batch(model, images, K),
                               iters=10)
    times["match"] = cuda_ms(
        lambda: batched.match_consecutive(out["desc"], out["valid"]))
    times["match_per_pair"] = cuda_ms(
        lambda: batched.match_consecutive(out["desc"], out["valid"],
                                          fused=False), iters=5, warmup=1)
    times["end_to_end"] = cuda_ms(main_path, iters=10)
    print("stage ms at batch %d: %s" % (batch, json.dumps(
        {k: round(v, 4) for k, v in times.items()})))
    # the kernels' calls are short enough for host cost to show in the
    # times above; these are device times alone
    device = {
        "detect": graph_ms(lambda: ck.detect_candidates(logits, heat)),
        "detect_b1": graph_ms(lambda: ck.detect_candidates(l1, h1)),
        "topk": graph_ms(lambda: torch.topk(vk.reshape(B, -1), K, dim=1)),
        "kpdesc": graph_ms(lambda: ck.keypoint_desc(*kd_args)),
        "desc": graph_ms(lambda: ck.bilinear_desc_sample(feats_flat, idx4, w4)),
        "mnn": graph_ms(lambda: ck.mutual_nn_pairs(*args)),
        "mnn_library": graph_ms(lambda: torch.bmm(desc[:-1],
                                                  desc[1:].transpose(1, 2))),
        "top2": graph_ms(lambda: ck.similarity_top2(a0, b0, vb0)),
        "top2_library": graph_ms(lambda: torch.mm(a0, b0.T)),
    }
    print("kernel device ms per call (CUDA-graph replay): " + json.dumps(
        {k: round(v, 5) for k, v in device.items()}))
    print(f"end to end: {batch / times['end_to_end'] * 1e3:.1f} frames/s "
          f"({times['end_to_end']:.3f} ms per batch of {batch})")

    # ---- bounds from this run's inputs ----
    nz = w4 != 0
    grid_rows = idx4.long() + (torch.arange(B, device=dev) * H8 * W8)[:, None, None]
    touched = int(torch.unique(grid_rows[nz]).numel())
    nvb = valid[1:].sum(1).double()
    bounds = {
        "detect_candidates": bound_ms(
            (logits.numel() + heat.numel() + vk.numel() + ak.numel()) * 4,
            DETECT_OPS_PER_PIXEL * B * H * W),
        "bilinear_desc_sample": bound_ms(
            touched * 64 * 4 + (idx4.numel() + w4.numel() + B * K * 64) * 4,
            int(nz.sum()) * 64 * 4 + B * K * 64 * 3),
        # the touched grid rows, sel (int64), the gathered aux, the scores,
        # the kpts and desc writes; the same sampling work
        "keypoint_desc": bound_ms(
            touched * 64 * 4 + B * K * (8 + 4 + 4 + 2 * 4 + 64 * 4),
            int(nz.sum()) * 64 * 4 + B * K * 64 * 3),
        # one similarity matrix over the valid columns gives both passes
        "mutual_nn_pairs": bound_ms(
            2 * P * K * 64 * 4 + 2 * P * K + 4 * P * K * 4,
            float(2 * 64 * K * nvb.sum())),
        # one pair: both banks and the mask read, three rows written; the
        # similarities over the valid columns
        "similarity_top2": bound_ms(2 * K * 64 * 4 + K + 3 * K * 4,
                                    float(2 * 64 * K * vb0.sum())),
    }
    timed = {"detect_candidates": ("detect", "detect_plain", None),
             "bilinear_desc_sample": ("desc", "desc_plain", "desc_library"),
             "keypoint_desc": ("kpdesc", "kpdesc_plain", None),
             "mutual_nn_pairs": ("mnn", "mnn_plain", "mnn_library"),
             "similarity_top2": ("top2", "top2_plain", "top2_library")}
    rows_out = []
    for name, (t_k, t_p, t_l) in timed.items():
        src, rep = KERNEL_SOURCES[name]
        b_ms, b_by = bounds[name]
        rows_out.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name],
            "max_abs_err": report[name]["max_abs_err"],
            "ms": times[t_k], "plain_ms": times[t_p],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": times[t_l] if t_l else None,
        })
    # the pose LM: launches on the SLAM path (System.track_rgbd, run 1, two
    # per frame step, replays included); its numbers from the frame-step
    # phase; no single PyTorch call computes it
    src, rep = KERNEL_SOURCES["pose_lm"]
    b_ms, b_by = lm_report["bound"]
    rows_out.append({
        "name": "pose_lm", "route": "cuda", "source": src, "replaces": rep,
        "launches": slam_launches["pose_lm"],
        "max_abs_err": max(lm_report["max_abs_err"], reloc_lm_err),
        "ms": lm_report["ms"], "plain_ms": lm_report["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })
    # the BA solver: launches on the SLAM path (run 1, local mapping's
    # rounds by replay); its numbers from the local-BA phase on the SLAM
    # run's problem at (5, 0); no single PyTorch call computes it
    src, rep = KERNEL_SOURCES["local_ba"]
    b_ms, b_by = ba_row["bound"]
    rows_out.append({
        "name": "local_ba", "route": "cuda", "source": src, "replaces": rep,
        "launches": slam_launches["local_ba"],
        "max_abs_err": ba_row["max_abs_err"],
        "ms": ba_row["ms"], "plain_ms": ba_row["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })

    # ---- the ORB backend: extractor and its kernels, RGB-D SLAM, readers ----
    orb_launches, orb_rows, orb_reloc_lm_err = orb_phase(
        ck, root, reader_cfg, reader_seq)
    # the pose LM also against its plain version on the ORB
    # relocalizations' calls
    for row in rows_out:
        if row["name"] == "pose_lm":
            row["max_abs_err"] = max(row["max_abs_err"], orb_reloc_lm_err)

    # ---- stereo: XFeat, ORB, the fisheye rig, rectification ----
    stereo_launches = stereo_phase(ck)
    orb_stereo_launches = orb_stereo_phase(ck)
    fisheye_phase(ck)
    rectification_phase(root)

    # ---- visual-inertial RGB-D: ORB and XFeat Systems, the solvers ----
    vi_launches, _, vi_system = inertial_phase(ck)
    # ---- monocular and stereo inertial: the Systems, the new solver calls --
    vi2_launches, _ = inertial_mono_stereo_phase(ck, vi_system)

    # the ORB kernels: launches on the ORB stereo path (its second run)
    for name in ("orb_fast", "orb_describe"):
        src, rep = KERNEL_SOURCES[name]
        r = orb_rows[name]
        b_ms, b_by = r["bound"]
        rows_out.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": orb_stereo_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r["library_ms"],
        })
    # the kernels' launches on the ORB RGB-D path (its second run) and on
    # the XFeat stereo path (its second run)
    for row in rows_out:
        if row["name"] in ORB_SLAM_KERNELS:
            row["orb_launches"] = orb_launches[row["name"]]
        if row["name"] in stereo_launches and row["name"] in (
                "detect_candidates", "keypoint_desc", "pose_lm", "local_ba"):
            row["stereo_launches"] = stereo_launches[row["name"]]
        if vi_launches.get(row["name"]):
            row["imu_rgbd_launches"] = vi_launches[row["name"]]
        for col, counts in (("imu_mono_launches", vi2_launches["imu_mono"]),
                            ("imu_stereo_launches",
                             vi2_launches["imu_stereo"]),
                            ("imu_stereo_xfeat_launches",
                             vi2_launches["imu_stereo_xfeat"])):
            if counts.get(row["name"]):
                row[col] = counts[row["name"]]
    print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s in all")
    print(json.dumps({"kernels": rows_out}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32,
                    help="frames per batch of the main path (default 32)")
    args = ap.parse_args()
    if args.batch < 2:
        ap.error("--batch must be at least 2 (frames are matched in pairs)")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA device", file=sys.stderr)
        return 1
    try:
        with tempfile.TemporaryDirectory() as root:
            run(args.batch, root)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

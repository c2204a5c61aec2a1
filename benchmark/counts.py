"""The work that the extract-and-match pass needs for given inputs, counted
from the shapes and the valid counts alone: the yardstick of the rooflines
and of ``step_mfu``. Never what a kernel happens to launch or read again,
so a later kernel that fuses, skips or renames work is measured against
the same numbers.
"""

from __future__ import annotations

F32 = 4
DESC = 64


def conv_flops(hw) -> int:
    """FLOPs of XFeat's convolutions for one frame of network input ``hw``
    (two per multiply-add; a frozen copy of the port's
    ``tools/profile_pipeline.conv_flops``). The bilinear upsampling, the
    norm, the pooling and the pointwise ops are left out: they are a few
    operations a pixel against thousands."""
    H, W = hw
    layers = [  # (Hout, Wout, cin, cout, k)
        (H, W, 1, 4, 3), (H // 2, W // 2, 4, 8, 3),
        (H // 2, W // 2, 8, 8, 3), (H // 4, W // 4, 8, 24, 3),  # block1
        (H // 4, W // 4, 1, 24, 1),  # skip1
        (H // 4, W // 4, 24, 24, 3), (H // 4, W // 4, 24, 24, 3),  # block2
        (H // 8, W // 8, 24, 64, 3), (H // 8, W // 8, 64, 64, 3),
        (H // 8, W // 8, 64, 64, 1),  # block3
        (H // 16, W // 16, 64, 64, 3), (H // 16, W // 16, 64, 64, 3),
        (H // 16, W // 16, 64, 64, 3),  # block4
        (H // 32, W // 32, 64, 128, 3), (H // 32, W // 32, 128, 128, 3),
        (H // 32, W // 32, 128, 128, 3), (H // 32, W // 32, 128, 64, 1),
        (H // 8, W // 8, 64, 64, 3), (H // 8, W // 8, 64, 64, 3),
        (H // 8, W // 8, 64, 64, 1),  # fusion
        (H // 8, W // 8, 64, 64, 1), (H // 8, W // 8, 64, 64, 1),
        (H // 8, W // 8, 64, 1, 1),  # heatmap head
        (H // 8, W // 8, 64, 64, 1), (H // 8, W // 8, 64, 64, 1),
        (H // 8, W // 8, 64, 64, 1), (H // 8, W // 8, 64, 65, 1),  # kp head
    ]
    return sum(2 * h * w * ci * co * k * k for (h, w, ci, co, k) in layers)


def select_bytes(frames: int, hw, K: int) -> int:
    """Bytes that keypoint selection must move for ``frames`` frames of
    network input ``hw``: the dense descriptors (64), logits (65) and
    reliability (1) of every stride-8 cell read once as float32; each
    keypoint slot's position (2), score and descriptor (64) written once as
    float32 and its valid flag as one byte."""
    H8, W8 = hw[0] // 8, hw[1] // 8
    read = frames * H8 * W8 * (DESC + 65 + 1) * F32
    write = frames * K * ((2 + 1 + DESC) * F32 + 1)
    return read + write


def match_ops(valid_counts) -> int:
    """Operations of the mutual nearest-neighbour match of consecutive
    frames with ``valid_counts`` valid keypoints each: a 64-long dot
    product (128 operations) for every valid row against every valid
    column of the next frame."""
    v = list(valid_counts)
    return sum(2 * DESC * a * b for a, b in zip(v[:-1], v[1:]))


def match_bytes(frames: int, K: int) -> int:
    """Bytes the match must move: every frame's descriptors (float32) and
    valid flags read once; each pair's column index, distance (4 bytes
    each) and mask (1 byte) per row written once."""
    return frames * K * (DESC * F32 + 1) + max(frames - 1, 0) * K * (4 + 4 + 1)


def roofline_s(ops: float, nbytes: float, peaks) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory bandwidth."""
    return max(ops / peaks["fp32_flops"], nbytes / peaks["hbm_bytes_per_s"])

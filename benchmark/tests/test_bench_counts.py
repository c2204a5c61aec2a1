"""The yardstick's counts: the frozen conv FLOPs against the port's layer
list, and the selection and match counts on cases worked by hand."""

import pytest

from benchmark import counts
from benchmark.reference import xfeat as ref
from xfeatslam_tpu_torch.models import xfeat as port


def _flops_from(stacks, finals, hw):
    """Conv FLOPs from a layer table: each stack's resolution follows its
    strides from the input; the skip runs at 1/4, the fusion and the heads
    at 1/8."""
    H, W = hw
    total, scale = 0, 1
    res = {}
    for name in ("block1", "block2", "block3", "block4", "block5"):
        for cin, cout, k, s in stacks[name]:
            scale *= s
            total += 2 * (H // scale) * (W // scale) * cin * cout * k * k
        res[name] = scale
    for name in ("block_fusion", "heatmap_head", "keypoint_head"):
        for cin, cout, k, s in stacks[name]:
            total += 2 * (H // 8) * (W // 8) * cin * cout * k * k
    at = {"skip1_conv": 4, "block_fusion_final": 8, "heatmap_final": 8,
          "keypoint_final": 8}
    for name, (cin, cout, k) in finals.items():
        total += 2 * (H // at[name]) * (W // at[name]) * cin * cout * k * k
    return total


@pytest.mark.parametrize("hw", [(480, 640), (352, 1216), (64, 96)])
def test_conv_flops_follow_the_layer_list(hw):
    assert counts.conv_flops(hw) == _flops_from(port._BASIC_STACKS,
                                                port._FINAL_CONVS, hw)
    assert counts.conv_flops(hw) == _flops_from(ref.STACKS, ref.FINALS, hw)


def test_conv_flops_at_vga():
    # 2.62 GFLOP a frame at 640x480 (the figure PERF.md has used)
    assert counts.conv_flops((480, 640)) == 2_621_952_000


def test_select_bytes_by_hand():
    # 2 frames of 16x24 (2x3 cells), K=4: 130 floats a cell read;
    # 2 + 1 + 64 floats and one flag a slot written
    assert counts.select_bytes(2, (16, 24), 4) == (
        2 * 6 * 130 * 4 + 2 * 4 * (67 * 4 + 1))


def test_match_counts_by_hand():
    # valid 3, 5, 0: pairs 3x5 and 5x0 -> 15 dot products of 64
    assert counts.match_ops([3, 5, 0]) == 15 * 128
    assert counts.match_ops([7]) == 0
    # 3 frames, K=4: 4*(256+1) a frame read; 2 pairs x 4 rows x 9 written
    assert counts.match_bytes(3, 4) == 3 * 4 * 257 + 2 * 4 * 9


def test_roofline_takes_the_larger_bound():
    peaks = {"fp32_flops": 1e3, "hbm_bytes_per_s": 1e2}
    assert counts.roofline_s(2e3, 1e2, peaks) == 2.0
    assert counts.roofline_s(1e3, 5e2, peaks) == 5.0

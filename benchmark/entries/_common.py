"""What the entries share: the configuration's dtype, the checks that the
configuration states what the entry computes, and the answers' names."""

import inspect

import torch

from xfeatslam_tpu_torch.ops import detect

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype(cfg):
    return DTYPES[cfg["dtype"]]


def check(cfg, subpixel: bool):
    """The configuration states what the entry computes: its sub-pixel
    choice, and the detection threshold it cannot pass (the program's
    default)."""
    ex = cfg["extractor"]
    if ex["subpixel"] != subpixel:
        raise ValueError(f"{cfg['name']}: subpixel {ex['subpixel']}, the "
                         f"entry computes {subpixel}")
    thr = inspect.signature(detect.select_keypoints).parameters["threshold"]
    if ex["threshold"] != thr.default:
        raise ValueError(f"{cfg['name']}: threshold {ex['threshold']}, the "
                         f"program's is {thr.default}")


def check_defaults(cfg, match):
    """The matcher's limits, where the entry cannot pass them, are the
    program's defaults."""
    params = inspect.signature(match).parameters
    for key in ("max_dist", "ratio"):
        if cfg["matcher"][key] != params[key].default:
            raise ValueError(f"{cfg['name']}: matcher {key} "
                             f"{cfg['matcher'][key]}, the program's is "
                             f"{params[key].default}")


def with_matches(out, res):
    """The extraction's answers and the matches', by name."""
    return {**out, "match_idx": res.idx, "match_dist": res.dist,
            "match_mask": res.mask}

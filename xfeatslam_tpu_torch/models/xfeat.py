"""XFeat network (CVPR 2024 'XFeat: Accelerated Features') as a torch module.

Counterpart of ``xfeatslam_tpu/models/xfeat.py``. BatchNorm (affine=False)
running statistics are folded into the conv weights when parameters are
built (``models/weights.py``), so inference is conv + bias + relu only.

Public layout follows the JAX package: ``XFeat.forward`` takes images as
(B,H,W,C) and returns feats (B,H8,W8,64), logits (B,H8,W8,65) and heatmap
(B,H8,W8,1). Inside, the convolutions run in NCHW with
``memory_format=torch.channels_last``, so the returned NHWC tensors are
free views of the conv outputs.

Architecture (see the JAX module's docstring for the reference mapping):
  norm       InstanceNorm2d(1)
  skip1      AvgPool(4,4) -> Conv1x1(1->24)
  block1..5  BasicLayer stacks (``_BASIC_STACKS``)
  fusion     BasicLayer(64->64 s1) x2 + Conv1x1(64->64, bias)
  heatmap    BasicLayer(64->64 k1) x2 + Conv1x1(64->1, bias) + sigmoid
  keypoint   pixel_unshuffle(x, 8): BasicLayer(64->64 k1) x3 + Conv1x1(64->65)
  fine_matcher  MLP 128->512x4->64
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5

# (name, [(cin, cout, ksize, stride), ...]) for the BasicLayer stacks.
_BASIC_STACKS = {
    "block1": [(1, 4, 3, 1), (4, 8, 3, 2), (8, 8, 3, 1), (8, 24, 3, 2)],
    "block2": [(24, 24, 3, 1), (24, 24, 3, 1)],
    "block3": [(24, 64, 3, 2), (64, 64, 3, 1), (64, 64, 1, 1)],
    "block4": [(64, 64, 3, 2), (64, 64, 3, 1), (64, 64, 3, 1)],
    "block5": [(64, 128, 3, 2), (128, 128, 3, 1), (128, 128, 3, 1), (128, 64, 1, 1)],
    "block_fusion": [(64, 64, 3, 1), (64, 64, 3, 1)],
    "heatmap_head": [(64, 64, 1, 1), (64, 64, 1, 1)],
    "keypoint_head": [(64, 64, 1, 1), (64, 64, 1, 1), (64, 64, 1, 1)],
}
# (name, cin, cout, ksize) for the plain (bias) convs that end each head.
_FINAL_CONVS = {
    "skip1_conv": (1, 24, 1),
    "block_fusion_final": (64, 64, 1),
    "heatmap_final": (64, 1, 1),
    "keypoint_final": (64, 65, 1),
}
_FINE_MATCHER = [(128, 512), (512, 512), (512, 512), (512, 512), (512, 64)]


def _conv(x, conv: nn.Conv2d, dt=torch.float32, out_dt=torch.float32):
    """Conv with the JAX package's ``compute_dtype`` semantics: input and
    weights cast to ``dt``, bias added in float32, result stored as
    ``out_dt``. Under float32 this is one plain conv. Under a narrower
    ``dt`` PyTorch accumulates in float32 inside the conv but returns ``dt``,
    so the sum is rounded to ``dt`` once before the float32 bias add (the
    JAX package rounds after it)."""
    if dt == torch.float32:
        y = F.conv2d(x.float(), conv.weight, conv.bias, conv.stride,
                     conv.padding)
        return y if out_dt == torch.float32 else y.to(out_dt)
    y = F.conv2d(x.to(dt), conv.weight.to(dt), None, conv.stride,
                 conv.padding)
    return (y.float() + conv.bias.float()[None, :, None, None]).to(out_dt)


def _basic_stack(x, convs, dt=torch.float32):
    for conv in convs:
        x = torch.relu(_conv(x, conv, dt, out_dt=dt))
    return x


def instance_norm(x, eps: float = BN_EPS):
    """InstanceNorm over (H, W) per sample/channel, NCHW, population
    variance (torch InstanceNorm2d, affine=False)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def unfold2d(x, ws: int = 8):
    """Space-to-depth on an NCHW map: (B,C,H,W) -> (B,C*ws*ws,H/ws,W/ws),
    channel = i*ws+j with i the row offset (= the JAX ``unfold2d``)."""
    return F.pixel_unshuffle(x, ws)


def _resize_bilinear(x, out_hw):
    """Bilinear upsample with half-pixel centers (align_corners=False)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False)


class XFeat(nn.Module):
    """The folded inference network. Parameters are created empty-shaped
    here and filled by ``init_model`` or ``models/weights.py``."""

    def __init__(self):
        super().__init__()
        for name, layers in _BASIC_STACKS.items():
            setattr(self, name, nn.ModuleList(
                nn.Conv2d(cin, cout, ks, stride=s, padding=ks // 2)
                for (cin, cout, ks, s) in layers))
        for name, (cin, cout, ks) in _FINAL_CONVS.items():
            setattr(self, name, nn.Conv2d(cin, cout, ks))
        self.fine_matcher = nn.ModuleList(
            nn.Linear(cin, cout) for (cin, cout) in _FINE_MATCHER)

    def forward(self, x, compute_dtype=torch.float32):
        """XFeat forward pass.

        Args:
          x: (B, H, W, C) float images in [0,1], H and W multiples of 32.
          compute_dtype: torch.bfloat16 casts conv inputs and weights; heads
            always come out float32.
        Returns feats (B,H8,W8,64), logits (B,H8,W8,65), heatmap (B,H8,W8,1).
        """
        dt = compute_dtype
        x = x.float().mean(dim=-1, keepdim=True).permute(0, 3, 1, 2)
        x = instance_norm(x).contiguous(memory_format=torch.channels_last)

        x1 = _basic_stack(x, self.block1, dt)
        skip = _conv(F.avg_pool2d(x, 4, 4), self.skip1_conv, dt, out_dt=dt)
        x2 = _basic_stack(x1 + skip, self.block2, dt)
        x3 = _basic_stack(x2, self.block3, dt)
        x4 = _basic_stack(x3, self.block4, dt)
        x5 = _basic_stack(x4, self.block5, dt)

        hw8 = x3.shape[-2:]
        fused = _basic_stack(
            x3 + _resize_bilinear(x4, hw8) + _resize_bilinear(x5, hw8),
            self.block_fusion, dt)
        feats = _conv(fused, self.block_fusion_final, dt)

        h = _basic_stack(feats, self.heatmap_head, dt)
        heatmap = torch.sigmoid(_conv(h, self.heatmap_final, dt))

        k = _basic_stack(unfold2d(x.to(dt), 8), self.keypoint_head, dt)
        logits = _conv(k, self.keypoint_final, dt)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        return nhwc(feats), nhwc(logits), nhwc(heatmap)


def fine_matcher_mlp(model: XFeat, x):
    """The refinement MLP (128 -> 64 logits). x: (..., 128)."""
    h = x
    n = len(model.fine_matcher)
    for i, lin in enumerate(model.fine_matcher):
        h = lin(h)
        if i < n - 1:
            h = torch.relu(h)
    return h


def init_params(seed: int = 0, analytic_detector: bool = True) -> dict:
    """Deterministic He-init parameters as a numpy pytree in the JAX
    package's layout (HWIO convs, (in,out) linears), drawn from a
    ``torch.Generator``. The numbers differ from ``jax.random``'s for the
    same seed; the analytic keypoint head (a local-contrast detector, see
    the JAX ``init_params``) is deterministic and identical."""
    g = torch.Generator().manual_seed(seed)

    def he(shape, fan_in):
        w = torch.randn(shape, generator=g) * math.sqrt(2.0 / fan_in)
        return w.numpy().astype(np.float32)

    params: dict = {}
    for name, layers in _BASIC_STACKS.items():
        params[name] = [
            {"w": he((ks, ks, cin, cout), ks * ks * cin),
             "b": np.zeros((cout,), np.float32)}
            for (cin, cout, ks, _s) in layers]
    for name, (cin, cout, ks) in _FINAL_CONVS.items():
        params[name] = {"w": he((ks, ks, cin, cout), ks * ks * cin),
                        "b": np.zeros((cout,), np.float32)}
    params["fine_matcher"] = [
        {"w": he((cin, cout), cin), "b": np.zeros((cout,), np.float32)}
        for (cin, cout) in _FINE_MATCHER]

    if analytic_detector:
        eye = np.eye(64, dtype=np.float32)[None, None]
        for i in range(3):
            params["keypoint_head"][i] = {
                "w": eye.copy(), "b": np.full((64,), 10.0, np.float32)}
        gain = 5.0
        w_final = gain * (np.eye(64, dtype=np.float32) - 1.0 / 64.0)
        w_final = np.concatenate([w_final, np.zeros((64, 1), np.float32)], 1)
        params["keypoint_final"] = {"w": w_final[None, None],
                                    "b": np.zeros((65,), np.float32)}
    return params

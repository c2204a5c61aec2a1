"""XFeat network (CVPR 2024 'XFeat: Accelerated Features') as a torch module.

Counterpart of ``xfeatslam_tpu/models/xfeat.py``. BatchNorm (affine=False)
running statistics are folded into the conv weights when parameters are
built (``models/weights.py``), so inference is conv + bias + relu only.

Public layout follows the JAX package: ``XFeat.forward`` takes images as
(B,H,W,C) and returns feats (B,H8,W8,64), logits (B,H8,W8,65) and heatmap
(B,H8,W8,1). Inside, the convolutions run in NCHW with
``memory_format=torch.channels_last``, so the returned NHWC tensors are
free views of the conv outputs. The stem (norm, block1, skip1 and the
keypoint head's unfold2d) is one hand-written kernel on a float32
inference pass over gray frames on a card (``ops/cuda_kernels.xfeat_stem``,
``XFeat._stem_on_kernel``), and these ops (``stem_plain``) everywhere else.

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

from ..ops import cuda_kernels as ck
from ..utils.timing import span

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
    ``out_dt``. Under float32 this is one plain conv in the parameters'
    dtype (float32, or float64 for a model made ``.double()`` as a
    reference). Under a narrower ``dt`` PyTorch accumulates in float32
    inside the conv but returns ``dt``, so the sum is rounded to ``dt`` once
    before the float32 bias add (the JAX package rounds after it).

    A conv partitioned over a mesh's "model" axis (``parallel/train.py``)
    holds part of its output channels and a ``model_split``
    (``parallel/mesh.ModelSplit``) that gathers the rest."""
    split = getattr(conv, "model_split", None)
    if split is not None:
        x = split.enter(x)
    if dt == torch.float32:
        y = F.conv2d(x.to(conv.weight.dtype), conv.weight, conv.bias,
                     conv.stride, conv.padding)
        y = y if out_dt == torch.float32 else y.to(out_dt)
    else:
        y = F.conv2d(x.to(dt), conv.weight.to(dt), None, conv.stride,
                     conv.padding)
        y = (y.float() + conv.bias.float()[None, :, None, None]).to(out_dt)
    return y if split is None else split.leave(y)


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


# upsampling matrices, keyed by (n_in, n_out, device, dtype)
_UPSAMPLE: dict = {}


def stem_plain(x, block1, skip1_conv, dt=torch.float32):
    """The stem op by op: gray mean, instance norm, ``block1``, the 4x4
    average pool and ``skip1_conv``, their sum, and ``unfold2d`` of the
    normalized frame, in ``compute_dtype`` ``dt``. Returns ``block2``'s
    input and the keypoint head's input. The plain version of
    ``ops/cuda_kernels.xfeat_stem``."""
    x = x.mean(dim=-1, keepdim=True).permute(0, 3, 1, 2)
    x = instance_norm(x).contiguous(memory_format=torch.channels_last)
    x1 = _basic_stack(x, block1, dt)
    skip = _conv(F.avg_pool2d(x, 4, 4), skip1_conv, dt, out_dt=dt)
    return x1 + skip, unfold2d(x if dt == torch.float32 else x.to(dt), 8)


def _upsample_matrix(n_in: int, n_out: int, like):
    """The (n_out, n_in) weights of ``F.interpolate(mode="bilinear",
    align_corners=False)`` along one axis upsampled by an integer factor:
    output j samples at (j + 0.5) n_in / n_out - 0.5, clamped to the first
    sample, from its two neighbours, the last sample repeated. Every weight
    is a multiple of 1/8 for factors 2 and 4, exact in bfloat16 too. Cached
    on ``like``'s device in its dtype (the first call, outside any capture,
    makes them)."""
    key = (n_in, n_out, str(like.device), like.dtype)
    m = _UPSAMPLE.get(key)
    if m is None:
        j = torch.arange(n_out, dtype=torch.float64)
        src = ((j + 0.5) * (n_in / n_out) - 0.5).clamp(min=0.0)
        i0 = src.floor().long()
        lam = src - i0
        w = torch.zeros(n_out, n_in, dtype=torch.float64)
        jj = j.long()
        w.index_put_((jj, i0), 1.0 - lam, accumulate=True)
        w.index_put_((jj, (i0 + 1).clamp(max=n_in - 1)), lam,
                     accumulate=True)
        m = _UPSAMPLE[key] = w.to(like.device, like.dtype)
    return m


def _resize_bilinear(x, out_hw):
    """Bilinear upsample of NCHW ``x`` with half-pixel centers
    (align_corners=False) by integer factors: two products with fixed
    interpolation matrices on the channels-last layout, W then H, one
    batched GEMM each (within 5e-7 of ``F.interpolate`` on unit-variance
    inputs; the products follow ``torch.backends.cuda.matmul.allow_tf32``).
    Its backward is two more products, with no scatter, so a training step
    gives the same bits on every run (the CUDA backward of
    ``F.interpolate`` adds with atomics). Returns a channels-last view."""
    (B, C, h, w), (oh, ow) = x.shape, tuple(out_hw)
    if oh % h or ow % w:
        raise ValueError(f"upsample {h}x{w} -> {oh}x{ow}: integer factors")
    y = torch.matmul(_upsample_matrix(w, ow, x), x.permute(0, 2, 3, 1))
    y = torch.matmul(_upsample_matrix(h, oh, x), y.reshape(B, h, ow * C))
    return y.view(B, oh, ow, C).permute(0, 3, 1, 2)


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

    def _stem_on_kernel(self, x, dt) -> bool:
        """Whether the stem takes its kernel (``ops/cuda_kernels.xfeat_stem``):
        gray frames on a CUDA device, float32 weights and compute, no
        autograd record of the stem and none of its convs partitioned over
        a mesh. Everything else (the CPU, bf16, float64, training, the
        tensor-parallel convs) takes the plain ops."""
        convs = (*self.block1, self.skip1_conv)
        params = [p for c in convs for p in (c.weight, c.bias)]
        return (x.is_cuda and x.shape[-1] == 1 and dt == torch.float32
                and all(p.dtype == torch.float32 for p in params)
                and not (torch.is_grad_enabled() and (
                    x.requires_grad or any(p.requires_grad for p in params)))
                and all(getattr(c, "model_split", None) is None
                        for c in convs))

    def forward(self, x, compute_dtype=torch.float32):
        """XFeat forward pass.

        Args:
          x: (B, H, W, C) float images in [0,1], H and W multiples of 32.
          compute_dtype: torch.bfloat16 casts conv inputs and weights; heads
            always come out float32.
        Returns feats (B,H8,W8,64), logits (B,H8,W8,65), heatmap (B,H8,W8,1).
        """
        with span("xfeat.network"):
            dt = compute_dtype
            # float32, or float64 for a model made ``.double()`` as a
            # reference
            x = x.to(self.block1[0].weight.dtype)
            with span("xfeat.stem"):
                if self._stem_on_kernel(x, dt):
                    x1, unfolded = ck.xfeat_stem(x.contiguous(), self.block1,
                                                 self.skip1_conv)
                else:
                    x1, unfolded = stem_plain(x, self.block1,
                                              self.skip1_conv, dt)
            x2 = _basic_stack(x1, self.block2, dt)
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

            k = _basic_stack(unfolded, self.keypoint_head, dt)
            logits = _conv(k, self.keypoint_final, dt)

            def nhwc(t):
                return t.permute(0, 2, 3, 1)

            return nhwc(feats), nhwc(logits), nhwc(heatmap)


def fine_matcher_mlp(model: XFeat, x):
    """The refinement MLP (128 -> 64 logits). x: (..., 128)."""
    h = x
    n = len(model.fine_matcher)
    for i, lin in enumerate(model.fine_matcher):
        split = getattr(lin, "model_split", None)  # as in ``_conv``
        h = lin(h) if split is None else split.leave(lin(split.enter(h)))
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

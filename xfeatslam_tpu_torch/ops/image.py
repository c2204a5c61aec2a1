"""Image preprocessing and sampling ops (NHWC, fixed shapes).

Counterpart of ``xfeatslam_tpu/ops/image.py``: the same half-pixel resize
and the reference sampler's grid_sample normalization chain, on tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device


def to_float_image(img, device=None):
    """uint8 (B,H,W,C) or (H,W[,C]) -> float32 (B,H,W,C) in [0,1], on CUDA
    unless ``device`` says otherwise."""
    dev = resolve_device(device)
    x = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.asarray(img))
    if x.ndim == 2:
        x = x[None, :, :, None]
    elif x.ndim == 3:
        x = x[None]
    x = x.to(dev)
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x.float()


def resize_bilinear(x, out_hw):
    """Half-pixel-center bilinear resize of (B,H,W,C). Antialiased when it
    shrinks, like ``jax.image.resize``, which the JAX package uses: without
    the antialias filter a 500x700 -> 480x672 shrink differs from JAX by up
    to 0.084, with it by about 3e-6."""
    _, H, W, _ = x.shape
    shrink = out_hw[0] < H or out_hw[1] < W
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw),
                      mode="bilinear", align_corners=False, antialias=shrink)
    return y.permute(0, 2, 3, 1)


def _grid_sample_coords(coords_xy, src_hw, norm_hw):
    """Map keypoint coords to source-grid positions, replicating the
    reference sampler's normalization chain (normgrid by (W-1,H-1) then
    grid_sample align_corners=False):  px = x * Ws / (Wn - 1) - 0.5."""
    Hs, Ws = src_hw
    Hn, Wn = norm_hw
    px = coords_xy[..., 0] * (Ws / (Wn - 1.0)) - 0.5
    py = coords_xy[..., 1] * (Hs / (Hn - 1.0)) - 0.5
    return px, py


def _gather_rows(img, yi, xi):
    """img (B,Hs,Ws,C) at integer (yi, xi) (B,K); zero out of bounds."""
    B, Hs, Ws, C = img.shape
    inb = (yi >= 0) & (yi < Hs) & (xi >= 0) & (xi < Ws)
    idx = yi.clamp(0, Hs - 1) * Ws + xi.clamp(0, Ws - 1)
    vals = torch.gather(img.reshape(B, Hs * Ws, C), 1,
                        idx[..., None].expand(-1, -1, C))
    return vals * inb[..., None]


def sample_bilinear(img, coords_xy, norm_hw):
    """Sparse bilinear sampling with zero padding (grid_sample parity).

    img (B,Hs,Ws,C), coords_xy (B,K,2) in the ``norm_hw`` pixel frame ->
    (B,K,C)."""
    _, Hs, Ws, _ = img.shape
    px, py = _grid_sample_coords(coords_xy, (Hs, Ws), norm_hw)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = (px - x0)[..., None]
    wy = (py - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    return (_gather_rows(img, y0i, x0i) * (1 - wx) * (1 - wy)
            + _gather_rows(img, y0i, x0i + 1) * wx * (1 - wy)
            + _gather_rows(img, y0i + 1, x0i) * (1 - wx) * wy
            + _gather_rows(img, y0i + 1, x0i + 1) * wx * wy)


def sample_nearest(img, coords_xy, norm_hw):
    """Sparse nearest sampling with zero padding (grid_sample parity)."""
    _, Hs, Ws, _ = img.shape
    px, py = _grid_sample_coords(coords_xy, (Hs, Ws), norm_hw)
    xi = torch.floor(px + 0.5).long()
    yi = torch.floor(py + 0.5).long()
    return _gather_rows(img, yi, xi)


def dense_grid_sample_bilinear(img, out_hw):
    """``sample_bilinear`` evaluated at every pixel of an ``out_hw`` grid,
    as two separable 1-D passes (x, then y)."""
    _, Hs, Ws, _ = img.shape
    Hn, Wn = out_hw

    def axis_weights(n_out, n_src, n_norm):
        pos = (torch.arange(n_out, dtype=torch.float32, device=img.device)
               * (n_src / (n_norm - 1.0)) - 0.5)
        i0 = torch.floor(pos)
        w = pos - i0
        i0 = i0.long()
        inb0 = (i0 >= 0) & (i0 < n_src)
        inb1 = (i0 + 1 >= 0) & (i0 + 1 < n_src)
        return (i0.clamp(0, n_src - 1), (i0 + 1).clamp(0, n_src - 1),
                (1 - w) * inb0, w * inb1)

    x0, x1, wx0, wx1 = axis_weights(Wn, Ws, Wn)
    y0, y1, wy0, wy1 = axis_weights(Hn, Hs, Hn)
    gx = (img[:, :, x0, :] * wx0[None, None, :, None]
          + img[:, :, x1, :] * wx1[None, None, :, None])
    return (gx[:, y0, :, :] * wy0[None, :, None, None]
            + gx[:, y1, :, :] * wy1[None, :, None, None])

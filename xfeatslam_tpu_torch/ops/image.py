"""Image preprocessing and sampling ops (NHWC, fixed shapes).

Counterpart of ``xfeatslam_tpu/ops/image.py``: the same half-pixel resize
and the reference sampler's grid_sample normalization chain, on tensors.
"""

from __future__ import annotations

import numpy as np
import torch

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


# jax.image.resize's column sums (XLA:CPU splits a long reduction into
# windows of this many terms, each summed in order, then sums the windows)
_SUM_WINDOW = 32
_EPS32 = float(np.finfo(np.float32).eps)
# (n_in, n_out, device) -> (tap indices (n_out, T) int64, the float32 weights
# (n_out, T) held as float64)
_TAPS: dict = {}


def _fma32(a, b, c):
    """float32 a * b + c rounded once, as a fused multiply-add: the product
    of two float32 values is exact in float64, so one float64 sum and the
    rounding to float32 give the fused result (but for double-rounding
    ties, which no input here has shown)."""
    return (a.double() * b.double() + c.double()).float()


def resize_weights(n_in: int, n_out: int):
    """The (n_in, n_out) float32 weights of one axis of
    ``jax.image.resize(..., "bilinear")`` (``compute_weight_mat`` with the
    triangle kernel and its default antialias), with the float32 operations
    XLA:CPU compiles it to: sample positions ``(j + 0.5) * inv - 0.5`` by a
    fused multiply-add, the kernel widened by 1 / scale when shrinking (a
    multiply by the float32 reciprocal, not a division), each column
    divided by its sum (in windows of 32) where that sum exceeds 1000 eps,
    and columns whose sample falls outside [-0.5, n_in - 0.5] zeroed."""
    f32 = torch.float32
    inv = 1.0 / (n_out / n_in)
    c1 = torch.tensor(inv, dtype=f32)
    j5 = torch.arange(n_out, dtype=f32) + 0.5
    sample = _fma32(j5, c1, torch.tensor(-0.5, dtype=f32))
    d = (sample[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs()
    if inv > 1.0:  # shrinking: the antialias widens the triangle
        d = d * (torch.tensor(1.0, dtype=f32) / c1)
    w = (1.0 - d).clamp_min(0.0)
    n_win = -(-n_in // _SUM_WINDOW)
    padded = torch.zeros((n_win * _SUM_WINDOW, n_out), dtype=f32)
    padded[:n_in] = w
    windows = padded.reshape(n_win, _SUM_WINDOW, n_out)
    part = windows[:, 0]
    for i in range(1, _SUM_WINDOW):  # in order, not torch.sum's tree
        part = part + windows[:, i]
    total = torch.zeros(n_out, dtype=f32)
    for k in range(n_win):
        total = total + part[k]
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _taps(n_in: int, n_out: int, device):
    """Each output's nonzero weights and their input indices in increasing
    order, padded with zero weights to the widest output; cached on the
    device (the first call, outside any capture, makes them)."""
    key = (n_in, n_out, str(device))
    t = _TAPS.get(key)
    if t is None:
        w = resize_weights(n_in, n_out).T  # (n_out, n_in)
        nz = w != 0
        T = max(int(nz.sum(1).max()), 1)
        # the nonzero columns first, in index order: a stable sort of ~nz
        order = torch.sort((~nz).to(torch.int8), dim=1, stable=True).indices
        idx = order[:, :T]
        wt = torch.gather(w, 1, idx)
        t = _TAPS[key] = (idx.to(device), wt.double().to(device))
    return t


def _contract(x, dim: int, n_out: int):
    """One axis of the resize: out[j] = sum_t w[j, t] x[idx[j, t]] as a
    chain of fused multiply-adds over the taps in input order, starting
    from 0 (the dot product's order on XLA:CPU; zero-weight padding taps
    leave the sum as it is)."""
    idx, wt = _taps(x.shape[dim], n_out, x.device)
    xt = x.movedim(dim, -1)
    # float32 times float64: the products, exact, in float64
    prod = torch.mul(xt[..., idx], wt)  # (..., n_out, T)
    acc = prod[..., 0].float()
    for t in range(1, idx.shape[1]):
        # one kernel a tap: the sum in float64, rounded once to float32
        torch.add(prod[..., t], acc, out=acc)
    return acc.movedim(-1, dim)


def resize_h_first(H: int, W: int, oh: int, ow: int) -> bool:
    """Whether ``resize_bilinear`` from (H, W) to (oh, ow) applies the H
    axis first: the order JAX's einsum takes (opt_einsum's flop counts of
    the two orders, the cheaper first, H on a tie), H first when only one
    axis changes."""
    if oh == H or ow == W:
        return True
    return W * oh * (H + ow) <= H * ow * (W + oh)


def resize_bilinear(x, out_hw):
    """Half-pixel-center bilinear resize of (B,H,W,C) float32 as
    ``jax.image.resize(..., "bilinear")`` computes it on the CPU: the
    antialiased triangle weights of ``resize_weights``, applied one axis at
    a time in the order JAX's einsum takes (the cheaper first, H on a tie),
    each output a chain of fused multiply-adds over its taps. Equal to JAX
    bit for bit where XLA's own code keeps that order (PERF.md records
    where it does not)."""
    B, H, W, C = x.shape
    oh, ow = (int(v) for v in out_hw)
    do_h, do_w = oh != H, ow != W
    h_first = resize_h_first(H, W, oh, ow)
    if do_h and h_first:
        x = _contract(x, 1, oh)
    if do_w:
        x = _contract(x, 2, ow)
    if do_h and not h_first:
        x = _contract(x, 1, oh)
    return x


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


def sample_bilinear_px(img, coords_xy):
    """Sparse bilinear sampling at exact pixel coordinates: the value at
    integer (x, y) is img[y, x], zero out of bounds. ``sample_bilinear``
    follows the reference's grid_sample chain, which moves positions by up
    to half a pixel near the borders; geometric lookups (the training
    loss's dense correspondence at a predicted peak) take this one."""
    px, py = coords_xy[..., 0], coords_xy[..., 1]
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

"""Keypoint detection post-processing: softmax heatmap, NMS, per-cell
candidates, top-K and descriptor sampling, with fixed shapes.

Counterpart of ``xfeatslam_tpu/ops/detect.py``. Everything is computed on
the stride-8 cell tensor (B,H8,W8,64) whose channel c = py*8+px is the
full-resolution pixel (cy*8+py, cx*8+px), so no full-resolution map is
ever built.

``select_keypoints`` always takes the candidate route of the JAX package's
TPU path: ``cuda_kernels.detect_candidates`` (the CUDA kernel on a GPU
tensor, the cell-space functions below on a CPU tensor) emits per-cell
candidates, one ``torch.topk`` over all of them picks the K best, and
``cuda_kernels.keypoint_desc`` decodes the keypoints and samples their
descriptors in one launch (``decode_candidates``, ``desc_taps`` and
``cuda_kernels.bilinear_desc_sample`` on a CPU tensor). Unlike the
JAX package it always runs the full 9-slot candidate kernel: the 5-slot
fast path, its ``lax.cond`` fallback and the shallow/deep top-k merge exist
to dodge TPU sort costs, and in eager PyTorch the condition would cost a
device-to-host sync per batch. The selected set is the same.
"""

from __future__ import annotations

import torch

from . import cuda_kernels as ck
from . import image as image_ops


def keypoint_heatmap(logits, softmax_temp: float = 1.0):
    """(B,H8,W8,65) keypoint logits -> (B,H,W,1) full-res heatmap: softmax
    over 65 channels, dustbin dropped, 8x8 cells shuffled back to pixels
    (channel k = i*8+j with i the row offset)."""
    B, H8, W8, _ = logits.shape
    scores = torch.softmax(logits * softmax_temp, dim=-1)[..., :64]
    x = scores.reshape(B, H8, W8, 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(B, H8 * 8, W8 * 8, 1)


def _shift_cells(x, dim: int, delta: int, fill):
    """out[..., i, ...] = x[..., i+delta, ...] along ``dim``, ``fill`` past
    the boundary."""
    n = x.shape[dim]
    pad_shape = list(x.shape)
    pad_shape[dim] = abs(delta)
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    if delta > 0:
        return torch.cat([x.narrow(dim, delta, n - delta), pad], dim=dim)
    return torch.cat([pad, x.narrow(dim, 0, n + delta)], dim=dim)


def _roll_ch(x, shift: int):
    """Circular roll along the 64-wide cell-channel axis (last)."""
    return torch.roll(x, shift, dims=-1)


def _cell_py_px(device):
    c = torch.arange(64, device=device)
    return c // 8, c % 8


def nms_mask_cells(p, threshold: float = 0.05):
    """5x5 full-resolution NMS computed in cell space on the softmaxed
    (B,H8,W8,64) tensor. A full-res row shift by dy is a channel roll by
    -8*dy, stitched with the vertically adjacent cell (same roll) for the
    rows that cross the cell border; columns work the same way along px.
    The separable max is exact, so this equals a 5x5 max-pool on the
    pixel-shuffled map. Returns the boolean survivor mask (B,H8,W8,64)."""
    neg = float("-inf")
    py, px = _cell_py_px(p.device)
    p_down = _shift_cells(p, 1, 1, neg)
    p_up = _shift_cells(p, 1, -1, neg)
    my = p
    for dy in (1, 2):
        my = torch.maximum(my, torch.where(
            py < 8 - dy, _roll_ch(p, -8 * dy), _roll_ch(p_down, -8 * dy)))
        my = torch.maximum(my, torch.where(
            py >= dy, _roll_ch(p, 8 * dy), _roll_ch(p_up, 8 * dy)))
    my_right = _shift_cells(my, 2, 1, neg)
    my_left = _shift_cells(my, 2, -1, neg)
    mx = my
    for dx in (1, 2):
        mx = torch.maximum(mx, torch.where(
            px < 8 - dx, _roll_ch(my, -dx), _roll_ch(my_right, 8 - dx)))
        mx = torch.maximum(mx, torch.where(
            px >= dx, _roll_ch(my, dx), _roll_ch(my_left, dx - 8)))
    return (p == mx) & (p > threshold)


def _rel_cells(heatmap, H8: int, W8: int):
    """Bilinear reliability upsample evaluated in cell space, equal to
    ``image.dense_grid_sample_bilinear(heatmap, (H, W))`` bit for bit:
    same position formula, x pass then y pass, zero weight out of bounds.
    For every pixel the two x taps are H1[cx-1 or cx] and the next column,
    so two selects over +-1-shifted maps give the x pass; the y pass
    shifts that result along cell rows the same way."""
    H, W = H8 * 8, W8 * 8
    dev = heatmap.device
    h1 = heatmap[..., 0]
    py_c, px_c = _cell_py_px(dev)

    cx = torch.arange(W8, device=dev)[:, None]
    pos_x = (cx * 8 + px_c[None]).float() * (W8 / (W - 1.0)) - 0.5
    x0 = torch.floor(pos_x)
    wx = pos_x - x0
    x0i = x0.long()
    wx0 = (1.0 - wx) * ((x0i >= 0) & (x0i < W8))
    wx1 = wx * ((x0i + 1 >= 0) & (x0i + 1 < W8))
    mx = x0i == cx - 1  # else x0 == cx: pos - cx lies in (-0.5, 0.52)

    s_xm1 = _shift_cells(h1, 2, -1, 0.0)[..., None]
    s_x0 = h1[..., None]
    s_xp1 = _shift_cells(h1, 2, 1, 0.0)[..., None]
    gx = (torch.where(mx, s_xm1, s_x0) * wx0
          + torch.where(mx, s_x0, s_xp1) * wx1)  # (B,H8,W8,64)

    cy = torch.arange(H8, device=dev)[:, None]
    pos_y = (cy * 8 + py_c[None]).float() * (H8 / (H - 1.0)) - 0.5
    y0 = torch.floor(pos_y)
    wy = pos_y - y0
    y0i = y0.long()
    wy0 = ((1.0 - wy) * ((y0i >= 0) & (y0i < H8)))[:, None, :]
    wy1 = (wy * ((y0i + 1 >= 0) & (y0i + 1 < H8)))[:, None, :]
    my = (y0i == cy - 1)[:, None, :]  # (H8,1,64)

    g_ym1 = _shift_cells(gx, 1, -1, 0.0)
    g_yp1 = _shift_cells(gx, 1, 1, 0.0)
    return (torch.where(my, g_ym1, gx) * wy0
            + torch.where(my, gx, g_yp1) * wy1)


def ranked_score_cells(logits, heatmap, threshold: float = 0.05,
                       softmax_temp: float = 1.0):
    """NMS-masked ranking score in cell layout (B,H8,W8,64): the keypoint
    probability (last full-res row and column zeroed, where the
    reference's nearest sampler goes out of bounds) times the bilinear
    reliability; non-survivors are -1. Also returns the probabilities."""
    _, H8, W8, _ = logits.shape
    p = torch.softmax(logits * softmax_temp, dim=-1)[..., :64]
    mask = nms_mask_cells(p, threshold)
    rel = _rel_cells(heatmap, H8, W8)
    py, px = _cell_py_px(p.device)
    last_row = ((torch.arange(H8, device=p.device) == H8 - 1)[:, None, None]
                & (py == 7))
    last_col = ((torch.arange(W8, device=p.device) == W8 - 1)[:, None]
                & (px == 7))
    score = torch.where(last_row | last_col, 0.0, p) * rel
    return torch.where(mask, score, -1.0), p


def _cells_topk(ranked_cells, k: int, per_cell: int = 9):
    """Exact top-k over the cell-layout ranked map in two stages: a
    per-cell top-``per_cell`` (an 8x8 cell holds at most 9 distinct-score
    5x5-NMS survivors) and the real top-k over those. Returns (scores
    (B,k), flat full-res indices (B,k))."""
    B, H8, W8, _ = ranked_cells.shape
    W = W8 * 8
    vals, loc = torch.topk(ranked_cells.reshape(B, H8 * W8, 64), per_cell,
                           dim=-1)
    cell = torch.arange(H8 * W8, device=vals.device)[None, :, None]
    gidx = ((cell // W8) * 8 + loc // 8) * W + (cell % W8) * 8 + loc % 8
    scores, sel = torch.topk(vals.reshape(B, -1), k, dim=1)
    return scores, torch.gather(gidx.reshape(B, -1), 1, sel)


def packed_aux_cells(p):
    """The 3x3 soft-argmax sub-pixel offset of every pixel, quantized and
    packed with its cell channel into one float32-exact integer
    ``ch<<18 | qx<<9 | qy``, q = round((off+1)*255) in [0,510] (0.004 px
    steps). Neighbour coordinates clamp at the image border. The sums are
    grouped as in the JAX package's Pallas kernel: ty = up+p+down and
    uy = down-up per column, then s = left+ty+right, sx = right-left
    over ty and sy = left+uy+right over uy. (B,H8,W8,64) -> same."""
    B, H8, W8, _ = p.shape
    full = p.reshape(B, H8, W8, 8, 8).permute(0, 1, 3, 2, 4).reshape(
        B, H8 * 8, W8 * 8)

    def nbr(x, dim, d):  # x[clamp(i+d)] along dim
        n = x.shape[dim]
        idx = (torch.arange(n, device=x.device) + d).clamp(0, n - 1)
        return x.index_select(dim, idx)

    ty = nbr(full, 1, -1) + full + nbr(full, 1, 1)
    uy = nbr(full, 1, 1) - nbr(full, 1, -1)
    s_sum = nbr(ty, 2, -1) + ty + nbr(ty, 2, 1)
    sx = nbr(ty, 2, 1) - nbr(ty, 2, -1)
    sy = nbr(uy, 2, -1) + uy + nbr(uy, 2, 1)
    inv = 1.0 / torch.clamp(s_sum, min=1e-9)
    offx = torch.clamp(sx * inv, -1.0, 1.0)
    offy = torch.clamp(sy * inv, -1.0, 1.0)
    ch = (torch.arange(H8 * 8, device=p.device)[:, None] % 8 * 8
          + torch.arange(W8 * 8, device=p.device)[None, :] % 8).float()
    aux = (ch * 262144.0 + torch.round((offx + 1.0) * 255.0) * 512.0
           + torch.round((offy + 1.0) * 255.0))
    return aux.reshape(B, H8, 8, W8, 8).permute(0, 1, 3, 2, 4).reshape(
        B, H8, W8, 64)


def cell_candidates(ranked, aux, nc: int):
    """Per-cell top-``nc`` (score, aux) over the 64 channels, ties to the
    smaller packed aux (= smaller channel). (B,H8,W8,64) x2 ->
    (B,H8,nc,W8) x2, the layout of the JAX ``detect_candidates``."""
    by_aux = torch.argsort(aux, dim=-1)
    v = torch.gather(ranked, -1, by_aux)
    order = torch.gather(by_aux, -1,
                         torch.argsort(v, dim=-1, descending=True, stable=True))
    order = order[..., :nc]
    vals = torch.gather(ranked, -1, order).permute(0, 1, 3, 2)
    auxs = torch.gather(aux, -1, order).permute(0, 1, 3, 2)
    return vals.contiguous(), auxs.contiguous()


def decode_candidates(sel, aux, W8: int):
    """The pixels and sub-pixel offsets of candidates picked from the
    flattened (B,H8,nc,W8) candidate maps (the decode of the JAX package's
    ``_candidates_topk``). Candidate (b,cy,r,cx) is pixel
    (cy*8+ch//8, cx*8+ch%8) with ch = aux>>18; the offsets are q/255 - 1
    from the packed aux. Returns kpts (B,k,2) float (x,y) and offsets
    (B,k,2)."""
    B, _, NC, _ = aux.shape
    W = W8 * 8
    gi = torch.gather(aux.reshape(B, -1), 1, sel).to(torch.int32)
    chs = gi >> 18
    q = torch.stack([(gi >> 9) & 511, gi & 511], -1).float()
    # divided by a tensor: on CUDA a division by a Python number multiplies
    # by its rounded reciprocal, which is off by an ulp for 316 of the 511 q
    off = q / torch.full_like(q, 255.0) - 1.0
    idx = (sel // (NC * W8) * 8 + chs // 8) * W + sel % W8 * 8 + chs % 8
    return torch.stack([(idx % W).float(), (idx // W).float()], -1), off


def desc_taps(kpts, valid, H8: int, W8: int):
    """Grid-row indices and weights of the 4 bilinear taps of every
    keypoint, with ``image.sample_bilinear``'s semantics: out-of-bounds
    taps and invalid keypoints carry weight 0 (their index is clamped in
    bounds). Returns idx4 (B,K,4) int32 and w4 (B,K,4) float32."""
    H, W = H8 * 8, W8 * 8
    px, py = image_ops._grid_sample_coords(kpts, (H8, W8), (H, W))
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = px - x0
    wy = py - y0
    x0i = x0.long()
    y0i = y0.long()

    def tap(yi, xi, w):
        inb = (yi >= 0) & (yi < H8) & (xi >= 0) & (xi < W8)
        return yi.clamp(0, H8 - 1) * W8 + xi.clamp(0, W8 - 1), w * inb

    taps = [tap(y0i, x0i, (1 - wx) * (1 - wy)),
            tap(y0i, x0i + 1, wx * (1 - wy)),
            tap(y0i + 1, x0i, (1 - wx) * wy),
            tap(y0i + 1, x0i + 1, wx * wy)]
    idx4 = torch.stack([t[0] for t in taps], -1).to(torch.int32)
    w4 = torch.stack([t[1] for t in taps], -1) * valid[..., None]
    return idx4.contiguous(), w4.contiguous()


def sample_descriptors(feats, kpts, valid):
    """Descriptors at given keypoints (the JAX package's
    ``_desc_sample_pallas``): the four bilinear taps of ``desc_taps``, then
    ``cuda_kernels.bilinear_desc_sample``. feats (B,H8,W8,64) raw dense
    descriptors, kpts (B,K,2) (x,y) pixels, valid (B,K) -> (B,K,64)
    L2-normalized, zero where invalid."""
    B, H8, W8, C = feats.shape
    idx4, w4 = desc_taps(kpts, valid, H8, W8)
    return ck.bilinear_desc_sample(feats.reshape(B, H8 * W8, C).contiguous(),
                                   idx4, w4)


def select_keypoints(feats, logits, heatmap, num_keypoints: int,
                     threshold: float = 0.05, softmax_temp: float = 1.0,
                     subpixel: bool = False):
    """Fixed-shape keypoint selection + descriptor sampling.

    Args:
      feats: (B,H8,W8,64) dense descriptors (unnormalized network output).
      logits: (B,H8,W8,65) keypoint logits.
      heatmap: (B,H8,W8,1) reliability map.
      num_keypoints: K.
      subpixel: add the quantized 3x3 soft-argmax offsets to the coords.
    Returns dict of kpts (B,K,2) (x,y) pixels, scores (B,K) (<= 0 where
    invalid), desc (B,K,64) L2-normalized (zero where invalid), valid (B,K).
    """
    B, H8, W8, C = feats.shape
    vals, aux = ck.detect_candidates(logits.contiguous(),
                                     heatmap.contiguous(), threshold,
                                     softmax_temp)
    scores, sel = torch.topk(vals.reshape(B, -1), num_keypoints, dim=1)
    kpts, desc = ck.keypoint_desc(feats.reshape(B, H8 * W8, C).contiguous(),
                                  scores, sel, aux, W8, subpixel)
    return {"kpts": kpts, "scores": scores, "desc": desc,
            "valid": scores > 0.0}

"""Plain PyTorch reference of the XFeat extract-and-match pass.

XFeat (Potje et al., CVPR 2024, arXiv:2404.19174) as its published code
and the xfeatSLAM extractor (XFextractor.cc) run it: instance norm, the
conv stacks with ReLU, the fusion of three scales by bilinear upsampling,
the dense descriptor, reliability and keypoint heads; then the softmax
heatmap shuffled to full resolution, a 5x5 NMS above the threshold, the
score nearest(heatmap) x bilinear(reliability), the top K, descriptors
sampled bilinearly from the L2-normalized dense map and normalized again,
and the brute-force mutual nearest neighbour of consecutive frames with
the distance (2 - 2 a.b) x 512, a distance limit and a ratio test.

Written from that description with plain tensor operations, float32 and
TF32 off. It reads only the weights file (already BatchNorm-folded:
HWIO convs and their biases) and the frames it is handed; it imports
nothing of the measured package. ``tf32=True`` rounds every conv and
matmul operand to TF32 (10 mantissa bits, to nearest) and accumulates in
float32, as the card's TF32 path does: that is the control, the step
below the configuration's precision.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5

# XFeat's layers: (cin, cout, kernel, stride), each conv then ReLU
STACKS = {
    "block1": [(1, 4, 3, 1), (4, 8, 3, 2), (8, 8, 3, 1), (8, 24, 3, 2)],
    "block2": [(24, 24, 3, 1), (24, 24, 3, 1)],
    "block3": [(24, 64, 3, 2), (64, 64, 3, 1), (64, 64, 1, 1)],
    "block4": [(64, 64, 3, 2), (64, 64, 3, 1), (64, 64, 3, 1)],
    "block5": [(64, 128, 3, 2), (128, 128, 3, 1), (128, 128, 3, 1),
               (128, 64, 1, 1)],
    "block_fusion": [(64, 64, 3, 1), (64, 64, 3, 1)],
    "heatmap_head": [(64, 64, 1, 1), (64, 64, 1, 1)],
    "keypoint_head": [(64, 64, 1, 1), (64, 64, 1, 1), (64, 64, 1, 1)],
}
# the plain convs (with bias, no ReLU) that end the skip and the heads
FINALS = {"skip1_conv": (1, 24, 1), "block_fusion_final": (64, 64, 1),
          "heatmap_final": (64, 1, 1), "keypoint_final": (64, 65, 1)}


@contextlib.contextmanager
def float32_only():
    """TF32 off for cuDNN and cuBLAS inside the block."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def round_tf32(x):
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & -8192
    return b.view(torch.float32)


class Network:
    """XFeat's weights from an npz file (keys ``<layer>[.<i>].w`` HWIO and
    ``.b``) as OIHW float32 tensors on ``device``."""

    def __init__(self, path: str, device):
        self.w = {}
        with np.load(path) as z:
            def conv(key):
                w = torch.from_numpy(np.ascontiguousarray(
                    np.transpose(z[key + ".w"], (3, 2, 0, 1))))
                b = torch.from_numpy(z[key + ".b"].copy())
                return w.to(device, torch.float32), b.to(device, torch.float32)

            for name, layers in STACKS.items():
                for i in range(len(layers)):
                    self.w[f"{name}.{i}"] = conv(f"{name}.{i}")
            for name in FINALS:
                self.w[name] = conv(name)
        for name, layers in STACKS.items():
            for i, (cin, cout, k, _) in enumerate(layers):
                if tuple(self.w[f"{name}.{i}"][0].shape) != (cout, cin, k, k):
                    raise ValueError(f"{path}: {name}.{i} has the wrong shape")

    def _conv(self, x, key, stride=1, tf32=False):
        w, b = self.w[key]
        if tf32:
            x, w = round_tf32(x), round_tf32(w)
        return F.conv2d(x, w, b, stride, w.shape[-1] // 2)

    def _stack(self, x, name, tf32):
        for i, (_, _, _, s) in enumerate(STACKS[name]):
            x = torch.relu(self._conv(x, f"{name}.{i}", s, tf32))
        return x

    @torch.no_grad()
    def forward(self, x, tf32=False):
        """x (B, H, W, C) in [0, 1], H and W multiples of 32 -> dense
        descriptors (B, 64, H/8, W/8), keypoint logits (B, 65, H/8, W/8),
        reliability (B, 1, H/8, W/8), NCHW float32."""
        with float32_only():
            x = x.float().mean(-1)[:, None]
            mean = x.mean(dim=(2, 3), keepdim=True)
            var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
            x = (x - mean) / torch.sqrt(var + BN_EPS)
            x1 = self._stack(x, "block1", tf32)
            skip = self._conv(F.avg_pool2d(x, 4, 4), "skip1_conv", 1, tf32)
            x2 = self._stack(x1 + skip, "block2", tf32)
            x3 = self._stack(x2, "block3", tf32)
            x4 = self._stack(x3, "block4", tf32)
            x5 = self._stack(x4, "block5", tf32)
            hw8 = x3.shape[-2:]
            up = (F.interpolate(x4, hw8, mode="bilinear", align_corners=False)
                  + F.interpolate(x5, hw8, mode="bilinear",
                                  align_corners=False))
            fused = self._stack(x3 + up, "block_fusion", tf32)
            feats = self._conv(fused, "block_fusion_final", 1, tf32)
            heat = torch.sigmoid(self._conv(
                self._stack(feats, "heatmap_head", tf32), "heatmap_final", 1,
                tf32))
            k = self._stack(F.pixel_unshuffle(x, 8), "keypoint_head", tf32)
            logits = self._conv(k, "keypoint_final", 1, tf32)
        return feats, logits, heat


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of a half-pixel bilinear resize with the
    triangle kernel widened by the shrink factor (antialiased, as
    ``jax.image.resize(..., "bilinear")``), each row normalized, rows whose
    sample falls outside [-0.5, n_in - 0.5] zero."""
    scale = n_out / n_in
    width = max(1.0 / scale, 1.0)
    sample = (np.arange(n_out) + 0.5) / scale - 0.5
    d = np.abs(sample[:, None] - np.arange(n_in)[None, :]) / width
    w = np.maximum(0.0, 1.0 - d)
    total = w.sum(1, keepdims=True)
    w = np.where(total > 0, w / np.where(total > 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return (w * inside[:, None]).astype(np.float32)


def resize(x, out_hw, tf32=False):
    """(B, H, W, C) float32 resized to ``out_hw`` by ``resize_matrix`` on
    each axis (two matrix products)."""
    _, H, W, _ = x.shape
    oh, ow = out_hw
    if (oh, ow) == (H, W):
        return x
    mh = torch.from_numpy(resize_matrix(H, oh)).to(x.device)
    mw = torch.from_numpy(resize_matrix(W, ow)).to(x.device)
    if tf32:
        x, mh, mw = round_tf32(x), round_tf32(mh), round_tf32(mw)
    with float32_only():
        y = torch.einsum("oh,bhwc->bowc", mh, x)
        if tf32:
            y = round_tf32(y)
        return torch.einsum("pw,bowc->bopc", mw, y)


def net_size(hw):
    """The network's input size for frames of ``hw``: each side floored to
    a multiple of 32."""
    return (hw[0] // 32) * 32, (hw[1] // 32) * 32


class Maps:
    """The dense full-resolution maps of a block of frames: the keypoint
    probability ``p`` (B, H, W), the largest of its 24 neighbours in the
    5x5 window ``nmax`` (-inf outside the frame), the NMS survivors
    ``keep`` (p at its window's max and above the threshold), the score
    ``score`` = nearest(p) x bilinear(reliability) (0 on the last row and
    column, which the nearest sampler's normalized grid puts outside the
    frame), the 3x3 soft-argmax offsets ``offx``, ``offy`` (neighbours
    clamped at the border) and the L2-normalized dense descriptors
    ``dense`` (B, 64, H/8, W/8)."""

    def __init__(self, feats, logits, heat, threshold: float):
        B, _, H8, W8 = logits.shape
        H, W = H8 * 8, W8 * 8
        self.hw = (H, W)
        self.threshold = threshold
        p = F.pixel_shuffle(torch.softmax(logits, dim=1)[:, :64], 8)[:, 0]
        self.p = p
        pad = F.pad(p, (2, 2, 2, 2), value=float("-inf"))
        nmax = torch.full_like(p, float("-inf"))
        for dy in range(5):
            for dx in range(5):
                if (dy, dx) != (2, 2):
                    nmax = torch.maximum(nmax, pad[:, dy:dy + H, dx:dx + W])
        self.nmax = nmax
        self.keep = (p >= nmax) & (p > threshold)
        # nearest sample of p at a pixel: grid (x / (W - 1)) * 2 - 1, so
        # position x * W / (W - 1) - 0.5, which rounds to x except on the
        # last column (and likewise the last row)
        near = p.clone()
        near[:, H - 1, :] = 0.0
        near[:, :, W - 1] = 0.0
        ys = torch.arange(H, dtype=torch.float32, device=p.device)
        xs = torch.arange(W, dtype=torch.float32, device=p.device)
        gy, gx = torch.meshgrid(ys / (H - 1) * 2 - 1, xs / (W - 1) * 2 - 1,
                                indexing="ij")
        grid = torch.stack([gx, gy], -1)[None].expand(B, H, W, 2)
        rel = F.grid_sample(heat, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=False)[:, 0]
        self.score = near * rel
        rp = F.pad(p[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
        s = sx = sy = 0.0
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                v = rp[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                s = s + v
                sx = sx + dx * v
                sy = sy + dy * v
        inv = 1.0 / torch.clamp(s, min=1e-9)
        self.offx = torch.clamp(sx * inv, -1.0, 1.0)
        self.offy = torch.clamp(sy * inv, -1.0, 1.0)
        self.dense = F.normalize(feats, dim=1)

    def descriptors(self, kpts, valid):
        """Descriptors at (B, K, 2) keypoints in network-input pixels:
        bilinear on the normalized dense map (grid x / (W - 1), zeros
        outside), normalized again, zero where not valid."""
        H, W = self.hw
        g = torch.stack([kpts[..., 0] / (W - 1) * 2 - 1,
                         kpts[..., 1] / (H - 1) * 2 - 1], -1)[:, None]
        d = F.grid_sample(self.dense, g, mode="bilinear",
                          padding_mode="zeros", align_corners=False)
        d = F.normalize(d[:, :, 0].transpose(1, 2), dim=-1)
        return d * valid[..., None]


def maps(net: Network, frames_u8, threshold: float, tf32=False):
    """``Maps`` of uint8 (B, H, W, 1) frames: scaled to [0, 1], resized to
    the network's size, run through the network."""
    x = frames_u8.float() / 255.0
    x = resize(x, net_size(x.shape[1:3]), tf32)
    return Maps(*net.forward(x, tf32), threshold)


def distances(da, db, tf32=False):
    """(P, N, 64) x (P, M, 64) -> (P, N, M) distances (2 - 2 a.b) x 512."""
    if tf32:
        da, db = round_tf32(da), round_tf32(db)
    with float32_only():
        return (2.0 - 2.0 * torch.bmm(da, db.transpose(1, 2))) * 512.0


def mutual_nn(desc, valid, max_dist: float, ratio: float, tf32=False):
    """Matches of frames (i, i+1): (B-1, K) column index (-1 unmatched),
    distance and mask. Row i of frame a matches column j of frame b where j
    is its nearest valid column, i is j's nearest valid row, the distance is
    within ``max_dist`` and within ``ratio`` of the row's second best."""
    inf = float("inf")
    d = distances(desc[:-1], desc[1:], tf32)
    va, vb = valid[:-1], valid[1:]
    d = d.masked_fill(~vb[:, None, :], inf)
    best, j = d.min(dim=2)
    second = d.scatter(2, j[..., None], inf).amin(dim=2)
    col = d.masked_fill(~va[:, :, None], inf).argmin(dim=1)
    mutual = torch.gather(col, 1, j) == torch.arange(
        d.shape[1], device=d.device)
    ok = va & mutual & (best <= max_dist) & (best <= ratio * second)
    return torch.where(ok, j, -1).to(torch.int32), best, ok


def extract(net: Network, frames_u8, cfg, tf32=False, block: int = 32):
    """The whole pass on uint8 (B, H, W, 1) frames, in the program's output
    format: kpts (B, K, 2) in frame pixels, scores, desc (B, K, 64), valid,
    and the consecutive matches' idx, dist and mask (B-1, K)."""
    K = cfg["extractor"]["num_keypoints"]
    thr = cfg["extractor"]["threshold"]
    sub = cfg["extractor"]["subpixel"]
    B, H, W, _ = frames_u8.shape
    H32, W32 = net_size((H, W))
    sx, sy = W / W32, H / H32
    out = {k: [] for k in ("kpts", "scores", "desc", "valid")}
    for s in range(0, B, block):
        m = maps(net, frames_u8[s:s + block], thr, tf32)
        n = m.p.shape[0]
        score = torch.where(m.keep, m.score, torch.zeros_like(m.score))
        top, flat = torch.topk(score.reshape(n, -1), K, dim=1)
        valid = top > 0
        y, x = flat // W32, flat % W32
        if sub:
            ox = torch.gather(m.offx.reshape(n, -1), 1, flat)
            oy = torch.gather(m.offy.reshape(n, -1), 1, flat)
        else:
            ox = oy = torch.zeros_like(top)
        k_net = torch.stack([x + ox, y + oy], -1)
        out["desc"].append(m.descriptors(k_net, valid))
        out["kpts"].append(torch.stack([k_net[..., 0] * sx,
                                        k_net[..., 1] * sy], -1))
        out["scores"].append(top)
        out["valid"].append(valid)
        del m
    out = {k: torch.cat(v) for k, v in out.items()}
    mc = cfg["matcher"]
    idx, dist, mask = mutual_nn(out["desc"], out["valid"], mc["max_dist"],
                                mc["ratio"], tf32)
    out.update(match_idx=idx, match_dist=dist, match_mask=mask)
    return out

"""The ORB feature backend: FAST corners and oriented BRIEF.

Counterpart of ``xfeatslam_tpu/models/orb.py`` (the role of ORB-SLAM3's
ORBextractor.cc): an 8-level 1.2x pyramid, FAST-9 at an initial and a
minimum threshold (the minimum where a level fires too few corners), 3x3
non-maximum suppression, quadtree balancing, intensity-centroid
orientation and 256-bit rotated BRIEF on a 7x7-blurred image. Descriptors
are (256,) float 0/1 vectors, so the matchers' squared L2 is the Hamming
distance.

Two device stages per frame, as in the JAX package, with one host read
between them: ``orb_candidates`` (every level resized, then one launch of
the ``orb_fast`` kernel for FAST at both thresholds, suppression and the
border on all levels, then the threshold select, the top-k and sub-pixel
offsets) and, after the quadtree has picked each level's keypoints on the
host, ``orb_describe_all`` (each level resized and blurred, then one
launch of the ``orb_describe`` kernel for the moments at the keypoints,
the angles and the descriptors). The kernels are ``csrc/orb_fast.cu`` and
``csrc/orb_describe.cu`` behind ``ops/cuda_kernels``; CPU tensors take
their plain twins (``orb_fast_plain``, ``orb_describe_plain`` there),
built from the functions below. On the card each stage
is one CUDA graph (``track_step.CapturedCalls``), keyed on the image
size, the level sizes, caps, pads and both thresholds.

FAST's plain version vectorizes over the level: the 16 circle pixels are
one stacked (16, H, W) tensor of slices of a circularly padded image (the
JAX package's ``jnp.roll`` wraps around), the score is summed in circle
order (as the kernel does, so both give the same bits), and the run-of-9
test packs the 16 comparisons into an int, doubles it to 32 bits and ANDs
nine shifts. The top-k keeps ``lax.top_k``'s order (lower index first
among equal scores) through a unique int64 key, since the candidate order
decides the quadtree's ties. The quadtree is ``csrc/quadtree.cpp``, built
by g++ at first use; a failed build raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build, resolve_device
from ..ops import cuda_kernels as ck
from ..ops import image as image_ops

N_LEVELS = 8
SCALE_FACTOR = 1.2
PATCH_RADIUS = 15  # orientation patch (HALF_PATCH_SIZE)
EDGE = 19  # EDGE_THRESHOLD margin like the reference
TH_HIGH = 100.0
TH_LOW = 50.0

# FAST circle of 16 offsets (radius 3), standard Bresenham circle
_CIRCLE = np.array(
    [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
     (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3)],
    np.int32,
)  # (dx, dy)


def make_brief_pattern(seed: int = 7, n_bits: int = 256, sigma: float = 6.5,
                       rmax: float = 13.0) -> np.ndarray:
    """(n_bits, 4) int8 sampling pairs (x1,y1,x2,y2), Gaussian G-II style."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, sigma, (n_bits, 4))
    pts = np.clip(pts, -rmax, rmax)
    return np.round(pts).astype(np.int8)


def _load_pattern() -> np.ndarray:
    """Sampling-pattern resolution, as the JAX package's:
    $XFEATSLAM_BRIEF_PATTERN (a .npy path, or the literal "gaussian" for
    the generated pattern), else a ``brief_pattern.npy`` beside this
    module, else the generated Gaussian pattern."""
    env = os.environ.get("XFEATSLAM_BRIEF_PATTERN")
    if env == "gaussian":
        return make_brief_pattern()
    if env and os.path.exists(env):
        return np.load(env).astype(np.int8)
    default = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "brief_pattern.npy")
    if os.path.exists(default):
        return np.load(default).astype(np.int8)
    return make_brief_pattern()


_PATTERN = _load_pattern()

# constant tensors per (name, device), made outside any graph capture (the
# captured stages' warm-up calls make them first)
_CONSTANTS: dict = {}


def _constant(name, device, make):
    key = (name, str(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.from_numpy(make()).to(device)
    return t


@contextlib.contextmanager
def _float32_convs():
    """cuDNN float32 convolutions without TF32 (~3 digits), which would
    move orientations and blurred values off the JAX package's."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _has_run9(m):
    """(..., 16, H, W) bool -> (..., H, W): nine consecutive circle pixels
    set, wrapping around. The 16 flags become the low bits of an int,
    doubled to 32 bits; bit s of the AND of the int shifted by 0..8 is the
    run starting at circle pixel s."""
    w = torch.bitwise_left_shift(
        torch.ones(16, dtype=torch.int32, device=m.device),
        torch.arange(16, dtype=torch.int32, device=m.device))
    bits = (m.to(torch.int32) * w[:, None, None]).sum(-3, dtype=torch.int32)
    m32 = bits | torch.bitwise_left_shift(bits, 16)
    run = m32
    for s in range(1, 9):
        run = run & torch.bitwise_right_shift(m32, s)
    return (run & 0xFFFF) != 0


def fast_score_maps(img, thresholds):
    """Dense FAST-9 corner responses of one pyramid level at several
    thresholds in one pass over the circle.

    img: (H,W) float32 in [0,255]. Returns (T,H,W) score maps (0 = not a
    corner): the sum of |p - circle_i| over the pixels brighter or darker
    than p by more than the threshold, summed in circle order. Circle
    pixels wrap around the image (``jnp.roll`` in the JAX package)."""
    H, W = img.shape
    pad = F.pad(img[None, None], (3, 3, 3, 3), mode="circular")[0, 0]
    q = torch.stack([pad[3 + int(dy):3 + int(dy) + H,
                         3 + int(dx):3 + int(dx) + W]
                     for dx, dy in _CIRCLE])
    diff = (q - img).abs()
    brighter = torch.stack([q > img + float(t) for t in thresholds])
    darker = torch.stack([q < img - float(t) for t in thresholds])
    corner = _has_run9(brighter) | _has_run9(darker)
    terms = torch.where(brighter | darker, diff, 0.0)
    score = terms[:, 0]
    for i in range(1, 16):
        score = score + terms[:, i]
    return torch.where(corner, score, 0.0)


def fast_score_map(img, threshold: float):
    """``fast_score_maps`` at one threshold: the (H,W) score map."""
    return fast_score_maps(img, (threshold,))[0]


def nms3_mask(score):
    """The score's 3x3 local maxima (ties kept) above 0, for (H,W) or
    (T,H,W) scores."""
    s = score.reshape(-1, 1, *score.shape[-2:])
    m = F.max_pool2d(s, 3, stride=1, padding=1).reshape(score.shape)
    return (score == m) & (score > 0)


def _gauss_kernel7(sigma: float = 2.0):
    x = np.arange(7) - 3
    g = np.exp(-x * x / (2 * sigma * sigma))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _circle_mask(radius: int):
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.float32), x, y


def _moment_kernels():
    mask, xs, ys = _circle_mask(PATCH_RADIUS)
    return np.stack([mask * xs, mask * ys]).astype(np.float32)[:, None]


def orientation_maps(img):
    """m10/m01 moment maps of (H,W) ``img`` by two 31x31 correlations with
    zero padding (IC_Angle over every pixel)."""
    k = _constant("moments", img.device, _moment_kernels)
    with _float32_convs():
        m = F.conv2d(img[None, None], k, padding=PATCH_RADIUS)[0]
    return m[0], m[1]


def blur7(img):
    """7x7 Gaussian (sigma 2) of (H,W) ``img``, zero padding."""
    k = _constant("gauss7", img.device, lambda: _gauss_kernel7()[None, None])
    with _float32_convs():
        return F.conv2d(img[None, None], k, padding=3)[0, 0]


def describe(blurred, m10, m01, kpts, valid):
    """Oriented BRIEF at integer keypoint positions.

    blurred, m10, m01: (H,W); kpts: (n,2) float (x,y) level coords;
    valid: (n,) bool. Returns (desc (n,256) float 0/1, angles (n,)
    radians)."""
    H, W = blurred.shape
    xi = kpts[:, 0].to(torch.int32).clamp(0, W - 1)
    yi = kpts[:, 1].to(torch.int32).clamp(0, H - 1)
    at = (yi * W + xi).long()
    angle = torch.atan2(m01.reshape(-1)[at], m10.reshape(-1)[at])
    ca, sa = torch.cos(angle), torch.sin(angle)
    pat = _constant("pattern", blurred.device,
                    lambda: _PATTERN.astype(np.float32))
    flat = blurred.reshape(-1)

    def rot(px, py):
        rx = ca[:, None] * px[None, :] - sa[:, None] * py[None, :]
        ry = sa[:, None] * px[None, :] + ca[:, None] * py[None, :]
        gx = (xi[:, None] + torch.round(rx).to(torch.int32)).clamp(0, W - 1)
        gy = (yi[:, None] + torch.round(ry).to(torch.int32)).clamp(0, H - 1)
        return flat[(gy * W + gx).long()]

    v1 = rot(pat[:, 0], pat[:, 1])
    v2 = rot(pat[:, 2], pat[:, 3])
    bits = (v1 < v2).to(torch.float32)
    return bits * valid[:, None], angle


def _level_image(img0, lvl: int, h: int, w: int):
    if lvl == 0:
        return img0
    return image_ops.resize_bilinear(img0[None, :, :, None], (h, w))[0, :, :, 0]


def _top_k_first_index(flat, k: int):
    """``lax.top_k`` of a float vector: the k largest values, the lower
    index first among equal values. Each value's float32 bits (monotone
    over the non-negative scores; every masked entry holds the same -1)
    and its reversed index make one unique int64 key."""
    n = flat.shape[0]
    shift = max(1, (n - 1).bit_length())
    low = (1 << shift) - 1
    idx = torch.arange(n, dtype=torch.int64, device=flat.device)
    key = flat.view(torch.int32).to(torch.int64) * (1 << shift) + (low - idx)
    top_key = torch.topk(key, k).values
    sel = low - (top_key & low)
    return flat[sel], sel


def orb_candidates(img0, sizes, caps, mins, ini_thr: float, min_thr: float):
    """Every pyramid level's FAST candidates with no host read.

    Each level is resized (antialiased bilinear, as ``jax.image.resize``),
    FAST-scored at both thresholds, suppressed and border-masked; the
    minimum threshold's map replaces the initial one where fewer than
    ``mins[lvl]`` corners fire (a device select). The top ``caps[lvl]``
    candidates get a 1-D quadratic sub-pixel offset on the response, all
    levels' candidates in one pass.

    Args:
      img0: (H0,W0) float32 level-0 image.
      sizes: (h, w) per level; caps: candidate cap per level; mins: fire
        count below which the minimum threshold is used.
    Returns a list of (xy (cap,2) sub-pixel level coords, score (cap,),
    valid (cap,)) per level."""
    levels = [_level_image(img0, lvl, h, w)
              for lvl, (h, w) in enumerate(sizes)]
    # both thresholds at once: [0] initial, [1] minimum
    scores, masked, counts = ck.orb_fast(levels, ini_thr, min_thr, EDGE)
    sel_scores, tops, idxs = [], [], []
    for lvl in range(len(sizes)):
        use_min = counts[lvl] < mins[lvl]
        sel_scores.append(torch.where(use_min, scores[lvl][1],
                                      scores[lvl][0]).reshape(-1))
        flat = torch.where(use_min, masked[lvl][1], masked[lvl][0])
        top, idx = _top_k_first_index(flat.reshape(-1), caps[lvl])
        tops.append(top)
        idxs.append(idx)
    # the sub-pixel step of every level's candidates at once: each
    # candidate's level width, height and offset into the levels' scores
    dev = img0.device
    w, h, base = (_constant(("candidate_" + name, sizes, caps), dev, make)
                  for name, make in _candidate_tables(sizes, caps).items())
    sf = torch.cat(sel_scores)
    top = torch.cat(tops)
    idx = torch.cat(idxs)
    xs = idx % w
    ys = idx // w

    def at(dy, dx):
        return sf[base + (ys + dy).clamp(min=0).minimum(h - 1) * w
                  + (xs + dx).clamp(min=0).minimum(w - 1)]

    num_x = at(0, 1) - at(0, -1)
    den_x = 2.0 * (2.0 * top - at(0, 1) - at(0, -1))
    num_y = at(1, 0) - at(-1, 0)
    den_y = 2.0 * (2.0 * top - at(1, 0) - at(-1, 0))
    off_x = torch.where(den_x.abs() > 1e-6,
                        num_x / torch.where(den_x == 0, 1.0, den_x),
                        0.0).clamp(-0.5, 0.5)
    off_y = torch.where(den_y.abs() > 1e-6,
                        num_y / torch.where(den_y == 0, 1.0, den_y),
                        0.0).clamp(-0.5, 0.5)
    xy = torch.stack([xs.to(torch.float32) + off_x,
                      ys.to(torch.float32) + off_y], -1)
    return [(a, b, b > 0.0) for a, b in zip(xy.split(caps), top.split(caps))]


def _candidate_tables(sizes, caps):
    """Per candidate slot of the concatenated levels (caps[l] slots for
    level l): the level's width, height and its scores' offset, as makers
    of int64 arrays."""
    def per_slot(values):
        return lambda: np.repeat(np.asarray(values, np.int64), caps)

    offsets = np.cumsum([0] + [h * w for h, w in sizes[:-1]])
    return {"w": per_slot([w for _, w in sizes]),
            "h": per_slot([h for h, _ in sizes]),
            "base": per_slot(offsets)}


def orb_describe_all(img0, sizes, kpts_list, valid_list):
    """Oriented BRIEF for every level with no host read: each level
    resized again (cheaper than keeping the images) and blurred, then the
    ``orb_describe`` kernel's one launch for the moments at the keypoints,
    the angles and the bits. Returns (desc, angle) per level."""
    levels = [_level_image(img0, lvl, h, w)
              for lvl, (h, w) in enumerate(sizes)]
    pat = _constant("pattern", img0.device,
                    lambda: _PATTERN.astype(np.float32))
    return ck.orb_describe(levels, [blur7(x) for x in levels],
                           list(kpts_list), list(valid_list), pat)


def distribute_quadtree(kpts: np.ndarray, scores: np.ndarray, n_target: int,
                        bounds: Tuple[float, float, float, float]) -> np.ndarray:
    """Quadtree balancing (DistributeOctTree) by ``csrc/quadtree.cpp``:
    split nodes until there are ``n_target``, keep the best corner per
    node. Returns the selected indices into ``kpts``, sorted."""
    fn = _build.load_host("quadtree").quadtree_select
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                   ctypes.c_int]
    kpts = np.ascontiguousarray(kpts, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    if kpts.shape != (len(scores), 2):
        raise ValueError(f"kpts {kpts.shape} and scores {scores.shape}")
    out = np.empty(max(n_target * 4, 16), np.int32)
    x0, y0, x1, y1 = bounds
    m = fn(kpts.ctypes.data, scores.ctypes.data, len(kpts), n_target,
           x0, y0, x1, y1, out.ctypes.data, len(out))
    return out[:m].astype(np.int64)


class ORBExtractor:
    """The classic front end (the USE_ORB mode), returning the same dict as
    the XFeat extractor with 256-d binary descriptors and per-keypoint
    octave and angle. ``device``: where the two stages run, CUDA unless the
    caller asks for the CPU; on the card each stage replays a CUDA graph."""

    def __init__(self, nfeatures: int = 1000,
                 scale_factor: float = SCALE_FACTOR,
                 n_levels: int = N_LEVELS, ini_threshold: float = 20.0,
                 min_threshold: float = 7.0, device=None):
        self.device = resolve_device(device)
        self.nfeatures = nfeatures
        self.n_levels = n_levels
        self.scale_factor = scale_factor
        self.ini_threshold = ini_threshold
        self.min_threshold = min_threshold
        self.scales = [scale_factor ** i for i in range(n_levels)]
        # per-level feature budget, geometric split (ORBextractor.cc)
        factor = 1.0 / scale_factor
        n_desired = nfeatures * (1 - factor) / (1 - factor ** n_levels)
        self.n_per_level = []
        acc = 0
        for _ in range(n_levels - 1):
            n = round(n_desired)
            self.n_per_level.append(n)
            acc += n
            n_desired *= factor
        self.n_per_level.append(max(nfeatures - acc, 0))
        self._graphs = None
        if self.device.type == "cuda":
            from ..optim.track_step import CapturedCalls

            self._graphs = (CapturedCalls(self.device, "orb_candidates"),
                            CapturedCalls(self.device, "orb_describe_all"))

    def _level_sizes(self, H0: int, W0: int):
        """(h, w) per usable level for one image size."""
        sizes = []
        for lvl in range(self.n_levels):
            h = H0 if lvl == 0 else int(round(H0 / self.scales[lvl]))
            w = W0 if lvl == 0 else int(round(W0 / self.scales[lvl]))
            if h <= 2 * EDGE + 7 or w <= 2 * EDGE + 7:
                break
            sizes.append((h, w))
        return tuple(sizes)

    def geometry(self, H0: int, W0: int):
        """The static shapes of one image size: (level sizes, candidate cap
        per level, fire count per level below which the minimum threshold
        is used)."""
        sizes = self._level_sizes(H0, W0)
        caps = tuple(min(self.n_per_level[lvl] * 8, h * w)
                     for lvl, (h, w) in enumerate(sizes))
        mins = tuple(2 * self.n_per_level[lvl] for lvl in range(len(sizes)))
        return sizes, caps, mins

    def candidates(self, x0, sizes, caps, mins):
        """The first stage: by graph replay on the card, eager elsewhere.
        Returns its (device) outputs."""
        ini, mn = float(self.ini_threshold), float(self.min_threshold)

        def run(img):
            return orb_candidates(img, sizes, caps, mins, ini, mn)

        if self._graphs is None:
            return run(x0)
        return self._graphs[0].replay((sizes, caps, mins, ini, mn), (x0,),
                                      run)

    def descriptors(self, x0, sizes, kpts, valid):
        """The second stage (lists of per-level padded keypoints and their
        masks): by graph replay on the card, eager elsewhere."""
        L = len(sizes)

        def run(img, *kv):
            return orb_describe_all(img, sizes, kv[:L], kv[L:])

        if self._graphs is None:
            return run(x0, *kpts, *valid)
        pads = tuple(int(k.shape[0]) for k in kpts)
        return self._graphs[1].replay((sizes, pads), (x0, *kpts, *valid),
                                      run)

    def select(self, cands, sizes):
        """The host step between the stages: each level's valid candidates
        (numpy, from ``candidates``) balanced by the quadtree. Returns the
        per-level padded keypoints and masks (CPU tensors, 2x the level's
        budget) and (level, xy, score) of the kept keypoints."""
        kp_pad, va_pad, keep = [], [], []
        for lvl, (h, w) in enumerate(sizes):
            xy, sc, va = cands[lvl]
            xy, sc = xy[va], sc[va]
            n_pad = self.n_per_level[lvl] * 2
            kp = np.zeros((n_pad, 2), np.float32)
            vm = np.zeros(n_pad, bool)
            if len(xy):
                sel = distribute_quadtree(xy, sc, self.n_per_level[lvl],
                                          (EDGE, EDGE, w - EDGE, h - EDGE))
                xy, sc = xy[sel], sc[sel]
                n = min(len(xy), n_pad)
                kp[:n] = xy[:n]
                vm[:n] = True
                keep.append((lvl, xy[:n], sc[:n]))
            kp_pad.append(torch.from_numpy(kp))
            va_pad.append(torch.from_numpy(vm))
        return kp_pad, va_pad, keep

    @torch.no_grad()
    def __call__(self, image: np.ndarray):
        """image: (H,W) uint8/float (or (H,W,C), averaged). Returns a numpy
        dict kpts/scores/desc/valid/octave/angle with kpts in level-0
        coordinates (leading batch dim 1): the candidates stage, one host
        read, the quadtree per level, the descriptor stage, one host read."""
        from ..optim.track_step import fetch

        img0 = np.asarray(image, np.float32)
        if img0.ndim == 3:
            img0 = img0.mean(-1)
        K = self.nfeatures
        sizes, caps, mins = self.geometry(*img0.shape)
        x0 = torch.from_numpy(np.ascontiguousarray(img0))
        if self._graphs is None:
            x0 = x0.to(self.device)
        cands = fetch(self.candidates(x0, sizes, caps, mins))

        kp_pad, va_pad, keep = self.select(cands, sizes)
        if self._graphs is None:
            kp_pad = [k.to(self.device) for k in kp_pad]
            va_pad = [v.to(self.device) for v in va_pad]
        desc_all = fetch(self.descriptors(x0, sizes, kp_pad, va_pad))

        all_kpts, all_scores, all_desc, all_oct, all_ang = [], [], [], [], []
        for (lvl, xy, sc) in keep:
            n = len(xy)
            desc, ang = desc_all[lvl]
            all_kpts.append(xy * self.scales[lvl])
            all_scores.append(sc)
            all_desc.append(desc[:n])
            all_ang.append(ang[:n])
            all_oct.append(np.full(n, lvl, np.int32))

        kpts = np.concatenate(all_kpts) if all_kpts else np.zeros((0, 2), np.float32)
        scores = np.concatenate(all_scores) if all_scores else np.zeros(0, np.float32)
        desc = np.concatenate(all_desc) if all_desc else np.zeros((0, 256), np.float32)
        octv = np.concatenate(all_oct) if all_oct else np.zeros(0, np.int32)
        angs = np.concatenate(all_ang) if all_ang else np.zeros(0, np.float32)

        out_k = np.zeros((1, K, 2), np.float32)
        out_s = np.zeros((1, K), np.float32)
        out_d = np.zeros((1, K, 256), np.float32)
        out_v = np.zeros((1, K), bool)
        out_o = np.zeros((1, K), np.int32)
        out_a = np.zeros((1, K), np.float32)
        n = min(len(kpts), K)
        if n:
            order = np.argsort(-scores)[:n]
            out_k[0, :n] = kpts[order]
            out_s[0, :n] = scores[order]
            out_d[0, :n] = desc[order]
            out_o[0, :n] = octv[order]
            out_a[0, :n] = angs[order]
            out_v[0, :n] = True
        return {"kpts": out_k, "scores": out_s, "desc": out_d,
                "valid": out_v, "octave": out_o, "angle": out_a}

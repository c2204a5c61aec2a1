"""Wrappers of the hand-written CUDA kernels, with their plain PyTorch
versions and launch counters.

Counterpart of ``xfeatslam_tpu/ops/pallas_kernels.py``. Each wrapper
takes the same arguments and returns the same layout as the JAX function
it replaces. On a CPU tensor it runs the plain version; on a CUDA tensor
it launches its kernel (from ``csrc/``, built at first use by
``_build.py``) on the current stream or raises, never falling back. Each
wrapper counts its kernel launches in a plain int attribute,
``<wrapper>.launches``.

Kernels:
  detect_candidates     csrc/detect_candidates.cu  (pallas_kernels.py:373)
  bilinear_desc_sample  csrc/desc_sample.cu        (pallas_kernels.py:504)
  keypoint_desc         csrc/desc_sample.cu        (the same kernel, fed by
                        the decode and taps of detect.py:462-503)
  mutual_nn_pairs       csrc/mnn_pairs.cu          (pallas_kernels.py:595)
  similarity_top2       csrc/mnn_pairs.cu          (pallas_kernels.py:84)
  pose_lm               csrc/pose_lm.cu            (optim/pose_opt.py:82, XLA
                        code in the JAX package, not Pallas: the pose LM
                        in one launch, a two-CTA cluster, in place of
                        ~20,000 small kernels)
  local_ba              csrc/local_ba.cu           (optim/local_ba.py:102, XLA
                        code in the JAX package, not Pallas: a BA solve
                        in one persistent cooperative launch in place of
                        ~3,300 small kernels per LM iteration)
  orb_fast              csrc/orb_fast.cu           (models/orb.py:93-131, XLA
                        code in the JAX package: the pyramid, FAST at both
                        thresholds, suppression and the border of every
                        level in one launch from the level-0 image)
  orb_describe          csrc/orb_describe.cu       (models/orb.py:148-204, XLA
                        code in the JAX package: moments, angle, the blur
                        at the samples and rotated BRIEF at the keypoints
                        of every level in one launch from the levels)
  xfeat_stem            csrc/xfeat_stem.cu         (models/xfeat.py's stem,
                        XLA convs in the JAX package: the instance norm,
                        block1, the skip branch and the keypoint head's
                        space-to-depth in two launches)
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from . import image, lie
from .camera import Pinhole, pinhole_project, pinhole_project_jac

# Per-cell candidate slots: 5x5 NMS forces >= 3 px spacing, so an 8x8 cell
# holds at most ceil(8/3)^2 = 9 distinct-score survivors.
NC_CAND = 9
_SMEM_MAX = 227 * 1024
# detect tiles (cell rows, cell columns) per CTA, the largest first: the
# fastest of those timed by extraction_timing.py --tiles at batch 32 and 256
# (16x16) and at batch 1 (2x8, 300 CTAs); see PERF.md
_DETECT_TILES = ((16, 16), (8, 16), (2, 8))

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> (library in csrc/, argument types; a kernel's stream
# comes last)
_ENTRY_POINTS = {
    "detect_candidates": ("detect_candidates",
                          [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                           _F, _F, _P]),
    "detect_smem_bytes": ("detect_candidates", [_I, _I, _I]),  # host only
    "desc_sample": ("desc_sample", [_P, _P, _P, _P, _I, _I, _I, _P]),
    "keypoint_desc": ("desc_sample", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _F, _F, _P]),
    "mnn_pairs": ("mnn_pairs",
                  [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "similarity_top2": ("mnn_pairs", [_P, _P, _P, _P, _P, _P, _I, _I, _P]),
    "mnn_row_tile": ("mnn_pairs", [_I, _I]),  # host only, no stream
    "pose_lm": ("pose_lm", [_P] * 13 + [_I, _I, _I, _F, _F, _F, _F, _F, _P]),
    "local_ba": ("local_ba", [_P] * 22 + [_I] * 10 + [_F] * 5 + [_P, _P]),
    # host only; returns a count, not an error code
    "local_ba_scratch_floats": ("local_ba", [_I] * 6, ctypes.c_longlong),
    "orb_fast": ("orb_fast", [_P, _I, _I, _I] + [_P] * 5
                 + [_F, _F, _I, _I, _P]),
    "orb_describe": ("orb_describe", [_P] * 8 + [_I, _P, _P]),
    "xfeat_stem_chunks": ("xfeat_stem", [_I, _I, _P]),  # host only
    "xfeat_stem_occupancy": ("xfeat_stem", []),  # host only
    "xfeat_stem": ("xfeat_stem", [_P] * 7 + [_I] * 5 + [_P]),
}
_entries: dict = {}


def _entry(fn: str):
    """The C entry point ``fn`` with its argument types declared."""
    f = _entries.get(fn)
    if f is None:
        library, argtypes, *restype = _ENTRY_POINTS[fn]
        f = getattr(_build.load(library), fn)
        f.argtypes = argtypes
        f.restype = restype[0] if restype else ctypes.c_int
        _entries[fn] = f
    return f


def _launch(fn: str, device: int, *args) -> None:
    """Call kernel entry ``fn`` on the current stream of CUDA ``device``."""
    # the raw handle: torch.cuda.current_stream() builds a Stream object,
    # which costs more host time than some of these kernels take to run
    stream = torch._C._cuda_getCurrentRawStream(device)
    err = _entry(fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed to launch: error {err}")


def _on_cuda(*tensors) -> bool:
    """True if every tensor lies on a CUDA device, False if all lie on the
    CPU; anything else raises."""
    if all(t.is_cuda for t in tensors) and len({t.get_device()
                                                for t in tensors}) == 1:
        return True
    if all(t.device.type == "cpu" for t in tensors):
        return False
    raise ValueError(f"tensors must all lie on one CUDA device or all on the "
                     f"CPU, got {[str(t.device) for t in tensors]}")


def _check(t, name, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _ptr(t) -> int:
    return t.data_ptr()


_sm_counts: dict = {}


def _sm_count(device: int) -> int:
    n = _sm_counts.get(device)
    if n is None:
        n = _sm_counts[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


# ---------------------------------------------------------------------------
# 1. detect_candidates


def detect_candidates_plain(logits, heatmap, threshold: float = 0.05,
                            softmax_temp: float = 1.0, nc: int = NC_CAND):
    """Plain version: the cell-space ops of ``ops/detect.py``."""
    from . import detect  # detect imports this module

    ranked, p = detect.ranked_score_cells(logits, heatmap, threshold,
                                          softmax_temp)
    return detect.cell_candidates(ranked, detect.packed_aux_cells(p), nc)


def detect_grid(B: int, H8: int, W8: int, sms: int = 132) -> tuple:
    """(CTAs, cell rows per CTA, column parts) of a detect launch on ``sms``
    SMs: the first tile of ``_DETECT_TILES`` (cell rows x cell columns,
    clipped to the image) that gives at least two CTAs per SM, else the
    last. CTA (b, i) covers cell rows [s*S, s*S+S) and cell columns
    [p*CW, p*CW+CW), both clipped to the image, with s = i // parts,
    p = i % parts and CW = ceil(W8 / parts)."""
    for rows, cols in _DETECT_TILES:
        S = max(1, min(rows, H8))
        parts = -(-W8 // max(1, min(cols, W8)))
        ctas = B * -(-H8 // S) * parts
        if ctas >= 2 * sms:
            break
    return ctas, S, parts


def detect_candidates(logits, heatmap, threshold: float = 0.05,
                      softmax_temp: float = 1.0, nc: int = NC_CAND):
    """(B,H8,W8,65) logits + (B,H8,W8,1) reliability -> per-cell
    candidates vals, aux, each (B,H8,nc,W8) float32:
      vals  ranking score of the cell's r-th best pixel (-1 where it is not
            an NMS survivor),
      aux   float32-exact packed integer ch<<18 | qx<<9 | qy, ch = py*8+px
            the channel in the cell, q the quantized soft-argmax offsets.
    Candidate (b, cy, r, cx) is pixel (cy*8+ch//8, cx*8+ch%8)."""
    if not _on_cuda(logits, heatmap):
        return detect_candidates_plain(logits, heatmap, threshold,
                                       softmax_temp, nc)
    B, H8, W8, _ = logits.shape
    _check(logits, "logits", torch.float32, (B, H8, W8, 65))
    _check(heatmap, "heatmap", torch.float32, (B, H8, W8, 1))
    if not 1 <= nc <= 64:
        raise ValueError(f"nc must lie in [1, 64], got {nc}")
    vals = torch.empty((B, H8, nc, W8), dtype=torch.float32,
                       device=logits.device)
    aux = torch.empty_like(vals)
    if B * H8 * W8 == 0:
        return vals, aux
    device = logits.get_device()
    _, S, parts = detect_grid(B, H8, W8, _sm_count(device))
    CW = -(-W8 // parts)
    if _entry("detect_smem_bytes")(S, CW, nc) > _SMEM_MAX:
        raise ValueError(f"detect_candidates: nc={nc} exceeds the kernel's "
                         "shared memory")
    # one thread per (cell row, pixel column) of the tile, up to 512
    threads = 512 if S * CW * 8 > 256 else 256
    # the reliability positions' scale, rounded to float32 once, as JAX does
    scale_x = float(np.float32(W8 / (W8 * 8 - 1.0)))
    scale_y = float(np.float32(H8 / (H8 * 8 - 1.0)))
    _launch("detect_candidates", device, _ptr(logits), _ptr(heatmap),
            _ptr(vals), _ptr(aux), B, H8, W8, nc, S, parts, threads,
            threshold, softmax_temp, scale_x, scale_y)
    detect_candidates.launches += 1
    return vals, aux


detect_candidates.launches = 0


# ---------------------------------------------------------------------------
# 2. bilinear_desc_sample


def _l2n(x):
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)


def bilinear_desc_sample_plain(feats, idx4, w4):
    """Plain version: normalize the grid, gather the 4 taps, weight, sum,
    renormalize."""
    B, NP, C = feats.shape
    K = idx4.shape[1]
    taps = torch.gather(_l2n(feats), 1,
                        idx4.long().reshape(B, K * 4, 1).expand(-1, -1, C))
    d = (taps.reshape(B, K, 4, C) * w4[..., None]).sum(dim=2)
    return _l2n(d)


def bilinear_desc_sample(feats, idx4, w4):
    """Normalize -> 4-tap bilinear descriptor sampling -> renormalize.

    Args:
      feats: (B, NP, 64) raw dense descriptors (NP = H8*W8 grid pixels).
      idx4: (B, K, 4) int32 grid-row index of each tap, in [0, NP)
        (out-of-bounds taps clamped in bounds and given weight 0).
      w4: (B, K, 4) float32 tap weights, zero for out-of-bounds taps and
        invalid keypoints.
    Returns (B, K, 64) L2-normalized descriptors; rows whose weights are all
    zero are zero."""
    if not _on_cuda(feats, idx4, w4):
        return bilinear_desc_sample_plain(feats, idx4, w4)
    B, NP, _ = feats.shape
    K = idx4.shape[1]
    _check(feats, "feats", torch.float32, (B, NP, 64))
    _check(idx4, "idx4", torch.int32, (B, K, 4))
    _check(w4, "w4", torch.float32, (B, K, 4))
    if feats.data_ptr() % 16:
        raise ValueError("feats: must be 16-byte aligned (read as float4)")
    out = torch.empty((B, K, 64), dtype=torch.float32, device=feats.device)
    _launch("desc_sample", feats.get_device(), _ptr(feats), _ptr(idx4),
            _ptr(w4), _ptr(out), B, NP, K)
    bilinear_desc_sample.launches += 1
    return out


bilinear_desc_sample.launches = 0


def keypoint_desc_plain(feats, scores, sel, aux, W8: int,
                        subpixel: bool = False):
    """Plain version: the candidates' decode, ``detect.desc_taps`` and
    ``bilinear_desc_sample_plain``."""
    from . import detect  # detect imports this module

    H8 = feats.shape[1] // W8
    kpts, off = detect.decode_candidates(sel, aux, W8)
    if subpixel:
        kpts = kpts + off
    idx4, w4 = detect.desc_taps(kpts, scores > 0.0, H8, W8)
    return kpts, bilinear_desc_sample_plain(feats, idx4, w4)


def keypoint_desc(feats, scores, sel, aux, W8: int, subpixel: bool = False):
    """The descriptor stage after the top-k over the detect candidates, in
    one launch: decode the selected candidates' pixels (and, with
    ``subpixel``, their quantized soft-argmax offsets), compute the four
    bilinear taps of each keypoint as ``detect.desc_taps`` does, and sample
    as ``bilinear_desc_sample`` does.

    Args:
      feats: (B, H8*W8, 64) float32 raw dense descriptors.
      scores, sel: (B, K) float32 and int64, ``torch.topk`` of the
        flattened candidate scores; a keypoint is valid where its score > 0.
      aux: (B, H8, nc, W8) float32 packed candidates of
        ``detect_candidates``.
    Returns kpts (B, K, 2) float32 (x, y) pixels and desc (B, K, 64)
    L2-normalized, zero where invalid."""
    if not _on_cuda(feats, scores, sel, aux):
        return keypoint_desc_plain(feats, scores, sel, aux, W8, subpixel)
    B, K = sel.shape
    H8, nc = aux.shape[1], aux.shape[2]
    _check(feats, "feats", torch.float32, (B, H8 * W8, 64))
    _check(scores, "scores", torch.float32, (B, K))
    _check(sel, "sel", torch.int64, (B, K))
    _check(aux, "aux", torch.float32, (B, H8, nc, W8))
    if feats.data_ptr() % 16:
        raise ValueError("feats: must be 16-byte aligned (read as float4)")
    kpts = torch.empty((B, K, 2), dtype=torch.float32, device=feats.device)
    desc = torch.empty((B, K, 64), dtype=torch.float32, device=feats.device)
    # the positions' scale, rounded to float32 once, as the plain ops do
    scale_x = float(np.float32(W8 / (W8 * 8 - 1.0)))
    scale_y = float(np.float32(H8 / (H8 * 8 - 1.0)))
    _launch("keypoint_desc", feats.get_device(), _ptr(feats), _ptr(scores),
            _ptr(sel), _ptr(aux), _ptr(kpts), _ptr(desc), B, H8, W8, nc, K,
            int(subpixel), scale_x, scale_y)
    keypoint_desc.launches += 1
    return kpts, desc


keypoint_desc.launches = 0


# ---------------------------------------------------------------------------
# 3. mutual_nn_pairs


# columns whose list fits a matcher CTA's shared memory (kMaxM in
# csrc/mnn_pairs.cu)
MATCHER_MAX_COLUMNS = 16384


def _check_matcher_inputs(desc_a, desc_b, M):
    for t, name in ((desc_a, "desc_a"), (desc_b, "desc_b")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned (rows are "
                             "copied in 16-byte pieces)")
    if M > MATCHER_MAX_COLUMNS:
        raise ValueError(f"desc_b: {M} columns exceed the matcher kernel's "
                         f"{MATCHER_MAX_COLUMNS} (its list of valid columns "
                         "lives in shared memory)")


def matcher_grid(P: int, N: int) -> tuple:
    """(CTAs, rows per CTA) of a matcher launch on P pairs of N rows, on the
    current CUDA device: 64 rows per CTA of 256 threads, or 16 rows per CTA
    of 512 threads (eight slices of 32 columns) when 64-row CTAs would give
    under two CTAs per SM."""
    rows = _entry("mnn_row_tile")(P, N)
    return P * -(-N // rows), rows


def _distances(s1, s2):
    return (2.0 - 2.0 * s1) * 512.0, (2.0 - 2.0 * s2) * 512.0


def mutual_nn_pairs_plain(desc_a, desc_b, valid_a, valid_b):
    """Plain version: the full similarity matrices, masked, reduced."""
    sim = torch.bmm(desc_a, desc_b.transpose(1, 2))
    sim = sim.masked_fill(~valid_b[:, None, :], float("-inf"))
    s1, idx = sim.max(dim=2)
    s2 = sim.scatter(2, idx[..., None], float("-inf")).amax(dim=2)
    col_best = sim.masked_fill(~valid_a[:, :, None], float("-inf")).argmax(dim=1)
    best, second = _distances(s1, s2)
    return best, second, idx.to(torch.int32), col_best.to(torch.int32)


def mutual_nn_pairs(desc_a, desc_b, valid_a, valid_b):
    """Mutual-NN primitives over aligned frame pairs.

    Args:
      desc_a (P, N, 64), desc_b (P, M, 64) float32: pair i matches
        desc_a[i] against desc_b[i].
      valid_a (P, N), valid_b (P, M) bool.
    Returns best and second (P, N) distances (2-2s)*512 over valid columns
    (inf where a row has none), idx (P, N) int32 the first best column, and
    col_best (P, M) int32 the first best valid row of each valid column (0
    for an invalid column). One kernel launch, which scores only the valid
    columns and takes the row top-2 and the column best from the same
    similarities."""
    if not _on_cuda(desc_a, desc_b, valid_a, valid_b):
        return mutual_nn_pairs_plain(desc_a, desc_b, valid_a, valid_b)
    P, N, _ = desc_a.shape
    M = desc_b.shape[1]
    _check(desc_a, "desc_a", torch.float32, (P, N, 64))
    _check(desc_b, "desc_b", torch.float32, (P, M, 64))
    _check(valid_a, "valid_a", torch.bool, (P, N))
    _check(valid_b, "valid_b", torch.bool, (P, M))
    _check_matcher_inputs(desc_a, desc_b, M)
    dev = desc_a.device
    best = torch.empty((P, N), dtype=torch.float32, device=dev)
    second = torch.empty_like(best)
    idx = torch.empty((P, N), dtype=torch.int32, device=dev)
    col_best = torch.empty((P, M), dtype=torch.int32, device=dev)
    # the kernel's column keys (P*M) and its finished-CTA count per pair (P)
    scratch = torch.zeros(P * M + P, dtype=torch.int64, device=dev)
    _launch("mnn_pairs", desc_a.get_device(), _ptr(desc_a), _ptr(desc_b),
            _ptr(valid_a), _ptr(valid_b), _ptr(best), _ptr(second), _ptr(idx),
            _ptr(col_best), _ptr(scratch), P, N, M)
    mutual_nn_pairs.launches += 1
    return best, second, idx, col_best


mutual_nn_pairs.launches = 0


# ---------------------------------------------------------------------------
# 4. similarity_top2 (single pair) and its distance wrappers


def similarity_top2_plain(desc_a, desc_b, valid_b=None):
    """Plain version: the full similarity matrix, masked, reduced."""
    sim = desc_a @ desc_b.T
    if valid_b is not None:
        sim = sim.masked_fill(~valid_b[None, :], float("-inf"))
    s1, i1 = sim.max(dim=1)
    s2 = sim.scatter(1, i1[:, None], float("-inf")).amax(dim=1)
    return s1, s2, i1.to(torch.int32)


def similarity_top2(desc_a, desc_b, valid_b=None):
    """Row-wise top-2 similarity of one pair over valid columns, never
    storing the (N,M) matrix.

    Args:
      desc_a (N,64), desc_b (M,64) float32; valid_b optional (M,) bool
        (invalid columns score -inf).
    Returns s1, s2 (N,) float32 similarities and i1 (N,) int32: ties go to
    the first column, s2 excludes only column i1 (a tie gives s2 = s1), and
    a row without a valid column gets s1 = s2 = -inf, i1 = 0. Unlike the
    TPU kernel, any N is taken (no padding to a row tile). One launch of
    the ``mutual_nn_pairs`` kernel without its column pass, over the valid
    columns only, in CTAs of 16 rows when 64-row CTAs would leave the card
    half idle."""
    if valid_b is None:
        valid_b = torch.ones(desc_b.shape[0], dtype=torch.bool,
                             device=desc_b.device)
    if not _on_cuda(desc_a, desc_b, valid_b):
        return similarity_top2_plain(desc_a, desc_b, valid_b)
    N, M = desc_a.shape[0], desc_b.shape[0]
    _check(desc_a, "desc_a", torch.float32, (N, 64))
    _check(desc_b, "desc_b", torch.float32, (M, 64))
    _check(valid_b, "valid_b", torch.bool, (M,))
    _check_matcher_inputs(desc_a, desc_b, M)
    s1 = torch.empty(N, dtype=torch.float32, device=desc_a.device)
    s2 = torch.empty_like(s1)
    i1 = torch.empty(N, dtype=torch.int32, device=desc_a.device)
    _launch("similarity_top2", desc_a.get_device(), _ptr(desc_a),
            _ptr(desc_b), _ptr(valid_b), _ptr(s1), _ptr(s2), _ptr(i1), N, M)
    similarity_top2.launches += 1
    return s1, s2, i1


similarity_top2.launches = 0


def xfeat_best_two_distances(desc_a, desc_b, valid_a=None, valid_b=None):
    """Row-wise (best, second, argbest) XFeat distances (2-2s)*512 through
    ``similarity_top2``: the map is decreasing, so the top-2 similarities
    give the two smallest distances. Invalid rows get inf."""
    s1, s2, i1 = similarity_top2(desc_a, desc_b, valid_b)
    d1, d2 = _distances(s1, s2)
    if valid_a is not None:
        d1 = d1.masked_fill(~valid_a, float("inf"))
        d2 = d2.masked_fill(~valid_a, float("inf"))
    return d1, d2, i1


def mutual_nn_top2(desc_a, desc_b, valid_a, valid_b):
    """Mutual-NN primitives of one pair in two ``similarity_top2`` launches:
    the row top-2 of a against b, and each column's first best valid row
    (the row pass of b against a under ``valid_a``). ``col_best_row`` is not
    masked by ``valid_b``. Returns (best (N,), second (N,), idx (N,) int32,
    col_best_row (M,) int32)."""
    d1, d2, i1 = xfeat_best_two_distances(desc_a, desc_b, valid_a, valid_b)
    _, _, col_best = similarity_top2(desc_b, desc_a, valid_a)
    return d1, d2, i1, col_best


# ---------------------------------------------------------------------------
# 5. pose_lm: the robust pose LM (Optimizer::PoseOptimization)

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
# edges one launch takes: a 16-bit mask of each flag per thread of a
# 512-thread CTA, and 28 B an edge of shared memory (kMaxEdges in
# csrc/pose_lm.cu)
POSE_LM_MAX_EDGES = 8192


def _pose_errors(R, t, Xw, obs_uv, obs_ur, cam: Pinhole, bf):
    """Batched mono+stereo residuals e (N,3) = [obs_uv - uv, obs_ur - uR],
    with the virtual right u, uR = u - bf/z; also the camera-frame points
    and 1/z."""
    Xc = lie.se3_apply(R, t, Xw)
    uv = pinhole_project(cam, Xc)
    z = Xc[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-6, 1e-6, z)
    e_ur = obs_ur - (uv[..., 0] - bf * inv_z)
    return torch.cat([obs_uv - uv, e_ur[..., None]], -1), Xc, inv_z


def _pose_residuals(R, t, Xw, obs_uv, obs_ur, cam: Pinhole, bf):
    """Residuals e (N,3) and Jacobians J (N,3,6) with respect to
    [rho, phi]; the third row belongs to stereo edges only (the caller's
    weighting zeroes it for mono edges)."""
    e, Xc, inv_z = _pose_errors(R, t, Xw, obs_uv, obs_ur, cam, bf)
    Jproj = pinhole_project_jac(cam, Xc)  # (N,2,3)
    zero = torch.zeros_like(inv_z)
    # d uR/dXc = du/dXc + [0, 0, bf/z^2]
    dur = Jproj[:, 0, :] + torch.stack([zero, zero, bf * inv_z * inv_z], -1)
    Jc = torch.cat([Jproj, dur[:, None, :]], 1)  # (N,3,3)
    # dXc/d[rho,phi] = [I | -hat(Xc)]
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(
        Xc.shape[:-1] + (3, 3))
    dXc = torch.cat([eye, -lie.so3_hat(Xc)], -1)  # (N,3,6)
    return e, -lie.mat_mul(Jc, dXc)


def _edge_chi2(e, inv_sigma2, is_stereo):
    """Per-edge chi2 = e^T Omega e, the third row dropped for mono edges."""
    e2 = e * e
    mono = e2[..., 0] + e2[..., 1]
    return torch.where(is_stereo, mono + e2[..., 2], mono) * inv_sigma2


def pose_lm_plain(R0, t0, Xw, obs_uv, obs_ur, inv_sigma2, is_stereo, valid,
                  cam: Pinhole, bf: float = 0.0, rounds: int = 4,
                  iters: int = 10):
    """Plain version: the schedules as ~250 tensor ops per LM iteration.
    Everything stays on the device: accept/reject and the final pick are
    ``torch.where`` selections, the 6x6 solve is ``torch.linalg.solve_ex``
    (no error check, hence no host sync), and the iteration counts are
    Python constants."""
    delta_base = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    ones = torch.ones_like(inv_sigma2)
    row_mask3 = torch.stack([ones, ones, is_stereo.to(inv_sigma2.dtype)], -1)

    def chi2_at(R, t):
        e, _, _ = _pose_errors(R, t, Xw, obs_uv, obs_ur, cam, bf)
        return _edge_chi2(e, inv_sigma2, is_stereo)

    def robust_cost(chi2, use_huber: bool, dscale: float):
        if not use_huber:
            return chi2
        delta2 = delta_base * dscale
        return torch.where(chi2 <= delta2, chi2,
                           2.0 * torch.sqrt(delta2 * chi2.clamp(min=0.0))
                           - delta2)

    def total_cost(R, t, active, use_huber: bool, dscale: float = 1.0):
        cost = robust_cost(chi2_at(R, t), use_huber, dscale)
        return torch.where(active, cost, 0.0).sum()

    def normal_equations(R, t, active, use_huber: bool, dscale: float):
        e, J = _pose_residuals(R, t, Xw, obs_uv, obs_ur, cam, bf)
        chi2 = _edge_chi2(e, inv_sigma2, is_stereo)
        w = inv_sigma2 * active
        if use_huber:
            delta2 = delta_base * dscale
            w = w * torch.where(chi2 <= delta2, 1.0,
                                torch.sqrt(delta2 / chi2.clamp(min=1e-12)))
        Jw = J * (w[:, None] * row_mask3)[..., None]  # (N,3,6)
        H = (Jw[..., :, None] * J[..., None, :]).sum((0, 1))
        b = -(Jw * e[..., None]).sum((0, 1))  # solve H dx = -J^T W e
        return H, b

    eye6 = torch.eye(6, dtype=Xw.dtype, device=Xw.device)

    def lm_round(R, t, active, use_huber: bool, dscale: float):
        lam = torch.full((), 1e-3, dtype=Xw.dtype, device=Xw.device)
        # the cost of the current pose: recomputed at the top of every
        # iteration in the JAX version, it equals the carried value (the
        # accepted cost1 or the unchanged cost0), so it is carried here
        cost0 = total_cost(R, t, active, use_huber, dscale)
        for _ in range(iters):
            H, b = normal_equations(R, t, active, use_huber, dscale)
            # Marquardt scaling lam*diag(H), then Jacobi preconditioning:
            # the raw system mixes px^2/rad^2 and px^2/m^2 scales
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-6 * eye6
            s = torch.rsqrt(torch.diagonal(Hd) + 1e-12)
            Hs = Hd * s[:, None] * s[None, :]
            dx = torch.linalg.solve_ex(Hs, b * s)[0] * s
            dR, dt = lie.se3_exp(dx)
            Rn, tn = lie.se3_compose(dR, dt, R, t)
            cost1 = total_cost(Rn, tn, active, use_huber, dscale)
            accept = (cost1 < cost0) & torch.isfinite(dx).all()
            R = torch.where(accept, Rn, R)
            t = torch.where(accept, tn, t)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
            cost0 = torch.where(accept, cost1, cost0)
        return R, t

    def schedule(dscales, huber_flags):
        R, t = R0, t0
        active = valid
        for rnd in range(rounds):
            R, t = lm_round(R, t, active, huber_flags[rnd], dscales[rnd])
            active = valid & (chi2_at(R, t)
                              <= delta_base * dscales[min(rnd + 1, rounds - 1)])
        return R, t

    # candidate A: the reference's schedule (Huber for 2 rounds, then plain)
    Ra, ta = schedule((1.0,) * rounds, (True, True) + (False,) * (rounds - 2))
    # candidate B: graduated non-convexity, progressively tightening Huber
    # widths from the same prediction; it escapes secondary minima a few cm
    # from the truth, which have the higher final robust cost
    gnc = ((25.0, 9.0, 3.0) + (1.0,) * max(rounds - 3, 0))[:rounds]
    Rb, tb = schedule(gnc, (True,) * rounds)

    cost_a = total_cost(Ra, ta, valid, True)
    cost_b = total_cost(Rb, tb, valid, True)
    pick_b = (cost_b < cost_a) & torch.isfinite(tb).all()
    R = torch.where(pick_b, Rb, Ra)
    t = torch.where(pick_b, tb, ta)

    chi2 = chi2_at(R, t)
    active = valid & (chi2 <= delta_base)
    return R, t, active, active.sum(dtype=torch.int32), chi2


def pose_lm(R0, t0, Xw, obs_uv, obs_ur, inv_sigma2, is_stereo, valid,
            cam: Pinhole, bf: float = 0.0, rounds: int = 4, iters: int = 10):
    """The robust pose LM of ``optim/pose_opt.pose_optimization`` in one
    launch: both schedules (one CTA each, in one thread-block cluster),
    their rounds and LM iterations, the pick and the final classification.

    Args:
      R0 (3,3), t0 (3,) float32: the initial pose Tcw.
      Xw (N,3), obs_uv (N,2), obs_ur (N,), inv_sigma2 (N,) float32.
      is_stereo, valid (N,) bool.
      cam: a Pinhole (its distortion is not used); bf a number.
    Returns (R, t, inliers (N,) bool, num_inliers () int32, chi2 (N,)).
    Deterministic: a fixed summation order, no atomics."""
    if not _on_cuda(R0, t0, Xw, obs_uv, obs_ur, inv_sigma2, is_stereo,
                    valid):
        return pose_lm_plain(R0, t0, Xw, obs_uv, obs_ur, inv_sigma2,
                             is_stereo, valid, cam, bf, rounds, iters)
    # the frame step passes views (a transposed rotation, slices): the
    # kernel reads packed rows, so take packed copies where needed
    R0, t0, Xw, obs_uv, obs_ur, inv_sigma2, is_stereo, valid = (
        x.contiguous() for x in (R0, t0, Xw, obs_uv, obs_ur, inv_sigma2,
                                 is_stereo, valid))
    N = Xw.shape[0]
    _check(R0, "R0", torch.float32, (3, 3))
    _check(t0, "t0", torch.float32, (3,))
    _check(Xw, "Xw", torch.float32, (N, 3))
    _check(obs_uv, "obs_uv", torch.float32, (N, 2))
    _check(obs_ur, "obs_ur", torch.float32, (N,))
    _check(inv_sigma2, "inv_sigma2", torch.float32, (N,))
    _check(is_stereo, "is_stereo", torch.bool, (N,))
    _check(valid, "valid", torch.bool, (N,))
    if N > POSE_LM_MAX_EDGES:
        raise ValueError(f"pose_lm: {N} edges exceed the kernel's "
                         f"{POSE_LM_MAX_EDGES}")
    if rounds < 0 or iters < 0:
        raise ValueError("pose_lm: rounds and iters must be >= 0")
    dev = Xw.device
    R = torch.empty((3, 3), dtype=torch.float32, device=dev)
    t = torch.empty(3, dtype=torch.float32, device=dev)
    inliers = torch.empty(N, dtype=torch.bool, device=dev)
    num_inliers = torch.empty((), dtype=torch.int32, device=dev)
    chi2 = torch.empty(N, dtype=torch.float32, device=dev)
    _launch("pose_lm", Xw.get_device(), _ptr(R0), _ptr(t0), _ptr(Xw),
            _ptr(obs_uv), _ptr(obs_ur), _ptr(inv_sigma2), _ptr(is_stereo),
            _ptr(valid), _ptr(R), _ptr(t), _ptr(inliers), _ptr(num_inliers),
            _ptr(chi2), N, int(rounds), int(iters), float(cam.fx),
            float(cam.fy), float(cam.cx), float(cam.cy), float(bf))
    pose_lm.launches += 1
    return R, t, inliers, num_inliers, chi2


pose_lm.launches = 0


# ---------------------------------------------------------------------------
# 6. local_ba: the BA solver (robust LM + PCG over cameras and points)

def local_ba_plain(prob, cam: Pinhole, bf: float = 0.0,
                   stage_iters=(5, 10), cg_iters: int = 40,
                   huber: bool = True):
    """Plain version: ``optim/local_ba.bundle_adjust_plain``, ~80 tensor
    ops per CG step (segment sums in the plan's order on the card,
    ``index_add_`` on the CPU). Returns (R, t, X, inlier, chi2)."""
    from ..optim import local_ba  # local_ba imports this module

    return tuple(local_ba.bundle_adjust_plain(prob, cam, bf, stage_iters,
                                              cg_iters, huber))


def local_ba_launches(stage_iters, cg_iters: int) -> int:
    """Kernel launches of one solve: one persistent cooperative launch,
    whatever the stages and CG steps."""
    return 1


def local_ba(prob, cam: Pinhole, bf: float = 0.0, stage_iters=(5, 10),
             cg_iters: int = 40, huber: bool = True):
    """The two-stage robust LM of ``optim/local_ba.bundle_adjust`` as one
    cooperative launch of ``csrc/local_ba.cu``'s persistent kernel (its
    phases separated by grid barriers).

    Args:
      prob: an ``optim/local_ba.BAProblem`` (C cameras, P points, O
        observations) with its ``SegmentPlan`` (required on the card).
      cam: a Pinhole (its distortion is not used); bf, a number.
    Returns (R (C,3,3), t (C,3), X (P,3), inlier (O,) bool, chi2 (O,)).
    Deterministic: fixed summation orders, no atomics. The observations'
    camera and point indices are trusted (no host read to check them)."""
    fields = (prob.R, prob.t, prob.fixed, prob.cam_valid, prob.X,
              prob.p_valid, prob.obs_cam, prob.obs_pt, prob.uv, prob.ur,
              prob.stereo, prob.valid, prob.inv_sigma2)
    if not _on_cuda(*fields):
        return local_ba_plain(prob, cam, bf, stage_iters, cg_iters, huber)
    if prob.plan is None:
        raise ValueError("local_ba on the card needs the problem's "
                         "SegmentPlan (optim/local_ba.segment_plan)")
    # the plan's chunk width is kChunk in csrc/local_ba.cu
    from ..optim.local_ba import SEGMENT_CHUNK  # local_ba imports this module

    _on_cuda(*fields, *prob.plan)  # the plan on the same card, or raise
    (R, t, fixed, cam_valid, X, p_valid, obs_cam, obs_pt, uv, ur, stereo,
     valid, isig) = (x.contiguous() for x in fields)
    cam_rows, cam_chunks, pt_rows = (x.contiguous() for x in prob.plan)
    C, P, O = R.shape[0], X.shape[0], obs_cam.shape[0]
    NCH, NW, PW = cam_rows.shape[0], cam_chunks.shape[1], pt_rows.shape[1]
    f32, b8, i32, i64 = torch.float32, torch.bool, torch.int32, torch.int64
    for x, name, dtype, shape in (
            (R, "R", f32, (C, 3, 3)), (t, "t", f32, (C, 3)),
            (fixed, "fixed", b8, (C,)), (cam_valid, "cam_valid", b8, (C,)),
            (X, "X", f32, (P, 3)), (p_valid, "p_valid", b8, (P,)),
            (obs_cam, "obs_cam", i32, (O,)), (obs_pt, "obs_pt", i32, (O,)),
            (uv, "uv", f32, (O, 2)), (ur, "ur", f32, (O,)),
            (stereo, "stereo", b8, (O,)), (valid, "valid", b8, (O,)),
            (isig, "inv_sigma2", f32, (O,)),
            (cam_rows, "plan.cam_rows", i64, (NCH, SEGMENT_CHUNK)),
            (cam_chunks, "plan.cam_chunks", i64, (C, NW)),
            (pt_rows, "plan.pt_rows", i64, (P, PW))):
        _check(x, name, dtype, shape)
    if min(C, P, O, NCH, NW, PW) < 1:
        raise ValueError("local_ba: empty problem")
    iters1, iters2 = (int(n) for n in stage_iters)
    if min(iters1, iters2, int(cg_iters)) < 0:
        raise ValueError("local_ba: stage_iters and cg_iters must be >= 0")
    dev = X.device
    n_scratch = _entry("local_ba_scratch_floats")(C, P, O, NCH, PW,
                                                   max(iters1, iters2))
    R_out = torch.empty((C, 3, 3), dtype=f32, device=dev)
    t_out = torch.empty((C, 3), dtype=f32, device=dev)
    X_out = torch.empty((P, 3), dtype=f32, device=dev)
    inlier = torch.empty(O, dtype=b8, device=dev)
    chi2 = torch.empty(O, dtype=f32, device=dev)
    scratch = torch.empty(n_scratch, dtype=f32, device=dev)
    n = ctypes.c_int(0)
    try:
        _launch("local_ba", X.get_device(), *(_ptr(x) for x in (
            R, t, fixed, cam_valid, X, p_valid, obs_cam, obs_pt, uv, ur,
            stereo, valid, isig, cam_rows, cam_chunks, pt_rows, R_out, t_out,
            X_out, inlier, chi2, scratch)),
            C, P, O, NCH, NW, PW, iters1, iters2, int(cg_iters), int(huber),
            float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
            float(bf), ctypes.addressof(n))
    finally:
        local_ba.launches += n.value
    return R_out, t_out, X_out, inlier, chi2


local_ba.launches = 0


# ---------------------------------------------------------------------------
# 7. orb_fast: the pyramid, FAST-9 at two thresholds, suppression, border

ORB_MAX_LEVELS = 8
# orb_fast's output tile (TW, TH), csrc/orb_fast.cu's: of 32x16, 64x16 and
# 64x32 the fastest by graph replay on a 640x480 frame (PERF.md)
ORB_FAST_TILE = (32, 16)
_ORB_HALO = 4  # 3 for the FAST circle, 1 for the suppression
_ORB_MAX_TAPS = 16
# (n_in, n_out) -> one resize axis as the kernel takes it, in numpy; the
# same with the device, on it; (H0, W0, sizes, device) -> the level
# geometry's tables
_orb_axes: dict = {}
_orb_axes_dev: dict = {}
_orb_tables: dict = {}


def _pointers(tensors):
    """A host array of the tensors' device pointers (kept alive by the
    caller until the launch returns)."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _ints(values):
    return (ctypes.c_int * len(values))(*(int(v) for v in values))


def orb_axis_arrays(n_in: int, n_out: int):
    """One axis of ``image.resize_bilinear`` from ``n_in`` to ``n_out`` as
    ``orb_fast`` takes it, in numpy: per output the first input index of
    its nonzero taps and their count ((n_out,) int32) and the weights
    ((n_out, T) float32, the nonzero ones first). These are
    ``image._taps``' tables, whose nonzero taps are consecutive inputs in
    increasing order and whose zero-weight padding leaves a tap chain's
    sum as it is; a table of another shape raises."""
    key = (n_in, n_out)
    t = _orb_axes.get(key)
    if t is None:
        idx, wt = (a.numpy() for a in image._taps(n_in, n_out, "cpu"))
        nz = wt != 0
        count = nz.sum(1)
        ok = bool((count >= 1).all()) and wt.shape[1] <= _ORB_MAX_TAPS
        for j in range(n_out):
            c = count[j]
            ok = ok and bool(nz[j, :c].all()) and bool(
                (idx[j, :c] == idx[j, 0] + np.arange(c)).all())
        if not ok:
            raise ValueError(f"orb_fast: the resize {n_in} -> {n_out} has "
                             "taps the kernel does not take")
        t = _orb_axes[key] = (idx[:, 0].astype(np.int32),
                              count.astype(np.int32), wt.astype(np.float32))
    return t


def orb_axis_taps(n_in: int, n_out: int, device):
    """``orb_axis_arrays`` on ``device``, cached: the first call, outside
    any graph capture, makes them."""
    key = (n_in, n_out, str(device))
    t = _orb_axes_dev.get(key)
    if t is None:
        t = _orb_axes_dev[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in orb_axis_arrays(n_in, n_out))
    return t


def orb_tile_span(n_in: int, n_out: int, tile: int, start, count) -> int:
    """The most inputs along one axis that the taps of a tile's halo rows
    (or columns) cover, over the tiles of a level ``n_out`` long, each
    ``tile`` long from 0: halo index o - 4 + i (i < tile + 8) is level
    index o - 4 + i - k n_out in [0, n_out) with its taps moved by k n_in
    (the kernel's unwrapped input space). ``start``, ``count``: numpy."""
    most = 0
    for o in range(0, n_out, tile):
        u = np.arange(o - _ORB_HALO, o + tile + _ORB_HALO)
        x = u % n_out
        su = start[x] + (u - x) // n_out * n_in
        most = max(most, int((su + count[x] - 1).max() - su.min() + 1))
    return most


def orb_fast_tables(H0: int, W0: int, sizes, device):
    """What ``orb_fast`` hands its kernel for one level geometry: per level
    its axis order (``image.resize_bilinear``'s: H first unless W first
    is cheaper) and, above level 0, its row and column taps
    (``orb_axis_taps``); and the work area in floats (a tile's input
    region over the widest row and column spans and the resize's
    intermediate after it, at least the score ring). Cached per (H0, W0,
    sizes, device)."""
    key = (H0, W0, tuple(sizes), str(device))
    t = _orb_tables.get(key)
    if t is not None:
        return t
    TW, TH = ORB_FAST_TILE
    PH, PW = TH + 2 * _ORB_HALO, TW + 2 * _ORB_HALO
    work = 2 * (TH + 2) * (TW + 2)
    levels = []
    for lvl, (h, w) in enumerate(sizes):
        if lvl == 0:
            levels.append((True, None, None))
            continue
        h_first = image.resize_h_first(H0, W0, h, w)
        rows = orb_axis_taps(H0, h, device)
        cols = orb_axis_taps(W0, w, device)
        nr = orb_tile_span(H0, h, TH, *orb_axis_arrays(H0, h)[:2])
        nc = orb_tile_span(W0, w, TW, *orb_axis_arrays(W0, w)[:2])
        work = max(work, nr * nc + (PH * nc if h_first else nr * PW))
        levels.append((h_first, rows, cols))
    t = _orb_tables[key] = (levels, work)
    return t


def level_views(levels, sizes):
    """The (h, w) views of the flat level buffer ``orb_fast`` returns."""
    out, at = [], 0
    for h, w in sizes:
        out.append(levels[at:at + h * w].view(h, w))
        at += h * w
    return out


def orb_fast_plain(img0, sizes, ini_thr: float, min_thr: float, edge: int):
    """Plain version: each level by ``models/orb._level_image``
    (``image.resize_bilinear``, a kernel a tap per axis), then
    ``models/orb.fast_score_maps`` (the circle as one stacked tensor, its
    sum in circle order), ``nms3_mask`` and the border mask, level by
    level."""
    from ..models import orb  # orb imports this module

    levels = [orb._level_image(img0, lvl, h, w)
              for lvl, (h, w) in enumerate(sizes)]
    scores, masked, counts = [], [], []
    for x in levels:
        h, w = x.shape
        s = orb.fast_score_maps(x, (ini_thr, min_thr))
        yy = torch.arange(h, device=x.device)[:, None]
        xx = torch.arange(w, device=x.device)[None, :]
        inb = (yy >= edge) & (yy < h - edge) & (xx >= edge) & (xx < w - edge)
        m = orb.nms3_mask(s) & inb
        scores.append(s)
        masked.append(torch.where(m, s, -1.0))
        counts.append(m[0].sum(dtype=torch.int32))
    flat = torch.cat([x.reshape(-1) for x in levels])
    return flat, scores, masked, torch.stack(counts)


def orb_fast(img0, sizes, ini_thr: float, min_thr: float, edge: int):
    """The ORB pyramid and, on every level, the FAST-9 corner scores at the
    initial and the minimum threshold and their 3x3 local maxima above 0
    inside the border, in one launch from the level-0 image.

    Args:
      img0: (H0, W0) float32 in [0, 255], the level-0 image.
      sizes: 1..8 level sizes (h, w), the first (H0, W0); level l >= 1 is
        ``image.resize_bilinear(img0, (h, w))`` bit for bit. Circle pixels
        wrap around the level (the JAX package's ``jnp.roll``), the
        suppression window does not.
      ini_thr, min_thr: the two FAST thresholds; edge: the border width.
    Returns (levels, scores, masked, counts): the level images as one flat
    float32 buffer, level after level (``level_views`` cuts it); per level
    the (2, h, w) score maps ([0] the initial, [1] the minimum threshold; 0
    off corners) and the same maps with -1 off the survivors; and (L,)
    int32 survivors at the initial threshold per level."""
    if not _on_cuda(img0):
        return orb_fast_plain(img0, sizes, ini_thr, min_thr, edge)
    L = len(sizes)
    if not 1 <= L <= ORB_MAX_LEVELS:
        raise ValueError(f"orb_fast: 1 to {ORB_MAX_LEVELS} levels, got {L}")
    if img0.dim() != 2 or min(img0.shape) < 1:
        raise ValueError(f"orb_fast: img0 must be a non-empty (h, w) image, "
                         f"got {tuple(img0.shape)}")
    _check(img0, "img0", torch.float32, img0.shape)
    H0, W0 = img0.shape
    sizes = [(int(h), int(w)) for h, w in sizes]
    if sizes[0] != (H0, W0) or min(min(s) for s in sizes) < 1:
        raise ValueError(f"orb_fast: level 0 must be img0's size and every "
                         f"level non-empty, got {sizes}")
    dev = img0.device
    tables, work = orb_fast_tables(H0, W0, sizes, dev)
    n_px = sum(h * w for h, w in sizes)
    levels = torch.empty(n_px, dtype=torch.float32, device=dev)
    maps = torch.empty(4 * n_px, dtype=torch.float32, device=dev)
    counts = torch.zeros(L, dtype=torch.int32, device=dev)
    scores, masked, ptrs, taps, at = [], [], [], [], 0
    views = level_views(levels, sizes)
    for (h, w), view, (_, rows, cols) in zip(sizes, views, tables):
        scores.append(maps[4 * at:4 * at + 2 * h * w].view(2, h, w))
        masked.append(maps[4 * at + 2 * h * w:4 * (at + h * w)].view(2, h, w))
        at += h * w
        ptrs += [view, scores[-1], masked[-1]]
        # level 0 takes no taps: its six table pointers are placeholders
        ptrs += [*rows, *cols] if rows is not None else [view] * 6
        taps += ([rows[2].shape[1], cols[2].shape[1]] if rows is not None
                 else [0, 0])
    ptr_arr = _pointers(ptrs)
    hw = _ints([v for s in sizes for v in s])
    h_first = _ints([f for f, _, _ in tables])
    tap_arr = _ints(taps)
    _launch("orb_fast", img0.get_device(), _ptr(img0), H0, W0, L,
            ctypes.addressof(hw), ctypes.addressof(h_first),
            ctypes.addressof(ptr_arr), ctypes.addressof(tap_arr),
            _ptr(counts), float(ini_thr), float(min_thr), int(edge), work)
    orb_fast.launches += 1
    return levels, scores, masked, counts


orb_fast.launches = 0


# ---------------------------------------------------------------------------
# 8. orb_describe: moments, angle, the blur at the samples and rotated BRIEF

_gauss_weights: list = []


def orb_describe_plain(levels, kpts, valid):
    """Plain version: ``models/orb.orientation_maps`` (two 31x31
    convolutions over the level), ``blur7`` (a float64 convolution rounded
    to float32) and ``describe`` (the gathers of ``models/orb``'s pattern),
    level by level."""
    from ..models import orb  # orb imports this module

    outs = []
    for x, k, v in zip(levels, kpts, valid):
        m10, m01 = orb.orientation_maps(x)
        outs.append(orb.describe(orb.blur7(x), m10, m01, k, v))
    return outs


def orb_describe(levels, kpts, valid):
    """Oriented BRIEF at the keypoints of every pyramid level in one launch
    from the level images: the intensity-centroid moments on the radius-15
    disc at each keypoint's integer position (zero outside the level), the
    angle, and ``models/orb``'s 256 rotated pattern pairs, each point's
    value the 7x7 Gaussian blur there (``models/orb.blur7``: summed in
    float64, rounded once to float32; the kernel orders most pairs by a
    float32 blur whose error it bounds, see ``csrc/orb_describe.cu``).

    Args:
      levels: per level (h, w) float32, the level image (e.g.
        ``level_views`` of ``orb_fast``'s buffer).
      kpts: per level (n, 2) float32 (x, y) level coordinates; valid: per
        level (n,) bool.
    Returns per level (desc (n, 256) float32 0/1 times valid, angle (n,)
    radians)."""
    from ..models import orb  # orb imports this module

    if not _on_cuda(*levels, *kpts, *valid):
        return orb_describe_plain(levels, kpts, valid)
    L = len(levels)
    if not 1 <= L <= ORB_MAX_LEVELS or not len(kpts) == len(valid) == L:
        raise ValueError(f"orb_describe: 1 to {ORB_MAX_LEVELS} levels, each "
                         "with its keypoints and flags")
    dev = levels[0].device
    descs, angles = [], []
    for i, (x, k, v) in enumerate(zip(levels, kpts, valid)):
        if x.dim() != 2 or min(x.shape) < 1:
            raise ValueError(f"orb_describe: level {i} must be a non-empty "
                             f"(h, w) image, got {tuple(x.shape)}")
        n = k.shape[0]
        _check(x, f"levels[{i}]", torch.float32, x.shape)
        _check(k, f"kpts[{i}]", torch.float32, (n, 2))
        _check(v, f"valid[{i}]", torch.bool, (n,))
        descs.append(torch.empty((n, 256), dtype=torch.float32, device=dev))
        angles.append(torch.empty(n, dtype=torch.float32, device=dev))
    if not _gauss_weights:
        _gauss_weights.append((ctypes.c_float * 49)(
            *orb._gauss_kernel7().reshape(-1).tolist()))
    pattern = orb._constant("pattern", dev,
                            lambda: orb._PATTERN.astype(np.float32))
    ptrs = [_pointers(t) for t in (levels, kpts, valid, descs, angles)]
    hs, ws, ns = (_ints(v) for v in ([x.shape[0] for x in levels],
                                     [x.shape[1] for x in levels],
                                     [k.shape[0] for k in kpts]))
    _launch("orb_describe", levels[0].get_device(),
            *(ctypes.addressof(p) for p in ptrs), ctypes.addressof(hs),
            ctypes.addressof(ws), ctypes.addressof(ns), L, _ptr(pattern),
            ctypes.addressof(_gauss_weights[0]))
    if sum(k.shape[0] for k in kpts):
        orb_describe.launches += 1
    return list(zip(descs, angles))


orb_describe.launches = 0


# ---------------------------------------------------------------------------
# 9. xfeat_stem: the network's full-resolution stem

# (cin, cout, kernel size) of the stem's convs: block1's four, the skip
_STEM_CONVS = ((1, 4, 3), (4, 8, 3), (8, 8, 3), (8, 24, 3), (1, 24, 1))


def xfeat_stem_plain(x, block1, skip1_conv, dt=torch.float32):
    """Plain version: ``models/xfeat.stem_plain``, the stem op by op in
    ``compute_dtype`` ``dt``."""
    from ..models import xfeat  # xfeat imports this module

    return xfeat.stem_plain(x, block1, skip1_conv, dt)


def xfeat_stem(x, block1, skip1_conv):
    """The network's stem in float32: the per-frame instance norm, then
    ``block1``'s four conv + bias + ReLU plus the skip branch (4x4 average
    pool, ``skip1_conv``), and the space-to-depth (``unfold2d(., 8)``) of
    the normalized frame. Two launches: the frames' statistics, then the
    stem, with no intermediate map in device memory.

    Args:
      x: (B, H, W, 1) float32 gray frames, H and W multiples of 32.
      block1: the four ``nn.Conv2d`` of ``XFeat.block1``; skip1_conv its
        1x1 skip conv; float32 weights in any memory format.
    Returns ``block2``'s input (B, 24, H/4, W/4), a channels-last view, and
    the keypoint head's input (B, 64, H/8, W/8), contiguous, in the memory
    formats ``xfeat_stem_plain`` gives them on a card."""
    convs = (*block1, skip1_conv)
    params = [p for c in convs for p in (c.weight, c.bias)]
    if not _on_cuda(x, *params):
        raise ValueError("xfeat_stem runs on a CUDA device; elsewhere the "
                         "stem is xfeat_stem_plain")
    B, H, W, _ = x.shape
    _check(x, "x", torch.float32, (B, H, W, 1))
    if H < 32 or W < 32 or H % 32 or W % 32:
        raise ValueError(f"xfeat_stem: H and W must be multiples of 32, got "
                         f"{H}x{W}")
    for i, (c, (cin, cout, ks)) in enumerate(zip(convs, _STEM_CONVS)):
        _check(c.bias, f"stem conv {i} bias", torch.float32, (cout,))
        if c.weight.dtype != torch.float32 or tuple(c.weight.shape) != (
                cout, cin, ks, ks):
            raise ValueError(f"stem conv {i}: expected a float32 "
                             f"({cout}, {cin}, {ks}, {ks}) weight, got "
                             f"{c.weight.dtype} {tuple(c.weight.shape)}")
    chunk = ctypes.c_int()
    S = _entry("xfeat_stem_chunks")(B, H * W, ctypes.addressof(chunk))
    dev = x.device
    part = torch.empty((B, S, 2), dtype=torch.float64, device=dev)
    out = torch.empty((B, H // 4, W // 4, 24), dtype=torch.float32, device=dev)
    unf = torch.empty((B, 64, H // 8, W // 8), dtype=torch.float32, device=dev)
    w = (ctypes.c_void_p * 5)(*(c.weight.data_ptr() for c in convs))
    b = (ctypes.c_void_p * 5)(*(c.bias.data_ptr() for c in convs))
    strides = (ctypes.c_int * 20)(*(s for c in convs
                                    for s in c.weight.stride()))
    _launch("xfeat_stem", x.get_device(), _ptr(x), _ptr(part),
            ctypes.addressof(w), ctypes.addressof(b), ctypes.addressof(strides),
            _ptr(out), _ptr(unf), B, H, W, S, chunk.value)
    xfeat_stem.launches += 2
    return out.permute(0, 3, 1, 2), unf


xfeat_stem.launches = 0


_WRAPPERS = (detect_candidates, bilinear_desc_sample, keypoint_desc,
             mutual_nn_pairs, similarity_top2, pose_lm, local_ba, orb_fast,
             orb_describe, xfeat_stem)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {w.__name__: w.launches for w in _WRAPPERS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        w.launches = 0

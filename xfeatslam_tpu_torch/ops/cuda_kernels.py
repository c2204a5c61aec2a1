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
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

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
}
_entries: dict = {}


def _entry(fn: str):
    """The C entry point ``fn`` with its argument types declared."""
    f = _entries.get(fn)
    if f is None:
        library, argtypes = _ENTRY_POINTS[fn]
        f = getattr(_build.load(library), fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
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


_WRAPPERS = (detect_candidates, bilinear_desc_sample, keypoint_desc,
             mutual_nn_pairs, similarity_top2)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {w.__name__: w.launches for w in _WRAPPERS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        w.launches = 0

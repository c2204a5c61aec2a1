"""Whether what the timed path returned is correct: the program's answers
for a batch of frames, judged against the plain reference's dense maps and
descriptors for the same frames.

The selection is discrete (NMS, top-K, matches), and float32 sums taken in
another order move a decision where two candidates lie within rounding of
each other. So each answer is held to the reference's numbers by the
margin by which it is wrong, as a served token is held to the reference's
logits: a sound answer is wrong by rounding at most, a planted fault or a
lower precision by far more. The numbers, each the widest over the batch:

- ``nms_gap``: how far a returned keypoint's probability lies below the
  largest of its 5x5 window, or below the threshold;
- ``pos_gap_px``: how far a returned keypoint lies from its pixel plus the
  reference's sub-pixel offset, rescaled to the frame (the program
  quantizes the offset to 1/255 px);
- ``score_gap``: |returned score - the reference's score at that pixel|;
- ``rank_gap``: how far a survivor the program left out scores above the
  lowest it kept (above 0 when fewer than K are kept), taken as the least
  of that excess, its margin over the threshold and its margin over its
  window;
- ``desc_gap``: the largest element of |returned descriptor - the
  reference's descriptor at the returned keypoint|;
- ``match_gap``: in distance units, how far a returned match breaks the
  mutual-nearest, distance and ratio tests on the reference's distances,
  or how surely the reference would match a row left unmatched;
- ``bad_slots``: answers wrong whatever the rounding (a valid flag that
  disagrees with its score, an invalid slot with a descriptor or a match,
  a keypoint returned twice or outside the frame, a match to an invalid
  column).
"""

from __future__ import annotations

import torch

from .reference import xfeat as ref

INF = float("inf")


def _frame_checks(m: ref.Maps, kpts, valid, scores, scale, subpixel: bool,
                  K: int):
    """The keypoint numbers of one block: kpts (b, K, 2) in frame pixels,
    valid (b, K), scores (b, K) or None. Returns the numbers and each
    valid keypoint's position in network pixels."""
    b, H, W = m.p.shape
    dev = m.p.device
    sx, sy = scale
    num = {"nms_gap": 0.0, "pos_gap_px": 0.0, "rank_gap": 0.0,
           "bad_slots": 0}
    if scores is not None:
        num["score_gap"] = 0.0
    fi, si = torch.nonzero(valid, as_tuple=True)
    kp = kpts[fi, si].double()
    k_net = torch.stack([kp[:, 0] / sx, kp[:, 1] / sy], -1)
    base = torch.round(k_net).long()
    best_key = torch.full((len(fi),), INF, dtype=torch.float64, device=dev)
    pos = torch.full_like(best_key, INF)
    gap = torch.full_like(best_key, INF)
    cx = torch.zeros(len(fi), dtype=torch.long, device=dev)
    cy = torch.zeros_like(cx)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            x = (base[:, 0] + dx).clamp(0, W - 1)
            y = (base[:, 1] + dy).clamp(0, H - 1)
            if subpixel:
                ox = m.offx[fi, y, x].double()
                oy = m.offy[fi, y, x].double()
            else:
                ox = oy = torch.zeros_like(k_net[:, 0])
            pg = torch.maximum((kp[:, 0] - (x + ox) * sx).abs(),
                               (kp[:, 1] - (y + oy) * sy).abs())
            p = m.p[fi, y, x].double()
            ng = torch.clamp(torch.maximum(m.nmax[fi, y, x].double() - p,
                                           m.threshold - p), min=0.0)
            # a candidate that sits where the keypoint says comes first,
            # then the one closest to a survivor
            key = torch.where(pg <= 0.02, ng, 1e3 + pg)
            take = key < best_key
            best_key = torch.where(take, key, best_key)
            pos = torch.where(take, pg, pos)
            gap = torch.where(take, ng, gap)
            cx = torch.where(take, x, cx)
            cy = torch.where(take, y, cy)
    if len(fi):
        num["pos_gap_px"] = float(pos.max())
        num["nms_gap"] = float(gap.max())
        if scores is not None:
            num["score_gap"] = float((scores[fi, si].double()
                                      - m.score[fi, cy, cx].double())
                                     .abs().max())
    # each pixel at most once, never on the last row or column (score 0)
    sel = torch.zeros_like(m.keep)
    flat = (fi * H + cy) * W + cx
    num["bad_slots"] += int(len(flat) - len(torch.unique(flat)))
    num["bad_slots"] += int(((cx == W - 1) | (cy == H - 1)).sum())
    sel.view(-1)[flat] = True
    # survivors left out
    n_kept = valid.sum(1)
    kept_min = torch.full((b,), INF, dtype=torch.float64, device=dev)
    kept_min.scatter_reduce_(0, fi, m.score[fi, cy, cx].double(), "amin")
    floor = torch.where(n_kept >= K, kept_min, torch.zeros_like(kept_min))
    left = m.keep & (m.score > 0) & ~sel
    lf, ly, lx = torch.nonzero(left, as_tuple=True)
    if len(lf):
        p = m.p[lf, ly, lx].double()
        slack = torch.minimum(
            torch.minimum(m.score[lf, ly, lx].double() - floor[lf],
                          p - m.threshold),
            p - m.nmax[lf, ly, lx].double())
        num["rank_gap"] = max(0.0, float(slack.max()))
    return num, fi, si, k_net


def _match_checks(desc, valid, idx, mask, dist, max_dist, ratio):
    """Match numbers of all consecutive pairs: desc (B, K, 64) the
    reference's descriptors at the returned keypoints, valid (B, K) the
    returned flags, idx / mask / dist (B-1, K) the returned matches."""
    gapv, bad = 0.0, 0
    K = desc.shape[1]
    dev = desc.device
    rows = torch.arange(K, device=dev)
    for s in range(0, desc.shape[0] - 1, 16):
        e = min(s + 16, desc.shape[0] - 1)
        d = ref.distances(desc[s:e], desc[s + 1:e + 1]).double()
        va, vb = valid[s:e], valid[s + 1:e + 1]
        d = d.masked_fill(~vb[:, None, :], INF).masked_fill(
            ~va[:, :, None], INF)
        mi, mm = idx[s:e].long(), mask[s:e]
        # structure: matches only from valid rows to valid columns; -1
        # exactly where unmatched
        j = mi.clamp(0, K - 1)
        bad += int((mm & ((mi < 0) | ~va | ~torch.gather(vb, 1, j))).sum())
        bad += int((~mm & (mi != -1)).sum())
        best, j0 = d.min(dim=2)
        col_best, i0 = d.min(dim=1)
        col_second = d.scatter(1, i0[:, None, :], INF).amin(dim=1)
        dij = torch.gather(d, 2, j[..., None])[..., 0]
        second_j = d.scatter(2, j[..., None], INF).amin(dim=2)
        viol = torch.stack([dij - best,
                            dij - torch.gather(col_best, 1, j),
                            dij - max_dist,
                            dij - ratio * second_j], -1).amax(-1)
        if dist is not None:
            viol = torch.maximum(viol, (dist[s:e].double() - dij).abs())
        ok = mm & va & (mi >= 0) & torch.gather(vb, 1, j)
        if ok.any():
            gapv = max(gapv, float(viol[ok].max()))
        # rows left unmatched that the reference would match surely
        second = d.scatter(2, j0[..., None], INF).amin(dim=2)
        others = torch.where(torch.gather(i0, 1, j0) == rows,
                             torch.gather(col_second, 1, j0),
                             torch.gather(col_best, 1, j0))
        slack = torch.stack([max_dist - best, ratio * second - best,
                             others - best], -1).amin(-1)
        un = ~mm & va & torch.isfinite(best)
        if un.any():
            gapv = max(gapv, float(slack[un].max().clamp(min=0.0)))
    return gapv, bad


@torch.no_grad()
def judge(net: ref.Network, frames_u8, out, cfg, block: int = 32):
    """The numbers of one batch: ``frames_u8`` (B, H, W, 1) uint8 on the
    device the reference runs on, ``out`` the program's answers (any
    device): kpts, desc, valid, match_idx, match_mask, and scores and
    match_dist where the entry returns them."""
    ex, mc = cfg["extractor"], cfg["matcher"]
    dev = frames_u8.device
    o = {k: v.to(dev) for k, v in out.items()}
    B, H, W, _ = frames_u8.shape
    H32, W32 = ref.net_size((H, W))
    K = o["kpts"].shape[1]
    if (o["kpts"].shape != (B, K, 2) or o["desc"].shape != (B, K, 64)
            or o["match_idx"].shape != (B - 1, K)):
        raise ValueError("the program's answers have the wrong shapes: "
                         + ", ".join(f"{k} {tuple(v.shape)}"
                                     for k, v in o.items()))
    valid = o["valid"].bool()
    scores = o.get("scores")
    num = {"nms_gap": 0.0, "pos_gap_px": 0.0, "rank_gap": 0.0,
           "desc_gap": 0.0, "bad_slots": 0}
    if scores is not None:
        num["score_gap"] = 0.0
        num["bad_slots"] += int((valid != (scores > 0)).sum())
    inval = ~valid
    num["bad_slots"] += int((o["desc"][inval] != 0).any(-1).sum())
    ref_desc = torch.zeros((B, K, 64), dtype=torch.float32, device=dev)
    for s in range(0, B, block):
        e = min(s + block, B)
        m = ref.maps(net, frames_u8[s:e], ex["threshold"])
        n, fi, si, k_net = _frame_checks(
            m, o["kpts"][s:e], valid[s:e],
            None if scores is None else scores[s:e], (W / W32, H / H32),
            ex["subpixel"], K)
        for k, v in n.items():
            num[k] = num[k] + v if k == "bad_slots" else max(num[k], v)
        kn = torch.zeros((e - s, K, 2), dtype=torch.float32, device=dev)
        kn[fi, si] = k_net.float()
        ref_desc[s:e] = m.descriptors(kn, valid[s:e])
        del m
    d = (o["desc"] - ref_desc).abs().amax(-1)
    if valid.any():
        num["desc_gap"] = float(d[valid].max())
    gap, bad = _match_checks(ref_desc, valid, o["match_idx"],
                             o["match_mask"].bool(), o.get("match_dist"),
                             mc["max_dist"], mc["ratio"])
    num["match_gap"] = gap
    num["bad_slots"] += bad
    num["kpts_per_frame"] = float(valid.sum()) / B
    num["matches_per_pair"] = float(o["match_mask"].sum()) / max(B - 1, 1)
    return num

"""LoopClosing: place recognition, Sim3 verification, loop correction, map
merging, and the global bundle adjustment after a loop.

Counterpart of ``xfeatslam_tpu/slam/loop_closing.py`` (the role of
ORB-SLAM3's LoopClosing.cc): per new keyframe, query
the retrieval index for candidates, verify them geometrically (descriptor
matching, Sim3 RANSAC, Sim3 refinement, SearchBySim3, Sim3-guided
projection counts, temporal consistency), then correct the loop (carry
the current keyframe's covisible group by the corrected Sim3, fuse the
duplicate landmarks, optimize the essential graph, refresh the map with a
global BA). A candidate in another atlas map welds the two maps.

The host logic is numpy; the matching, the Sim3 solvers, the pose graph and
the BA run as the port's torch ops on ``device``. On the card the global BA
runs by replay of a ``LocalBAGraph`` with a ``SegmentPlan`` (problems are
padded to power-of-two buckets, so a few graphs serve every map size), and
every result is read to the host through ``track_step.fetch``. The RANSAC
draws come from ``torch.multinomial`` with a generator seeded by the
keyframe id (``kid + 7777`` for merges), where the JAX package seeds a JAX
PRNG key the same way (``_minimal_sets``). On an IMU-initialized map the
essential graph is the 4-DoF one (yaw and translation,
``optimize_pose_graph(mode="4dof")``). A weld that involves an inertial
map carries the moved map's velocities (rotated and scaled by the weld's
Sim3) and its IMU chain links into the old map, settles the IMU flags and
biases, and, when the welded map is IMU-initialized, runs the welding
inertial BA hook (``welding_iba``, which the System wires to
``LocalMapping.merge_inertial_ba``) in place of the global BA.

``_search_by_sim3`` keys its mutual map by the kf1 slot as the JAX package
does (ROADMAP trap T.3): kept for parity.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import lie, matching
from ..optim import local_ba as ba_mod
from ..optim import pose_graph as pg
from ..optim import sim3 as sim3_mod
from ..optim.track_step import fetch
from ..utils.verbose import Level, print_mess
from .retrieval import Retrieval, global_desc_dim

PAIR_BUCKET = 512  # padded matched map-point pairs for Sim3 verification
RANSAC_ITERS = 128


def _bucket(n: int, lo: int = 8) -> int:
    """Round n up to a power of two (>= lo), so padded problems come in a
    bounded set of shapes (and of captured BA graphs on the card)."""
    return max(lo, 1 << max(0, int(n) - 1).bit_length())


def _cpu(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _sim3_inv(s, R, t):
    """The inverse of one Sim3, in float32 (numpy in, numpy out)."""
    s_, R_, t_ = lie.sim3_inverse(_cpu(s), _cpu(R), _cpu(t))
    return float(s_), R_.numpy(), t_.numpy()


def _sim3_mul(a, b):
    """a o b for two Sim3 triples, in float32 (numpy in, numpy out)."""
    s_, R_, t_ = lie.sim3_compose(*map(_cpu, a), *map(_cpu, b))
    return float(s_), R_.numpy(), t_.numpy()


class LoopClosing:
    def __init__(self, slam_map, cam, bf: float = 40.0,
                 fix_scale: bool = True, confirmations: int = 3,
                 run_gba: bool = True, atlas=None,
                 proj_matches: int = 50, proj_matches_strict: int = 80,
                 device=None):
        """confirmations: consecutive temporally consistent detections
        required before correcting (the reference's default 3).
        proj_matches / proj_matches_strict: the Sim3-guided projection
        re-search gates (>= 50 wide, then >= 80 strict). device: where the
        matching, solvers and BA run: CUDA unless the caller names another
        (raises without a GPU)."""
        self.map = slam_map
        self.cam = cam
        self.bf = bf
        self.fix_scale = fix_scale  # RGB-D / stereo: scale observable
        self.confirmations = confirmations
        self.proj_matches = proj_matches
        self.proj_matches_strict = proj_matches_strict
        self.run_gba = run_gba
        self.atlas = atlas  # enables cross-map candidates -> map merging
        self.device = resolve_device(device)
        self.retrieval = Retrieval(dim=global_desc_dim(slam_map.desc_dim))

        # evict culled keyframes from the index (KeyFrameDatabase::erase):
        # without it a dead keyframe that later wins a query crashes
        # _matched_pairs
        def _evict(map_id: int, kid: int):
            self.retrieval.remove(kid, map_id)

        self._evict = _evict
        if atlas is not None:
            atlas.kf_removed_hook = _evict
            for m in atlas.maps.values():
                m.on_kf_removed = atlas._dispatch_kf_removed
        else:
            slam_map.on_kf_removed = lambda mid, kid: _evict(mid, kid)
        self.detected: List[tuple] = []  # (kid, cand) raw candidates
        self.n_sim3_extended = 0  # pairs added by SearchBySim3
        self.closed: List[tuple] = []  # (kid, cand) corrected loops
        self.merged: List[tuple] = []  # (new_map_id, old_map_id)
        # MergeInertialBA: the System wires this to
        # LocalMapping.merge_inertial_ba; called with (the welded current
        # kid, the matched old-map kid) after a merge into an inertial map
        self.welding_iba = None
        # temporal consistency: (candidate covisibility group, count, stamp)
        self._consistent: List[Tuple[set, int, int]] = []
        # budgeted GBA (the reference's detached, abortable GBA thread as
        # per-frame ticks): > 0 = after the inline robust stage, this many
        # rounds of gba_round_iters LM iterations run one per frame through
        # tick(), then apply with spanning propagation; 0 = fully inline
        self.gba_budget_rounds = 0
        self.gba_round_iters = 5
        self._gba_session = None
        self._ba_graph = (ba_mod.LocalBAGraph(self.device)
                          if self.device.type == "cuda" else None)
        # host wall seconds of each GBA solve with its stage ("first",
        # "tick" or "inline") and whether the call captured a graph
        self.ba_seconds: List[tuple] = []

    def _t(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _minimal_sets(self, valid, seed: int):
        """The (RANSAC_ITERS, 3) minimal sets of a Sim3 RANSAC, drawn from a
        generator seeded by ``seed`` (the JAX package's PRNGKey(seed)); a
        parity test replaces this with the JAX draws."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return sim3_mod.draw_minimal_sets(valid, RANSAC_ITERS, gen)

    # ------------------------------------------------------------------ main

    def process_keyframe(self, kid: int):
        kf = self.map.keyframes.get(kid)
        if kf is None:
            return
        try:
            exclude = set(self.map.covisible_kfs(kid)) | {kid}
            # temporal guard: recent keyframes are trivially similar even
            # when covisibility is sparse
            exclude |= {k for k in self.map.keyframes if abs(k - kid) <= 5}
            if self.map.num_keyframes() >= 12:
                # same-map candidates: covisibility-group accumulated
                # scoring (DetectNBestCandidates)
                for ckid, _score in self.retrieval.query_grouped(
                    kf.global_desc, exclude,
                    covisibles=self.map.covisible_kfs, top_n=3,
                    map_id=self.map.map_id,
                ):
                    self.detected.append((kid, ckid))
                    if self._verify_and_correct(kid, ckid):
                        break
            if self.atlas is not None and len(self.atlas.maps) > 1:
                for ckid, cmap, _score in self.retrieval.query(
                    kf.global_desc, exclude, top_n=3, with_map=True,
                    exclude_map_id=self.map.map_id,
                ):
                    if cmap != self.map.map_id and cmap in self.atlas.maps:
                        if self._verify_and_merge(kid, ckid, cmap):
                            break
        finally:
            # kf.kid, not the argument: a merge above rewrites the
            # keyframe's id and map in place
            self.retrieval.add(kf.kid, kf.global_desc, self.map.map_id)

    def _update_consistency(self, kid: int, ckid: int) -> int:
        """Temporal-consistency counting over covisibility groups: a
        verified candidate whose group overlaps an earlier verified group
        continues that chain."""
        group = {ckid} | set(self.map.covisible_kfs(ckid))
        best = 0
        for g, c, _stamp in self._consistent:
            if g & group:
                best = max(best, c)
        count = best + 1
        self._consistent.append((group, count, kid))
        # drop chains not refreshed within the last few keyframes
        self._consistent = [
            (g, c, s) for (g, c, s) in self._consistent if kid - s <= 3
        ]
        return count

    # ---------------------------------------------------------- verification

    def _match_slots(self, m1, kf1, m2, kf2):
        """Descriptor-match the landmark-bearing slots of two keyframes
        (the SearchByBoW role). Returns matched (slots1, slots2)."""
        b1 = kf1.mp_ids >= 0
        b2 = kf2.mp_ids >= 0
        v1 = b1 & kf1.valid & m1.points.alive[np.where(b1, kf1.mp_ids, 0)]
        v2 = b2 & kf2.valid & m2.points.alive[np.where(b2, kf2.mp_ids, 0)]
        binary = m1.desc_dim > 64
        res = matching.match_general(
            self._t(kf1.desc), self._t(v1), self._t(kf2.desc), self._t(v2),
            max_dist=(matching.ORB_TH_LOW if binary
                      else matching.TH_LOW * 6),
            ratio=0.75, binary=binary,
        )
        idx, mask = fetch((res.idx, res.mask))
        mask = matching.rotation_consistency_filter(
            kf1.angle, kf2.angle, np.clip(idx, 0, None), mask)
        slots1 = np.nonzero(mask)[0]
        return slots1, idx[slots1].astype(np.int64)

    def _matched_pairs(self, kid: int, ckid: int):
        """Matched slot pairs of the current keyframe and a candidate."""
        kf1 = self.map.keyframes.get(kid)
        kf2 = self.map.keyframes.get(ckid)
        if kf1 is None or kf2 is None:
            # candidate culled between query and verification
            empty = np.zeros(0, np.int64)
            return kf1, kf2, empty, empty
        return (kf1, kf2) + self._match_slots(self.map, kf1, self.map, kf2)

    def _sim3_pairs_arrays(self, m1, kf1, m2, kf2, slots1, slots2):
        """Camera-frame point and pixel arrays of matched slot pairs, padded
        to PAIR_BUCKET, on the device. Returns (Xc1, Xc2, uv1, uv2,
        valid)."""
        mp1 = kf1.mp_ids[slots1]
        mp2 = kf2.mp_ids[slots2]
        Xc1 = m1.points.pos[mp1] @ kf1.R.T + kf1.t
        Xc2 = m2.points.pos[mp2] @ kf2.R.T + kf2.t
        uv1 = kf1.kpts_un[slots1]
        uv2 = kf2.kpts_un[slots2]

        def pad(a, fill=0.0):
            out = np.full((PAIR_BUCKET,) + a.shape[1:], fill, np.float32)
            out[: min(len(a), PAIR_BUCKET)] = a[:PAIR_BUCKET]
            return self._t(out)

        if len(slots1) > PAIR_BUCKET:
            print_mess(f"Sim3 pair bucket cap hit: {PAIR_BUCKET} of "
                       f"{len(slots1)} matched pairs", Level.VERBOSE)
        valid = np.zeros(PAIR_BUCKET, bool)
        valid[: min(len(slots1), PAIR_BUCKET)] = True
        return pad(Xc1), pad(Xc2), pad(uv1), pad(uv2), self._t(valid)

    def _project_into(self, Xc, radius, desc, alive, kf_dst, kpt_valid,
                      max_dist, ratio):
        """Project camera-frame points ``Xc`` (numpy) into ``kf_dst`` and
        window-match them against its keypoints. Returns (idx, mask)."""
        z = Xc[:, 2]
        vis = z > 0.05
        zs = np.where(vis, z, 1.0)
        u = float(self.cam.fx) * Xc[:, 0] / zs + float(self.cam.cx)
        v = float(self.cam.fy) * Xc[:, 1] / zs + float(self.cam.cy)
        uv = np.stack([u, v], -1).astype(np.float32)
        res = matching.search_by_projection(
            self._t(uv), self._t(desc), self._t(vis & alive),
            self._t(kf_dst.kpts_un), self._t(kf_dst.desc),
            self._t(kpt_valid), radius=float(radius), max_dist=max_dist,
            ratio=ratio, binary=desc.shape[1] > 64)
        return fetch((res.idx, res.mask))

    def _search_by_sim3(self, m1, kf1, m2, kf2, slots1, slots2,
                        s12, R12, t12, radius: float = 7.5):
        """SearchBySim3: extend a pairwise match set by bidirectional
        Sim3-guided projection; each side's landmarks are projected into the
        other keyframe through the verified Sim3 and window-matched, and
        only mutually agreeing pairs are added. S12 maps kf2-camera coords
        into kf1-camera coords. Returns the extended (slots1, slots2)."""
        s12 = float(s12)
        R12 = np.asarray(R12)
        t12 = np.asarray(t12)
        binary = m1.desc_dim > 64
        max_dist = matching.ORB_TH_HIGH if binary else matching.TH_HIGH

        def landmark_slots(m, kf):
            b = kf.mp_ids >= 0
            ok = b & kf.valid & m.points.alive[np.where(b, kf.mp_ids, 0)]
            return np.nonzero(ok)[0]

        def project(m, kf_src, slots_src, kf_dst, sim3):
            s_, R_, t_ = sim3
            mps = kf_src.mp_ids[slots_src]
            Xc_src = m.points.pos[mps] @ kf_src.R.T + kf_src.t
            Xc_dst = s_ * (Xc_src @ R_.T) + t_
            return self._project_into(
                Xc_dst, radius, kf_src.desc[slots_src],
                np.ones(len(slots_src), bool), kf_dst,
                (kf_dst.mp_ids >= 0) & kf_dst.valid, max_dist, 1.0)

        sl1 = landmark_slots(m1, kf1)
        sl2 = landmark_slots(m2, kf2)
        if len(sl1) == 0 or len(sl2) == 0:
            return slots1, slots2
        s21, R21, t21 = _sim3_inv(s12, R12, t12)
        # kf1 landmarks -> kf2 image (S21), kf2 landmarks -> kf1 image (S12)
        idx12, ok12 = project(m1, kf1, sl1, kf2, (s21, R21, t21))
        idx21, ok21 = project(m2, kf2, sl2, kf1, (s12, R12, t12))
        # mutual agreement in slot space, keyed by the kf1 slot as in the
        # JAX package (ROADMAP trap T.3)
        back = -np.ones(len(kf1.mp_ids), np.int64)
        for j, slot2 in enumerate(sl2):
            if ok21[j]:
                back[idx21[j]] = slot2
        have1 = set(int(x) for x in slots1)
        have2 = set(int(x) for x in slots2)
        add1, add2 = [], []
        for i, slot1 in enumerate(sl1):
            if not ok12[i]:
                continue
            slot2 = int(idx12[i])
            if back[slot1] != slot2:
                continue
            if int(slot1) in have1 or slot2 in have2:
                continue
            add1.append(int(slot1))
            add2.append(slot2)
        if not add1:
            return slots1, slots2
        self.n_sim3_extended += len(add1)
        print_mess(f"SearchBySim3 extended {len(slots1)} -> "
                   f"{len(slots1) + len(add1)} pairs", Level.VERBOSE)
        return (np.concatenate([slots1, np.asarray(add1, slots1.dtype)]),
                np.concatenate([slots2, np.asarray(add2, slots2.dtype)]))

    def _verified_sim3(self, m1, kf1, m2, kf2, slots1, slots2, seed: int):
        """The Sim3 ladder shared by loops and merges: RANSAC (>= 15
        inliers), the refinement (>= 20), SearchBySim3 and a refinement on
        the enlarged set (>= 20). Returns (s, R, t) numpy, or None."""
        arrays = self._sim3_pairs_arrays(m1, kf1, m2, kf2, slots1, slots2)
        res = sim3_mod.sim3_ransac(
            *arrays, self.cam, idx=self._minimal_sets(arrays[4], seed),
            min_inliers=15, fix_scale=self.fix_scale)
        if not bool(res.success):
            return None
        s, R, t, _, n_inl = sim3_mod.optimize_sim3(
            res.s, res.R, res.t, *arrays, self.cam, fix_scale=self.fix_scale)
        if int(n_inl) < 20:  # the OptimizeSim3 gate
            return None
        s, R, t = fetch((s, R, t))
        ext1, ext2 = self._search_by_sim3(m1, kf1, m2, kf2, slots1, slots2,
                                          s, R, t)
        if len(ext1) > len(slots1):
            arrays = self._sim3_pairs_arrays(m1, kf1, m2, kf2, ext1, ext2)
            s, R, t, _, n_inl = sim3_mod.optimize_sim3(
                torch.tensor(float(s)).to(self.device), self._t(R),
                self._t(t), *arrays, self.cam, fix_scale=self.fix_scale)
            if int(n_inl) < 20:
                return None
            s, R, t = fetch((s, R, t))
        return float(s), np.asarray(R), np.asarray(t)

    def _verify_and_correct(self, kid: int, ckid: int) -> bool:
        kf1, kf2, slots1, slots2 = self._matched_pairs(kid, ckid)
        if len(slots1) < 20:  # the reference needs >= 20 BoW matches
            return False
        sim = self._verified_sim3(self.map, kf1, self.map, kf2, slots1,
                                  slots2, kid)
        if sim is None:
            return False
        s, R, t = sim
        # Sim3-guided projection re-search: a true loop re-finds most of
        # the old structure; a texture alias that survived the pairwise
        # gates does not
        m_wide = self._guided_proj_count(kid, ckid, s, R, t, radius=8.0)
        if m_wide < self.proj_matches:
            return False
        m_strict = self._guided_proj_count(kid, ckid, s, R, t, radius=4.0)
        if m_strict < self.proj_matches_strict:
            return False
        if self._update_consistency(kid, ckid) < self.confirmations:
            return False
        self._consistent.clear()

        self._correct_loop(kid, ckid, s, R, t)
        self.closed.append((kid, ckid))
        return True

    def _loop_window_points(self, ckid: int, n_covis=None) -> List[int]:
        """Alive map points of a keyframe and its covisibles, in order, at
        most 4096."""
        m = self.map
        mps: List[int] = []
        for k in [ckid] + m.covisible_kfs(ckid, n_covis):
            kf = m.keyframes.get(k)
            if kf is None:
                continue
            mps.extend(int(x) for x in kf.mp_ids[kf.mp_ids >= 0])
        mps = [p for p in dict.fromkeys(mps) if m.points.alive[p]]
        if len(mps) > 4096:
            print_mess(f"loop window cap hit: 4096 of {len(mps)} points",
                       Level.VERBOSE)
            mps = mps[:4096]
        return mps

    def _guided_proj_count(self, kid: int, ckid: int, s12, R12, t12,
                           radius: float) -> int:
        """Matches from projecting the loop window's map points into the
        current keyframe through the verified Sim3 (the Sim3 overload of
        SearchByProjection)."""
        m = self.map
        kf1 = m.keyframes[kid]
        mps = self._loop_window_points(ckid, 10)
        if not mps:
            return 0
        kf2 = m.keyframes[ckid]
        # corrected current-camera coords: X_c1 = S12(X_c2)
        Xc2 = m.points.pos[mps] @ kf2.R.T + kf2.t
        Xc1 = s12 * (Xc2 @ np.asarray(R12).T) + np.asarray(t12)
        binary = m.desc_dim > 64
        _, mask = self._project_into(
            Xc1, radius, m.points.desc[mps], m.points.alive[mps], kf1,
            kf1.valid,
            matching.ORB_TH_LOW if binary else matching.TH_LOW * 6, 0.9)
        return int(np.asarray(mask).sum())

    # ------------------------------------------------------------ correction

    def _correct_loop(self, kid: int, ckid: int, s12, R12, t12):
        """CorrectLoop. S12 maps candidate-keyframe camera coords into
        current-keyframe camera coords; the corrected current pose is
        S_1w = S12 * S_2w (the candidate side is trusted). The current
        keyframe's covisible group is carried rigidly by the correction,
        with its points; then the duplicates are fused, the essential graph
        optimized and (optionally) a global BA refreshes the map."""
        m = self.map
        kf1 = m.keyframes[kid]
        kf2 = m.keyframes[ckid]
        # a new confirmed loop supersedes any in-flight budgeted GBA
        self._gba_session = None

        # the corrected Sim3 of the current keyframe (world -> cam1)
        s_corr = s12 * 1.0
        R_corr = R12 @ kf2.R
        t_corr = s12 * (R12 @ kf2.t) + t12
        # S_D maps corrected-world to old-world: S_i_corr = S_i_old o S_D
        sD, RD, tD = _sim3_mul(_sim3_inv(1.0, kf1.R, kf1.t),
                               (s_corr, R_corr, t_corr))

        group = [kid] + m.covisible_kfs(kid)
        corrected_points = set()
        # the moved group's pre-correction poses: the essential graph
        # measures its edges from the uncorrected geometry (the reference's
        # NonCorrectedSim3)
        non_corrected = {}
        for gk in group:
            kf = m.keyframes.get(gk)
            if kf is None:
                continue
            non_corrected[gk] = (kf.R.copy(), kf.t.copy())
            si, Ri, ti = _sim3_mul((1.0, kf.R, kf.t), (sD, RD, tD))
            # this keyframe's points: X_corr = S_i_corr^{-1}(S_i_old(X))
            for mp in kf.mp_ids[kf.mp_ids >= 0]:
                mp = int(mp)
                if mp in corrected_points or not m.points.alive[mp]:
                    continue
                corrected_points.add(mp)
                Xc = kf.R @ m.points.pos[mp] + kf.t
                Xw = (Ri.T @ (Xc - ti)) / si
                m.points.pos[mp] = Xw.astype(np.float32)
            # the corrected SE3 pose [R | t/s]
            kf.R = lie.np_normalize_rotation(Ri)
            kf.t = (ti / si).astype(np.float32)

        kf1.loop_edges.add(ckid)
        kf2.loop_edges.add(kid)

        # loop fusion (SearchAndFuse): project the loop side's landmarks
        # into every corrected-group keyframe, replace or bind duplicates
        pre_covis = {gk: set(m.covisible_kfs(gk)) for gk in group
                     if gk in m.keyframes}
        n_fused = self._search_and_fuse(group, ckid)
        # connections that exist only after fusion are the LoopConnections:
        # the essential graph measures them from the corrected estimates
        loop_connections = set()
        if n_fused:
            gset = set(group)
            for gk, before in pre_covis.items():
                if gk not in m.keyframes:
                    continue
                for nk in m.covisible_kfs(gk):
                    if nk in gset or nk in before or nk not in m.keyframes:
                        continue
                    loop_connections.add((min(gk, nk), max(gk, nk)))
            print_mess(f"loop fusion bound {n_fused} landmark duplicates, "
                       f"{len(loop_connections)} new connections",
                       Level.VERBOSE)

        self._optimize_essential_graph(kid, ckid, s12, R12, t12,
                                       non_corrected=non_corrected,
                                       loop_connections=loop_connections)
        if self.run_gba:
            self.global_bundle_adjust()
        m.change_index += 1

    def _essential_edges(self):
        """Spanning tree, loop edges and strong covisibility (>= 100)."""
        m = self.map
        edges = set()
        for kid, kf in m.keyframes.items():
            if kf.parent >= 0 and kf.parent in m.keyframes:
                edges.add((min(kid, kf.parent), max(kid, kf.parent)))
            prev = getattr(kf, "prev_kf", None)
            if prev is not None and prev in m.keyframes:
                edges.add((min(kid, prev), max(kid, prev)))
            for lk in kf.loop_edges:
                if lk in m.keyframes:
                    edges.add((min(kid, lk), max(kid, lk)))
            for ck, w in m.covis.get(kid, {}).items():
                if w >= 100 and ck in m.keyframes:
                    edges.add((min(kid, ck), max(kid, ck)))
        return sorted(edges)

    def _optimize_essential_graph(self, kid: int, ckid: int, s12, R12, t12,
                                  non_corrected: Optional[dict] = None,
                                  loop_connections: Optional[set] = None):
        """Optimize all keyframes over the essential graph (arrays padded
        to power-of-two buckets). Edges of keyframes moved by _correct_loop
        are measured from their pre-correction poses (``non_corrected``);
        ``loop_connections`` (covisibilities created by the fusion) are
        included whatever their weight and measured from the corrected
        estimates."""
        m = self.map
        kids = sorted(m.keyframes)
        if len(kids) < 3:
            return
        non_corrected = non_corrected or {}
        loop_connections = loop_connections or set()
        index = {k: i for i, k in enumerate(kids)}
        C = _bucket(len(kids))
        edges = sorted(set(self._essential_edges()) | loop_connections)
        E = _bucket(len(edges), lo=16)

        def pose_for_meas(k):
            if k in non_corrected:
                return non_corrected[k]
            kf = m.keyframes[k]
            return kf.R, kf.t

        s0 = np.ones(C, np.float32)
        R0 = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
        t0 = np.zeros((C, 3), np.float32)
        cam_valid = np.zeros(C, bool)
        for k, i in index.items():
            kf = m.keyframes[k]
            R0[i] = kf.R
            t0[i] = kf.t
            cam_valid[i] = True
        fixed = np.zeros(C, bool)
        fixed[~cam_valid] = True
        # fix the loop-candidate side and the origin
        if ckid in index:
            fixed[index[ckid]] = True
        if m.kf_origin in index:
            fixed[index[m.kf_origin]] = True

        ei, ej, m_s, m_R, m_t = [], [], [], [], []
        loop_pair = (min(kid, ckid), max(kid, ckid))
        for (a, b) in edges:
            if a not in index or b not in index:
                continue
            if (a, b) == loop_pair:
                # measured from the verified Sim3 (S12: candidate -> current)
                if a == ckid:  # m(a->b) = S12
                    ms, mR, mt = s12, R12, t12
                else:
                    ms, mR, mt = _sim3_inv(s12, R12, t12)
            elif (a, b) in loop_connections:
                kfa, kfb = m.keyframes[a], m.keyframes[b]
                ms, mR, mt = _sim3_mul((1.0, kfb.R, kfb.t),
                                       _sim3_inv(1.0, kfa.R, kfa.t))
            else:
                # m(a->b) = S_b * S_a^{-1} from the pre-correction estimates
                Ra, ta = pose_for_meas(a)
                Rb, tb = pose_for_meas(b)
                ms, mR, mt = _sim3_mul((1.0, Rb, tb), _sim3_inv(1.0, Ra, ta))
            ei.append(index[a])
            ej.append(index[b])
            m_s.append(ms)
            m_R.append(mR)
            m_t.append(mt)
        n_e = len(ei)
        if n_e < 2:
            return

        def pad(a, n, fill=0, dtype=None):
            a = np.asarray(a, dtype)
            out = np.full((n,) + a.shape[1:], fill, a.dtype)
            out[: len(a)] = a
            return self._t(out)

        m_R_pad = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
        m_R_pad[:n_e] = np.stack(m_R)
        prob = pg.PoseGraphProblem(
            s=self._t(s0), R=self._t(R0), t=self._t(t0),
            fixed=self._t(fixed), cam_valid=self._t(cam_valid),
            edge_i=pad(ei, E, 0, np.int32), edge_j=pad(ej, E, 0, np.int32),
            m_s=pad(m_s, E, 1.0, np.float32), m_R=self._t(m_R_pad),
            m_t=pad(np.stack(m_t), E, 0.0, np.float32),
            e_valid=pad(np.ones(n_e, bool), E, False),
        )
        # an IMU-initialized map has gravity pinning roll and pitch and the
        # IMU pinning the scale: only yaw and translation move
        # (OptimizeEssentialGraph4DoF)
        mode = "4dof" if m.imu_initialized else "sim3"
        s1, R1, t1 = fetch(pg.optimize_pose_graph(prob, mode=mode))

        # apply: keyframe SE3 = [R | t/s]; points by their reference
        # keyframe's correction
        old_poses = {k: (m.keyframes[k].R.copy(), m.keyframes[k].t.copy())
                     for k in index}
        for k, i in index.items():
            kf = m.keyframes.get(k)
            if kf is None or fixed[i]:
                continue
            kf.R = lie.np_normalize_rotation(R1[i])
            kf.t = (t1[i] / max(s1[i], 1e-9)).astype(np.float32)
        for mp, obs in list(m.obs.items()):
            if not m.points.alive[mp] or not obs:
                continue
            ref_k = min(obs)  # the earliest observing keyframe
            if ref_k not in index:
                continue
            i = index[ref_k]
            if fixed[i]:
                continue
            R_o, t_o = old_poses[ref_k]
            Xc = R_o @ m.points.pos[mp] + t_o
            # X = S_new^{-1}(Xc) with S_new = [s R | t]
            Xw = R1[i].T @ (Xc - t1[i] / max(s1[i], 1e-9))
            m.points.pos[mp] = Xw.astype(np.float32)

    # ------------------------------------------------------------------- GBA

    def _solve_ba(self, prob, stage: str, stage_iters):
        """One GBA solve, read to the host: the graph's replay on the card,
        the eager solve on the CPU."""
        return ba_mod.timed_solve(self._ba_graph, prob, self.cam, self.bf,
                                  stage_iters, self.ba_seconds, stage)

    def _with_result(self, prob, res):
        return prob._replace(R=self._t(res.R), t=self._t(res.t),
                             X=self._t(res.X))

    def global_bundle_adjust(self, max_pts: int = 65536,
                             max_obs: int = 262144):
        """GlobalBundleAdjustment over the whole map with the local-BA
        solver: every keyframe takes part; points and observations are
        padded to power-of-two buckets (the caps only bound device memory,
        and hitting them is logged).

        With ``gba_budget_rounds > 0`` the robust first stage runs now, the
        remaining LM rounds one per frame through tick(), and the final
        apply carries keyframes and points created meanwhile along the
        spanning tree."""
        built = self._build_gba(max_pts, max_obs)
        if built is None:
            return
        prob, index, pt_ids, fixed, n_obs = built
        if self.gba_budget_rounds > 0:
            res = self._solve_ba(prob, "first", (10, 0))
            self._gba_session = (self._with_result(prob, res), index, pt_ids,
                                 fixed, self.gba_budget_rounds, self.map,
                                 self.map.geometry_epoch)
            return
        res = self._solve_ba(prob, "inline", (10, 10))
        self._apply_gba(res, index, pt_ids, fixed)

    def tick(self):
        """Advance the in-flight budgeted GBA session by one LM round
        (called by System on frames that inserted no keyframe). The session
        aborts when the map or its geometry epoch changed (a merge), and
        when a new loop correction starts."""
        s = self._gba_session
        if s is None:
            return
        prob, index, pt_ids, fixed, rounds_left, smap, epoch = s
        if smap is not self.map or self.map.geometry_epoch != epoch:
            self._gba_session = None
            return
        res = self._solve_ba(prob, "tick", (0, self.gba_round_iters))
        rounds_left -= 1
        if rounds_left <= 0:
            self._apply_gba(res, index, pt_ids, fixed, propagate=True)
            self._gba_session = None
        else:
            self._gba_session = (self._with_result(prob, res), index, pt_ids,
                                 fixed, rounds_left, smap, epoch)

    def flush(self):
        """Finish any in-flight budgeted GBA (System shutdown)."""
        guard = 0
        while self._gba_session is not None and guard < 64:
            self.tick()
            guard += 1

    def _build_gba(self, max_pts: int, max_obs: int):
        """Assemble the padded whole-map BA problem (with its SegmentPlan
        on the card). Returns (prob, index, pt_ids, fixed, n_obs) or
        None."""
        m = self.map
        kids = sorted(m.keyframes)
        if len(kids) < 2:
            return None
        index = {k: i for i, k in enumerate(kids)}
        pt_ids = [mp for mp in m.obs if m.points.alive[mp]]
        if len(pt_ids) > max_pts:
            pt_ids.sort(key=lambda mp: -len(m.obs.get(mp, {})))
            print_mess(f"GBA: point cap hit, optimizing {max_pts} of "
                       f"{len(pt_ids)} map points", Level.NORMAL)
            pt_ids = pt_ids[:max_pts]
        pt_index = {mp: i for i, mp in enumerate(pt_ids)}

        obs_cam, obs_pt, uv, ur, stereo = [], [], [], [], []
        dropped_obs = 0
        for mp in pt_ids:
            for k, slot in m.obs.get(mp, {}).items():
                ci = index.get(k)
                if ci is None:
                    continue
                if len(obs_cam) >= max_obs:
                    dropped_obs += 1
                    continue
                kf = m.keyframes[k]
                obs_cam.append(ci)
                obs_pt.append(pt_index[mp])
                uv.append(kf.kpts_un[slot])
                r = kf.ur[slot]
                ur.append(r if r > 0 else 0.0)
                stereo.append(r > 0)
        if dropped_obs:
            print_mess(f"GBA: observation cap hit, dropped {dropped_obs} of "
                       f"{dropped_obs + len(obs_cam)} observations",
                       Level.NORMAL)
        n_obs = len(obs_cam)
        if n_obs < 50:
            return None

        def pad(a, n, fill=0, dtype=None):
            a = np.asarray(a, dtype)
            out = np.full((n,) + a.shape[1:], fill, a.dtype)
            out[: len(a)] = a
            return out

        C = _bucket(len(kids))
        P = _bucket(len(pt_ids), lo=256)
        O = _bucket(n_obs, lo=1024)
        fixed = np.ones(C, bool)
        cam_valid = np.zeros(C, bool)
        R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
        t = np.zeros((C, 3), np.float32)
        for k, i in index.items():
            kf = m.keyframes[k]
            R[i] = kf.R
            t[i] = kf.t
            cam_valid[i] = True
            fixed[i] = k == m.kf_origin
        obs_cam = pad(obs_cam, O, 0, np.int32)
        obs_pt = pad(obs_pt, O, 0, np.int32)
        valid = pad(np.ones(n_obs, bool), O, False)
        plan = (ba_mod.segment_plan(obs_cam, obs_pt, valid, C, P,
                                    self.device)
                if self.device.type == "cuda" else None)
        prob = ba_mod.BAProblem(
            R=self._t(R), t=self._t(t),
            fixed=self._t(fixed), cam_valid=self._t(cam_valid),
            X=self._t(pad(m.points.pos[pt_ids], P, 0, np.float32)),
            p_valid=self._t(pad(np.ones(len(pt_ids), bool), P, False)),
            obs_cam=self._t(obs_cam), obs_pt=self._t(obs_pt),
            uv=self._t(pad(uv, O, 0.0, np.float32)),
            ur=self._t(pad(ur, O, 0.0, np.float32)),
            stereo=self._t(pad(stereo, O, False)),
            valid=self._t(valid),
            inv_sigma2=torch.ones(O, dtype=torch.float32, device=self.device),
            plan=plan,
        )
        return prob, index, pt_ids, fixed, n_obs

    def _apply_gba(self, res, index, pt_ids, fixed, propagate: bool = False):
        """Write GBA results (numpy ``res``) back. With propagate=True (the
        budgeted path's final tick), keyframes and map points created after
        the problem was captured are corrected through the spanning tree or
        their first observing keyframe."""
        m = self.map
        R1, t1, X1 = np.asarray(res.R), np.asarray(res.t), np.asarray(res.X)
        if not propagate:
            for k, i in index.items():
                if not fixed[i]:
                    kf = m.keyframes[k]
                    kf.R = lie.np_normalize_rotation(R1[i])
                    kf.t = t1[i]
            m.points.pos[pt_ids] = X1[: len(pt_ids)]
            m.change_index += 1
            return
        # the pre-apply poses of every current keyframe
        cur = {k: (kf.R.copy(), kf.t.copy()) for k, kf in m.keyframes.items()}
        new_pose = {}
        for k, i in index.items():
            if k not in m.keyframes:
                continue  # culled during the session
            new_pose[k] = (cur[k] if fixed[i]
                           else (lie.np_normalize_rotation(R1[i]), t1[i]))
        # keyframes created during the session: T_new = T_rel * T_anc_new
        # with T_rel = T_cur * T_anc_cur^-1 along the spanning tree
        for k in sorted(m.keyframes):
            if k in new_pose:
                continue
            chain = [k]
            anc = m.keyframes[k].parent
            hops = 0
            while (anc >= 0 and anc in m.keyframes and anc not in new_pose
                   and hops < 1000):
                chain.append(anc)
                anc = m.keyframes[anc].parent
                hops += 1
            if anc not in new_pose:
                continue  # detached from the optimized graph
            for kk in reversed(chain):
                Rk, tk = cur[kk]
                p = m.keyframes[kk].parent
                Rp, tp = cur[p]
                Rn, tn = new_pose[p]
                R_rel = Rk @ Rp.T
                t_rel = tk - R_rel @ tp
                new_pose[kk] = (lie.np_normalize_rotation(R_rel @ Rn),
                                (R_rel @ tn + t_rel).astype(np.float32))
        # points of the session take their GBA positions; points created
        # meanwhile ride their first observing keyframe's correction
        in_gba = set(pt_ids)
        pt_arr = np.asarray(pt_ids)
        alive_mask = m.points.alive[pt_arr]
        m.points.pos[pt_arr[alive_mask]] = X1[: len(pt_ids)][alive_mask]
        for mp, obs in m.obs.items():
            if mp in in_gba or not m.points.alive[mp] or not obs:
                continue
            ref_k = min(obs)
            if ref_k not in new_pose or ref_k not in cur:
                continue
            R_o, t_o = cur[ref_k]
            R_n, t_n = new_pose[ref_k]
            Xc = R_o @ m.points.pos[mp] + t_o
            m.points.pos[mp] = (R_n.T @ (Xc - t_n)).astype(np.float32)
        for k, (R_n, t_n) in new_pose.items():
            kf = m.keyframes.get(k)
            if kf is not None:
                kf.R = R_n
                kf.t = np.asarray(t_n, np.float32)
        m.change_index += 1

    # ---------------------------------------------------------- map merging

    def _verify_and_merge(self, kid: int, ckid: int, cmap_id: int) -> bool:
        """A candidate in another map: verify a Sim3 between the active
        map's keyframe and the stored map's, then weld the maps (the
        MergeLocal role)."""
        m_new = self.map
        m_old = self.atlas.maps[cmap_id]
        kf1 = m_new.keyframes.get(kid)
        kf2 = m_old.keyframes.get(ckid)
        if kf1 is None or kf2 is None:
            return False
        slots1, slots2 = self._match_slots(m_new, kf1, m_old, kf2)
        if len(slots1) < 20:
            return False
        sim = self._verified_sim3(m_new, kf1, m_old, kf2, slots1, slots2,
                                  kid + 7777)
        if sim is None:
            return False
        self.merge_maps(m_new, m_old, kid, ckid, *sim)
        return True

    def merge_maps(self, m_new, m_old, kid, ckid, s12, R12, t12):
        """Weld the active (new) map into the matched (old) map: express
        the new map's geometry in the old map's world frame through the
        verified Sim3, move keyframes and points over (ids shifted), fuse
        the duplicates around the weld, then a GBA (the welding inertial BA
        when the welded map is IMU-initialized); the old map becomes the
        active one.

        X_cam_kid = S12(X_cam_ckid) and X_cam_kid = S_kid(X_w_new), so
        X_w_new = S_kid^{-1} S12 S_ckid (X_w_old) =: D(X_w_old): new-map
        poses become S' = S o D, points X_old = D^{-1}(X_new)."""
        kf1 = m_new.keyframes[kid]
        kf2 = m_old.keyframes[ckid]
        mid = _sim3_mul(_sim3_inv(1.0, kf1.R, kf1.t), (s12, R12, t12))
        sD, RD, tD = _sim3_mul(mid, (1.0, kf2.R, kf2.t))
        sDi, RDi, tDi = _sim3_inv(sD, RD, tD)

        kid_offset = (max(m_old.keyframes) + 1) if m_old.keyframes else 0
        mp_remap = {}
        # move points: X_old_world = D^{-1}(X_new_world)
        for mp in list(m_new.obs.keys()):
            if not m_new.points.alive[mp]:
                continue
            Xo = sDi * (RDi @ m_new.points.pos[mp]) + tDi
            new_id = m_old.points.alloc(
                Xo.astype(np.float32), m_new.points.desc[mp],
                first_kf=-1, angle=float(m_new.points.angle[mp]),
            )
            m_old.obs[new_id] = {}
            mp_remap[mp] = new_id
        # move keyframes: pose S' = S_kf o D, stored as SE3 [R | t/s]
        for okid in sorted(m_new.keyframes):
            kf = m_new.keyframes[okid]
            sP, RP, tP = _sim3_mul((1.0, kf.R, kf.t), (sD, RD, tD))
            kf.R = lie.np_normalize_rotation(RP)
            kf.t = (tP / max(sP, 1e-9)).astype(np.float32)
            kf.kid = okid + kid_offset
            kf.mp_ids = np.array(
                [mp_remap.get(int(m), -1) if m >= 0 else -1
                 for m in kf.mp_ids], np.int64)
            kf.parent = kf.parent + kid_offset if kf.parent >= 0 else -1
            kf.children = {c + kid_offset for c in kf.children}
            # the inertial chain travels with the keyframe: world velocities
            # rotate and scale like position derivatives; the biases and the
            # preintegrations are body-frame and unchanged
            if kf.prev_kf >= 0:
                kf.prev_kf = kf.prev_kf + kid_offset
            if kf.vel is not None:
                kf.vel = (sDi * (RDi @ kf.vel)).astype(np.float32)
            m_old.keyframes[kf.kid] = kf
            m_old.covis.setdefault(kf.kid, {})
            for slot in np.nonzero(kf.mp_ids >= 0)[0]:
                m_old.obs.setdefault(int(kf.mp_ids[slot]), {})[kf.kid] = \
                    int(slot)
        # link the welding pair in the spanning structure
        new_kid = kid + kid_offset
        m_old.keyframes[new_kid].loop_edges.add(ckid)
        kf2.merge_edges.add(new_kid)
        for okid in sorted(m_new.keyframes):
            m_old.update_connections(okid + kid_offset)
            mp_list = m_old.keyframes[okid + kid_offset].mp_ids
            for mp in mp_list[mp_list >= 0]:
                m_old.update_point(int(mp))
        # retrieval: re-tag the moved keyframes with their new map and ids
        self.retrieval.retag_map(m_new.map_id, m_old.map_id, kid_offset)
        # culled-keyframe trajectory anchors travel with the weld
        for cull_kid, (parent, R_cp, t_cp) in m_new.culled.items():
            m_old.culled[cull_kid + kid_offset] = (
                parent + kid_offset if parent >= 0 else -1, R_cp, t_cp)
        # the IMU state: the welded map keeps the old map's frame. If only
        # the moved map was initialized, its gravity alignment did not
        # survive the weld: the flags are cleared so local mapping's
        # schedule initializes the intact chain again in the merged frame,
        # from the moved map's biases; if both were, the moved map's
        # (fresher) biases are adopted
        if m_new.imu_initialized and not m_old.imu_initialized:
            m_old.imu_initialized = False
            m_old.imu_ba1 = False
            m_old.imu_ba2 = False
            m_old.imu_bg = m_new.imu_bg.copy()
            m_old.imu_ba = m_new.imu_ba.copy()
        elif m_new.imu_initialized:
            m_old.imu_bg = m_new.imu_bg.copy()
            m_old.imu_ba = m_new.imu_ba.copy()
        # fuse duplicate landmarks around the weld: the old map's window
        # projected into the moved keyframe and its covisibles, the old
        # side winning
        self.map = m_old
        weld_group = [new_kid] + m_old.covisible_kfs(new_kid)
        n_weld_fused = self._search_and_fuse(weld_group, ckid)
        if n_weld_fused:
            print_mess(f"weld fusion bound {n_weld_fused} landmark "
                       f"duplicates", Level.VERBOSE)
        if m_old.imu_initialized and self.welding_iba is not None:
            # MergeInertialBA: the two temporal windows around the weld
            # refined jointly with the IMU chains, in place of a visual GBA
            # (the inertial chain must stay consistent)
            self.welding_iba(new_kid, ckid)
        elif self.run_gba:
            self.global_bundle_adjust()
        # the old map becomes active, the new one dissolves; the remap
        # record lets trajectory resolution chase frames into the weld
        self.atlas.maps.pop(m_new.map_id, None)
        self.atlas.active_id = m_old.map_id
        self.atlas.remaps[m_new.map_id] = (m_old.map_id, kid_offset)
        self.merged.append((m_new.map_id, m_old.map_id))
        m_old.change_index += 1
        return kid_offset

    def _search_and_fuse(self, group, ckid: int) -> int:
        """Loop fusion (SearchAndFuse with ORBmatcher::Fuse): project the
        loop side's landmarks (the matched keyframe and its covisibles)
        into every keyframe of ``group`` with a tight radius; a matched
        slot that holds another landmark is replaced by the loop landmark
        (the loop side is trusted), an empty slot gains an observation.
        Returns the number of fused or bound slots."""
        m = self.map
        loop_mps = self._loop_window_points(ckid)
        if not loop_mps:
            return 0
        binary = m.desc_dim > 64
        fused = 0
        for gk in group:
            kf = m.keyframes.get(gk)
            if kf is None:
                continue
            # aliveness again for each keyframe: replace_point retires
            # loop-side duplicates as the fusion goes
            Xc = m.points.pos[loop_mps] @ kf.R.T + kf.t
            idx, mask = self._project_into(
                Xc, 4.0, m.points.desc[loop_mps], m.points.alive[loop_mps],
                kf, kf.valid,
                matching.ORB_TH_LOW if binary else matching.TH_LOW * 6, 0.9)
            for i in np.nonzero(mask)[0]:
                lmp = loop_mps[i]
                if not m.points.alive[lmp]:
                    continue
                slot = int(idx[i])
                cur = int(kf.mp_ids[slot])
                if cur == lmp:
                    continue
                if cur >= 0 and m.points.alive[cur]:
                    m.replace_point(cur, lmp)
                    fused += 1
                elif gk not in m.obs.get(lmp, {}):
                    m.add_observation(lmp, gk, slot, update_links=False)
                    fused += 1
        if fused:
            # the loop-region covisibilities the essential graph uses
            for gk in group:
                if gk in m.keyframes:
                    m.update_connections(gk)
        return fused

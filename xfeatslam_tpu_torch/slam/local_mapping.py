"""LocalMapping: map maintenance after each new keyframe.

Counterpart of ``xfeatslam_tpu/slam/local_mapping.py`` without the
inertial parts (the role of ORB-SLAM3's LocalMapping.cc): cull the recent
map points, triangulate new points with the covisible neighbours, fuse
duplicates, run local BA, cull redundant keyframes. It runs synchronously
after tracking inserts a keyframe; the local BA's later rounds run one per
frame between keyframes (``tick``). The host logic is numpy; the batched
geometry, matching and BA run as the port's torch ops on ``device``.

The inertial schedule (IMU initialization, VIBA, inertial BA and its
culling rules) waits for ROADMAP item 15.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from ..ops import geometry, lie, matching
from ..optim import local_ba as ba
from ..optim.track_step import fetch

# static buckets of the local-BA problem (one set of shapes for every
# window)
BA_MAX_CAMS = 32
BA_MAX_PTS = 4096
BA_MAX_OBS = 16384


class LocalMapping:
    # budgeted local BA: after the robust first stage, this many rounds of
    # BA_ROUND_ITERS LM iterations run one per frame through tick() (the
    # same total budget as the (5,10) schedule)
    BA_BUDGET_ROUNDS = 2
    BA_ROUND_ITERS = 5
    # the match threshold of triangulation and fusion: float descriptors
    # need a looser absolute threshold than the reference's binary TH_LOW
    MAX_DIST = matching.TH_LOW * 6

    def __init__(self, slam_map, cam, bf: float, device):
        self.map = slam_map
        self.cam = cam
        self.bf = bf
        self.device = torch.device(device)
        # mp -> kf id at creation, for the culling window
        self.recent_points: Dict[int, int] = {}
        self._ba_session = None
        # host wall seconds of each BA solve, with its stage ("first" or
        # "tick"), for the timing report
        self.ba_seconds: List[tuple] = []

    def _t(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def process_keyframe(self, kid: int):
        # a new KF supersedes any in-flight budgeted BA session (the
        # reference's mbAbortBA)
        self._ba_session = None
        self._cull_map_points(kid)
        self._create_new_points(kid)
        self._fuse_neighbors(kid)
        if self.map.num_keyframes() > 2:
            self._local_ba(kid)
        self._cull_keyframes(kid)

    def tick(self):
        """Run one budgeted round of the in-flight local-BA session (called
        on every frame that inserted no keyframe): the reference's
        background BA thread as the same iteration budget spread over the
        frames between keyframes, aborted when a new keyframe arrives."""
        s = self._ba_session
        if s is None:
            return
        prob, obs_ref, cam_index, fixed, pt_ids, n_obs, rounds_left, chg = s
        if self.map.change_index != chg:
            # the map moved under the session: its captured poses and
            # points are stale, and applying them would undo the change
            self._ba_session = None
            return
        t0 = time.perf_counter()
        res = fetch(ba.bundle_adjust(prob, self.cam, self.bf,
                                     stage_iters=(0, self.BA_ROUND_ITERS)))
        self.ba_seconds.append(("tick", time.perf_counter() - t0))
        prob = prob._replace(R=self._t(res.R), t=self._t(res.t),
                             X=self._t(res.X))
        rounds_left -= 1
        self._apply_ba(res, obs_ref, cam_index, fixed, pt_ids, n_obs,
                       final=rounds_left <= 0)
        self._ba_session = None if rounds_left <= 0 else (
            prob, obs_ref, cam_index, fixed, pt_ids, n_obs, rounds_left,
            self.map.change_index,
        )

    # -- LocalBundleAdjustment (Optimizer::LocalBundleAdjustment) -----------

    def _local_ba(self, kid: int):
        """Build the padded covisibility-window problem, run the LM solver
        (optim/local_ba.py), write back poses and points, drop outlier
        observations."""
        from ..utils import verbose

        kf0 = self.map.keyframes.get(kid)
        if kf0 is None:
            return
        opt_ids = [kid] + self.map.covisible_kfs(kid, BA_MAX_CAMS // 2 - 1)
        opt_set = set(opt_ids)
        # points seen by the optimized KFs
        pt_ids: List[int] = []
        seen = set()
        for k in opt_ids:
            kf = self.map.keyframes[k]
            for mp in kf.mp_ids[kf.mp_ids >= 0]:
                mp = int(mp)
                if mp not in seen and self.map.points.alive[mp]:
                    seen.add(mp)
                    pt_ids.append(mp)
        if len(pt_ids) > BA_MAX_PTS:
            verbose.print_mess(
                f"local BA point cap hit: {BA_MAX_PTS} of "
                f"{len(pt_ids)} points", verbose.Level.VERBOSE)
            pt_ids = pt_ids[:BA_MAX_PTS]
        pt_index = {mp: i for i, mp in enumerate(pt_ids)}
        # fixed KFs: observers of the local points outside the opt set
        fixed_ids: List[int] = []
        for mp in pt_ids:
            for k in self.map.obs.get(mp, {}):
                if k not in opt_set and k not in fixed_ids:
                    fixed_ids.append(k)
                    if len(opt_ids) + len(fixed_ids) >= BA_MAX_CAMS:
                        break
            if len(opt_ids) + len(fixed_ids) >= BA_MAX_CAMS:
                break
        if not fixed_ids:
            # gauge: fix the oldest KF of the window
            oldest = min(opt_ids)
            opt_ids.remove(oldest)
            fixed_ids.append(oldest)
        cam_ids = opt_ids + fixed_ids
        cam_index = {k: i for i, k in enumerate(cam_ids)}
        C = len(cam_ids)

        obs_cam, obs_pt, uv, ur, stereo = [], [], [], [], []
        obs_ref = []  # (mp, kf) for the write-back
        for mp in pt_ids:
            for k, slot in self.map.obs.get(mp, {}).items():
                ci = cam_index.get(k)
                if ci is None:
                    continue
                kf = self.map.keyframes[k]
                obs_cam.append(ci)
                obs_pt.append(pt_index[mp])
                uv.append(kf.kpts_un[slot])
                r = kf.ur[slot]
                ur.append(r if r > 0 else 0.0)
                stereo.append(r > 0)
                obs_ref.append((mp, k))
                if len(obs_cam) >= BA_MAX_OBS:
                    break
            if len(obs_cam) >= BA_MAX_OBS:
                verbose.print_mess(
                    f"local BA observation cap hit: {BA_MAX_OBS}",
                    verbose.Level.VERBOSE)
                break
        n_obs = len(obs_cam)
        if n_obs < 20:
            return

        def pad(a, n, fill=0, dtype=None):
            a = np.asarray(a, dtype)
            out = np.full((n,) + a.shape[1:], fill, a.dtype)
            out[: len(a)] = a
            return self._t(out)

        R = np.stack([self.map.keyframes[k].R for k in cam_ids])
        t = np.stack([self.map.keyframes[k].t for k in cam_ids])
        fixed = np.zeros(C, bool)
        fixed[len(opt_ids):] = True
        # always keep the map origin fixed if present (gauge)
        if self.map.kf_origin in cam_index:
            fixed[cam_index[self.map.kf_origin]] = True

        prob = ba.BAProblem(
            R=pad(R, BA_MAX_CAMS, 0, np.float32),
            t=pad(t, BA_MAX_CAMS, 0, np.float32),
            fixed=pad(fixed, BA_MAX_CAMS, True),
            cam_valid=pad(np.ones(C, bool), BA_MAX_CAMS, False),
            X=pad(self.map.points.pos[pt_ids], BA_MAX_PTS, 0, np.float32),
            p_valid=pad(np.ones(len(pt_ids), bool), BA_MAX_PTS, False),
            obs_cam=pad(obs_cam, BA_MAX_OBS, 0, np.int32),
            obs_pt=pad(obs_pt, BA_MAX_OBS, 0, np.int32),
            uv=pad(uv, BA_MAX_OBS, 0.0, np.float32),
            ur=pad(ur, BA_MAX_OBS, 0.0, np.float32),
            stereo=pad(stereo, BA_MAX_OBS, False),
            valid=pad(np.ones(n_obs, bool), BA_MAX_OBS, False),
            inv_sigma2=torch.ones(BA_MAX_OBS, dtype=torch.float32,
                                  device=self.device),
        )
        # the robust first stage now (with the chi2 prune after it); the
        # remaining rounds run one per frame through tick()
        t0 = time.perf_counter()
        res = fetch(ba.bundle_adjust(prob, self.cam, self.bf,
                                     stage_iters=(5, 0)))
        self.ba_seconds.append(("first", time.perf_counter() - t0))
        self._apply_ba(res, obs_ref, cam_index, fixed, pt_ids, n_obs,
                       final=False)
        prob = prob._replace(R=self._t(res.R), t=self._t(res.t),
                             X=self._t(res.X))
        self._ba_session = (prob, obs_ref, cam_index, fixed, pt_ids, n_obs,
                            self.BA_BUDGET_ROUNDS, self.map.change_index)

    def _apply_ba(self, res, obs_ref, cam_index, fixed, pt_ids, n_obs,
                  final: bool):
        """Write back poses and points (numpy ``res``); on the final round
        also drop the outlier observations."""
        for k, i in cam_index.items():
            if not fixed[i]:
                kf = self.map.keyframes.get(k)
                if kf is not None:
                    kf.R = lie.np_normalize_rotation(res.R[i])
                    kf.t = res.t[i]
        alive = self.map.points.alive[pt_ids]
        ids = np.asarray(pt_ids)
        self.map.points.pos[ids[alive]] = res.X[: len(pt_ids)][alive]
        if final:
            for o in np.nonzero(~res.inlier[:n_obs])[0]:
                mp, k = obs_ref[o]
                self.map.remove_observation(mp, k)
            for mp in pt_ids:
                if self.map.points.alive[mp]:
                    self.map.update_point(mp)
        self.map.change_index += 1

    # -- MapPointCulling ------------------------------------------------------

    def _cull_map_points(self, kid: int):
        for mp in list(self.recent_points):
            born = self.recent_points[mp]
            if not self.map.points.alive[mp]:
                del self.recent_points[mp]
                continue
            found_ratio = self.map.points.found[mp] / max(
                self.map.points.visible[mp], 1
            )
            age = kid - born
            if found_ratio < 0.25:
                self.map.remove_point(mp)
                del self.recent_points[mp]
            elif age >= 2 and self.map.points.n_obs[mp] <= 3:
                self.map.remove_point(mp)
                del self.recent_points[mp]
            elif age >= 3:
                del self.recent_points[mp]  # survived the probation window

    # -- CreateNewMapPoints -----------------------------------------------

    def _create_new_points(self, kid: int):
        """One batched call for the whole neighbour set: epipolar matching,
        triangulation, the RGB-D depth fallback and the acceptance gates
        (ops/geometry.triangulation_search_batched); the host keeps the
        baseline gate and the create-point bookkeeping. All neighbours match
        against the keyframe's initial free set and the host skips slots
        already bound in loop order (the first neighbour wins)."""
        kf1 = self.map.keyframes.get(kid)
        if kf1 is None:
            return
        neighbors = self.map.covisible_kfs(kid, 10)
        C1 = kf1.center()
        cam = self.cam
        K = np.array([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                      [0.0, 0.0, 1.0]], np.float32)
        free1 = kf1.valid & (kf1.mp_ids < 0)
        if not free1.any():
            return
        use = []
        for nkid in neighbors:
            kf2 = self.map.keyframes.get(nkid)
            if kf2 is None:
                continue
            baseline = float(np.linalg.norm(kf2.center() - C1))
            # RGB-D gate: the baseline must exceed 1% of the median depth
            med_depth = float(np.median(kf2.depth[kf2.depth > 0])) if (
                kf2.depth > 0
            ).any() else 4.0
            if baseline < 0.01 * med_depth:
                continue
            free2 = kf2.valid & (kf2.mp_ids < 0)
            if not free2.any():
                continue
            use.append((nkid, kf2, free2))
        if not use:
            self.map.update_connections(kid)
            return
        Nn = max(2, 1 << (len(use) - 1).bit_length())  # bucketed shapes

        def stack(get, fill=0.0):
            rows = [get(kf2, f2) for (_, kf2, f2) in use]
            out = np.full((Nn,) + rows[0].shape, fill, rows[0].dtype)
            out[: len(rows)] = rows
            return self._t(out)

        nb_valid = np.zeros(Nn, bool)
        nb_valid[: len(use)] = True
        idx, ok, X = fetch(geometry.triangulation_search_batched(
            self._t(K), self._t(kf1.R), self._t(kf1.t),
            self._t(kf1.kpts_un), self._t(kf1.desc),
            self._t(free1), self._t(kf1.depth),
            stack(lambda kf2, f2: kf2.R), stack(lambda kf2, f2: kf2.t),
            stack(lambda kf2, f2: kf2.kpts_un),
            stack(lambda kf2, f2: kf2.desc),
            stack(lambda kf2, f2: f2, fill=False),
            stack(lambda kf2, f2: kf2.depth),
            self._t(nb_valid),
            cam.fx, cam.fy, cam.cx, cam.cy, self.bf, self.MAX_DIST,
            ratio=0.8,
        ))
        for j, (nkid, kf2, _f2) in enumerate(use):
            mask = matching.rotation_consistency_filter(
                kf1.angle, kf2.angle, np.clip(idx[j], 0, None), ok[j]
            )
            for s1 in np.nonzero(mask)[0]:
                s1 = int(s1)
                s2 = int(idx[j][s1])
                if kf1.mp_ids[s1] >= 0 or kf2.mp_ids[s2] >= 0:
                    continue
                mp = self.map.create_point(
                    X[j][s1].astype(np.float32), kf1.desc[s1], kid,
                    float(kf1.angle[s1]),
                )
                self.map.add_observation(mp, kid, s1, update_links=False)
                self.map.add_observation(mp, nkid, s2, update_links=False)
                self.map.update_point(mp)
                self.recent_points[mp] = kid
        self.map.update_connections(kid)

    # -- SearchInNeighbors / Fuse ---------------------------------------------

    def _fuse_neighbors(self, kid: int):
        kf1 = self.map.keyframes.get(kid)
        if kf1 is None:
            return
        neighbors = self.map.covisible_kfs(kid, 10)
        # project this KF's points into all neighbours in one call
        # (matching.fuse_project_batched) and merge duplicates; aliveness is
        # re-checked per match, since earlier fusions can retire points
        own = kf1.mp_ids[kf1.mp_ids >= 0]
        if len(own) == 0:
            return
        kf2s = [(nkid, self.map.keyframes[nkid]) for nkid in neighbors
                if nkid in self.map.keyframes]
        if not kf2s:
            return
        Nn = max(2, 1 << (len(kf2s) - 1).bit_length())

        def stack(get, fill=0.0):
            rows = [get(kf2) for (_, kf2) in kf2s]
            out = np.full((Nn,) + rows[0].shape, fill, rows[0].dtype)
            out[: len(rows)] = rows
            return self._t(out)

        cam = self.cam
        res = matching.fuse_project_batched(
            self._t(self.map.points.pos[own]),
            self._t(self.map.points.desc[own]),
            self._t(self.map.points.alive[own]),
            stack(lambda kf2: kf2.R), stack(lambda kf2: kf2.t),
            stack(lambda kf2: kf2.kpts_un), stack(lambda kf2: kf2.desc),
            stack(lambda kf2: kf2.valid, fill=False),
            cam.fx, cam.fy, cam.cx, cam.cy, radius=3.0,
            max_dist=self.MAX_DIST, ratio=0.9,
        )
        idx_all, mask_all = fetch((res.idx, res.mask))
        for j, (nkid, kf2) in enumerate(kf2s):
            idx, mask = idx_all[j], mask_all[j]
            for m in np.nonzero(mask)[0]:
                mp1 = int(own[m])
                slot2 = int(idx[m])
                mp2 = int(kf2.mp_ids[slot2])
                if not self.map.points.alive[mp1]:
                    continue
                if mp2 >= 0 and self.map.points.alive[mp2]:
                    # keep the one with more observations
                    if self.map.points.n_obs[mp2] >= self.map.points.n_obs[mp1]:
                        self.map.replace_point(mp1, mp2)
                    else:
                        self.map.replace_point(mp2, mp1)
                elif mp2 < 0:
                    if nkid not in self.map.obs.get(mp1, {}):
                        self.map.add_observation(mp1, nkid, slot2)
        self.map.update_connections(kid)

    # -- KeyFrameCulling --------------------------------------------------------

    def _cull_keyframes(self, kid: int):
        """Remove covisible KFs whose map points are >= 90% seen by >= 3
        other KFs (the single-octave form of the scale-band check)."""
        for ckid in self.map.covisible_kfs(kid):
            kf = self.map.keyframes.get(ckid)
            if kf is None or ckid == self.map.kf_origin or ckid == kid:
                continue
            mps = kf.mp_ids[kf.mp_ids >= 0]
            if len(mps) == 0:
                continue
            redundant = 0
            for mp in mps:
                if self.map.points.n_obs[int(mp)] >= 4:  # this KF + 3 others
                    redundant += 1
            if redundant > 0.9 * len(mps):
                self.map.remove_keyframe(ckid)

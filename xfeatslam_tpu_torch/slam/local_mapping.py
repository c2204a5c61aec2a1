"""LocalMapping: map maintenance after each new keyframe.

Counterpart of ``xfeatslam_tpu/slam/local_mapping.py`` (the role of
ORB-SLAM3's LocalMapping.cc): cull the recent map points, triangulate new
points with the covisible neighbours, fuse duplicates, run local BA, cull
redundant keyframes. It runs synchronously after tracking inserts a
keyframe; the local BA's later rounds run one per frame between keyframes
(``tick``). The host logic is numpy; the batched geometry, matching and BA
run as the port's torch ops on ``device``.

With an IMU (``imu_calib``) it also runs the IMU initialization schedule
(init, VIBA1, VIBA2: ``optim/inertial``'s ``inertial_init`` on the keyframe
chain, the map rotated and rescaled, then a full-chain inertial BA), the
joint visual-inertial window BA (``optim/viba``) in place of the visual
local BA once the map is initialized, and the inertial culling rules (the
chain kept dense, the culled keyframe's preintegration merged into its
successor's). A monocular inertial map (``mono``) waits for 10 keyframes
and 2 s, initializes with a free scale, and refines scale and gravity on
pinned biases while its chain spans under 50 s. After a weld into an
inertial map, ``merge_inertial_ba`` refines the two temporal windows
around the weld. On the card the solvers replay CUDA graphs
(``inertial.InertialGraph``), one per shape and LM schedule; the
initialization's bias priors are tensor inputs, so its four steps share
one graph a chain bucket.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import geometry, lie, matching
from ..ops import imu as imu_ops
from ..optim import inertial as in_opt
from ..optim import local_ba as ba
from ..optim import viba
from ..optim.inertial import np_body_to_cam, np_cam_to_body
from ..optim.track_step import fetch
from .loop_closing import _bucket

# static buckets of the local-BA problem (one set of shapes for every
# window)
BA_MAX_CAMS = 32
BA_MAX_PTS = 4096
BA_MAX_OBS = 16384
# inertial window buckets (LocalInertialBA uses ~10 temporal keyframes)
IBA_MAX_KFS = 8  # temporal chain window
IBA_MAX_KFS_TOTAL = 16  # chain + fixed out-of-window observers
# MergeInertialBA: 2*Nd = 12 free states, the 2 window anchors and the
# covisible fixed observers
MERGE_IBA_SLOTS = 24
IBA_MAX_PTS = 2048
IBA_MAX_OBS = 4096
# FullInertialBA's caps (the whole chain buckets to powers of two up to
# these; hitting one is logged)
FIBA_MAX_PTS = 16384
FIBA_MAX_OBS = 65536


def _relinearize_np(pre, bg, ba):
    """``imu.relinearize`` of a host Preintegrated, as numpy arrays."""
    return imu_ops.to_numpy(imu_ops.relinearize(
        imu_ops.to_tensors(pre, "cpu"),
        torch.from_numpy(np.asarray(bg, np.float32)),
        torch.from_numpy(np.asarray(ba, np.float32))))


class LocalMapping:
    # budgeted local BA: after the robust first stage, this many rounds of
    # BA_ROUND_ITERS LM iterations run one per frame through tick() (the
    # same total budget as the (5,10) schedule)
    BA_BUDGET_ROUNDS = 2
    BA_ROUND_ITERS = 5

    def __init__(self, slam_map, cam, bf: float, device,
                 profile: matching.MatchProfile = matching.XFEAT_PROFILE,
                 imu_calib: imu_ops.ImuCalib = None, mono: bool = False,
                 imu_init_time: float = 1.0, viba1_time: float = 5.0,
                 viba2_time: float = 15.0, imu_min_kfs: int = 6):
        """imu_calib: the IMU calibration of an inertial map (None without
        an IMU); mono: a monocular inertial map (its scale unknown until the
        IMU initializes); imu_init_time, viba1_time, viba2_time: the
        seconds of keyframe chain after which the first initialization,
        VIBA1 and VIBA2 run; imu_min_kfs: the chain length of the first. A
        monocular map waits for at least 2 s and 10 keyframes: its scale is
        weakly observable from a short gentle chain."""
        self.map = slam_map
        self.cam = cam
        self.bf = bf
        self.device = torch.device(device)
        self.profile = profile
        self.imu_calib = imu_calib
        self.mono = mono
        self.imu_init_time = max(imu_init_time, 2.0) if mono else imu_init_time
        self.viba1_time = viba1_time
        self.viba2_time = viba2_time
        self.imu_min_kfs = max(imu_min_kfs, 10) if mono else imu_min_kfs
        # (s, R_wg) the system hands to tracking after an IMU
        # initialization rescaled the map
        self.pending_map_transform = None
        # a record of each inertial initialization: (sect, scale, R_wg,
        # cost, chain length)
        self.init_sect = 0
        self.init_debug = []
        # the match threshold of triangulation and fusion: float
        # descriptors need a looser absolute threshold than the
        # reference's; binary (ORB) takes its TH_LOW directly
        self.tri_max_dist = (profile.th_low if profile.binary
                             else profile.th_low * 6)
        self.fuse_max_dist = self.tri_max_dist
        # mp -> kf id at creation, for the culling window
        self.recent_points: Dict[int, int] = {}
        self._ba_session = None
        on_card = self.device.type == "cuda"
        self._ba_graph = ba.LocalBAGraph(self.device) if on_card else None
        # the inertial solvers' CUDA graphs: the IMU initialization per
        # chain bucket, the inertial BA per window bucket
        inertial_card = on_card and imu_calib is not None
        self._init_graph = (in_opt.InertialGraph(self.device,
                                                 in_opt.inertial_init)
                            if inertial_card else None)
        self._viba_graph = (in_opt.InertialGraph(self.device, viba.solve_flat)
                            if inertial_card else None)
        # host wall seconds of each BA solve, with its stage ("first" or
        # "tick") and whether the call captured a graph, for the timing
        # report
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
            if self.imu_calib is not None and self.map.imu_initialized:
                self._local_inertial_ba(kid)  # states and landmarks jointly
            else:
                self._local_ba(kid)
        if self.imu_calib is not None:
            self._imu_step(kid)
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
        res = self._solve(prob, "tick", (0, self.BA_ROUND_ITERS))
        prob = prob._replace(R=self._t(res.R), t=self._t(res.t),
                             X=self._t(res.X))
        rounds_left -= 1
        self._apply_ba(res, obs_ref, cam_index, fixed, pt_ids, n_obs,
                       final=rounds_left <= 0)
        self._ba_session = None if rounds_left <= 0 else (
            prob, obs_ref, cam_index, fixed, pt_ids, n_obs, rounds_left,
            self.map.change_index,
        )

    def _solve(self, prob, stage: str, stage_iters):
        """One BA round, read to the host: the graph's replay on the card,
        the eager solve on the CPU."""
        return ba.timed_solve(self._ba_graph, prob, self.cam, self.bf,
                              stage_iters, self.ba_seconds, stage)

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

        obs_cam = np.asarray(obs_cam + [0] * (BA_MAX_OBS - n_obs), np.int32)
        obs_pt = np.asarray(obs_pt + [0] * (BA_MAX_OBS - n_obs), np.int32)
        valid = np.arange(BA_MAX_OBS) < n_obs
        prob = ba.BAProblem(
            R=pad(R, BA_MAX_CAMS, 0, np.float32),
            t=pad(t, BA_MAX_CAMS, 0, np.float32),
            fixed=pad(fixed, BA_MAX_CAMS, True),
            cam_valid=pad(np.ones(C, bool), BA_MAX_CAMS, False),
            X=pad(self.map.points.pos[pt_ids], BA_MAX_PTS, 0, np.float32),
            p_valid=pad(np.ones(len(pt_ids), bool), BA_MAX_PTS, False),
            obs_cam=self._t(obs_cam), obs_pt=self._t(obs_pt),
            uv=pad(uv, BA_MAX_OBS, 0.0, np.float32),
            ur=pad(ur, BA_MAX_OBS, 0.0, np.float32),
            stereo=pad(stereo, BA_MAX_OBS, False),
            valid=self._t(valid),
            inv_sigma2=torch.ones(BA_MAX_OBS, dtype=torch.float32,
                                  device=self.device),
            plan=ba.segment_plan(obs_cam, obs_pt, valid, BA_MAX_CAMS,
                                 BA_MAX_PTS, self.device),
        )
        # the robust first stage now (with the chi2 prune after it); the
        # remaining rounds run one per frame through tick()
        res = self._solve(prob, "first", (5, 0))
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

    # -- the IMU initialization schedule ------------------------------------

    def _kf_chain(self, kid: int):
        """The temporal keyframe chain ending at kid (prev_kf links), oldest
        first."""
        chain = []
        k = kid
        while k is not None and k >= 0 and k in self.map.keyframes:
            chain.append(k)
            k = self.map.keyframes[k].prev_kf
        return chain[::-1]

    def _imu_step(self, kid: int):
        """The inertial schedule: the first initialization once the chain is
        long enough, then VIBA1 and VIBA2 (independent gates, each latched
        only when its solve was applied); for a monocular map, the scale
        refinement on every keyframe while the chain spans under 50 s."""
        kf = self.map.keyframes.get(kid)
        if kf is None:
            return
        chain = self._kf_chain(kid)
        if len(chain) < 3:
            return
        span = kf.timestamp - self.map.keyframes[chain[0]].timestamp
        m = self.map
        if not m.imu_initialized:
            if len(chain) >= self.imu_min_kfs and span >= self.imu_init_time:
                # the first initialization: strong bias priors
                self._initialize_imu(chain, prior_g=1e2,
                                     prior_a=1e6 if self.mono else 1e5)
        else:
            if not m.imu_ba1 and span >= self.viba1_time:
                # VIBA1: the priors relax once the trajectory excited the IMU
                if self._initialize_imu(chain, prior_g=1.0, prior_a=1e5):
                    m.imu_ba1 = True
            if not m.imu_ba2 and m.imu_ba1 and span >= self.viba2_time:
                # VIBA2: a free refinement
                if self._initialize_imu(chain, prior_g=0.0, prior_a=0.0):
                    m.imu_ba2 = True
            if self.mono and span < 50.0:
                # ScaleRefinement: scale and gravity only, on the biases
                # pinned to the current estimate, so the residual scale
                # drift a free joint solve trades into the acc bias becomes
                # observable. The biases are not rewritten: overwriting the
                # keyframes' refined biases with the stale shared estimate
                # would undo the inertial BA's walk tracking
                self._initialize_imu(chain, prior_g=1e8, prior_a=1e8,
                                     fiba=False, min_apply=0.005,
                                     update_bias=False)

    def _initialize_imu(self, chain, prior_g: float, prior_a: float,
                        fiba: bool = True, min_apply: float = 0.0,
                        update_bias: bool = True) -> bool:
        """InertialOptimization and ApplyScaledRotation: the scale, gravity,
        shared bias and velocities on the fixed visual poses of the chain
        (padded to a power-of-two bucket; the scale free on a monocular
        map), then the map rotated and rescaled so gravity is (0,0,-9.81)
        metric, then FullInertialBA (``fiba``). Returns True when an
        estimate was computed and applied, or found below ``min_apply``:
        a scale within min_apply of 1 with a gravity tilt under 0.2 degrees
        is not applied. update_bias=False leaves the bias state alone (the
        scale refinement)."""
        from ..utils import verbose

        m = self.map
        cal = self.imu_calib
        K = len(chain)
        K_pad = _bucket(K, lo=8)
        R_wb = np.tile(np.eye(3, dtype=np.float32), (K_pad, 1, 1))
        p_wb = np.zeros((K_pad, 3), np.float32)
        for i, k in enumerate(chain):
            kf = m.keyframes[k]
            R_wb[i], p_wb[i] = np_cam_to_body(kf.R, kf.t, cal.R_bc, cal.t_bc)
        E = K_pad - 1
        dts = np.zeros(E, np.float32)
        dR = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
        dV = np.zeros((E, 3), np.float32)
        dP = np.zeros((E, 3), np.float32)
        J = {n: np.zeros((E, 3, 3), np.float32)
             for n in ["JRg", "JVg", "JVa", "JPg", "JPa"]}
        cov9 = np.tile(np.eye(9, dtype=np.float32), (E, 1, 1))
        e_valid = np.zeros(E, bool)
        bg0, ba0 = m.imu_bg, m.imu_ba
        for i in range(K - 1):
            kf_next = m.keyframes[chain[i + 1]]
            pre = kf_next.pre_kf
            if pre is None or kf_next.prev_kf != chain[i] or pre.dt <= 0:
                continue
            # every edge at the map's common bias, so one shared bias delta
            # is solved across the chain
            pre_c = _relinearize_np(pre, bg0, ba0)
            dts[i] = float(pre_c.dt)
            dR[i], dV[i], dP[i] = pre_c.dR, pre_c.dV, pre_c.dP
            for n in J:
                J[n][i] = getattr(pre_c, n)
            cov9[i] = pre_c.cov[:9, :9]
            e_valid[i] = True
        if e_valid.sum() < 2:
            return False
        # the priors go in as 0-d tensors, not in the graph's key: every
        # step of the schedule replays the chain bucket's one graph
        tensors = tuple(torch.from_numpy(a).to(self.device) for a in (
            R_wb, p_wb, dts, dR, dV, dP, J["JRg"], J["JVg"], J["JVa"],
            J["JPg"], J["JPa"], cov9, e_valid, np.array(prior_g, np.float32),
            np.array(prior_a, np.float32)))
        static = dict(fix_scale=not self.mono)
        res = fetch(self._init_graph(tensors, **static)
                    if self._init_graph is not None
                    else in_opt.inertial_init(*tensors, **static))
        s = float(res.scale)
        R_wg = np.asarray(res.R_wg, np.float32)
        tilt = np.degrees(np.arccos(np.clip(R_wg[2, 2], -1, 1)))
        verbose.print_mess(
            f"IMU init (priorG={prior_g:g} priorA={prior_a:g}): scale={s:.4f}"
            f" gravity-tilt={tilt:.2f}deg cost={float(res.cost):.2f}",
            verbose.Level.VERBOSE)
        self.init_sect += 1
        self.init_debug.append((self.init_sect, s, R_wg.copy(),
                                float(res.cost), K))
        if not np.isfinite(s) or s < 1e-2 or s > 1e2:
            verbose.print_mess("IMU init rejected: scale out of range",
                               verbose.Level.NORMAL)
            return False
        if min_apply > 0 and abs(s - 1.0) < min_apply and tilt < 0.2:
            return True  # converged: the refinement is below the threshold
        bg = bg0 + np.asarray(res.bg, np.float32)
        ba = ba0 + np.asarray(res.ba, np.float32)
        vel = np.asarray(res.vel, np.float32)

        m.apply_scaled_rotation(R_wg, s)
        # the chain velocities are metric in the OLD world orientation
        for i, k in enumerate(chain):
            kf = m.keyframes[k]
            kf.vel = (R_wg.T @ vel[i]).astype(np.float32)
            if update_bias:
                kf.bg = bg.copy()
                kf.ba = ba.copy()
        if update_bias:
            m.imu_bg = bg
            m.imu_ba = ba
        m.imu_initialized = True
        # compose with a transform tracking has not consumed yet
        if self.pending_map_transform is None:
            self.pending_map_transform = (s, R_wg)
        else:
            s0, R0 = self.pending_map_transform
            self.pending_map_transform = (s0 * s,
                                          (R0 @ R_wg).astype(np.float32))
        # FullInertialBA: the joint visual-inertial BA over the whole chain
        # with every state free
        if fiba:
            self._local_inertial_ba(chain[-1], fix_anchor=False,
                                    full_chain=True)
        return True

    # -- LocalInertialBA ----------------------------------------------------

    def _local_inertial_ba(self, kid: int, window: int = IBA_MAX_KFS,
                           fix_anchor: bool = True, full_chain: bool = False,
                           chain_override: Optional[List[int]] = None,
                           force_fixed: Sequence[int] = (),
                           total_slots: int = IBA_MAX_KFS_TOTAL):
        """The joint visual-inertial window BA (optim/viba): the temporal
        chain's body states and the window's landmarks in one solve, with
        fixed out-of-window observer states (LocalInertialBA).

        full_chain=True with fix_anchor=False is FullInertialBA: every chain
        keyframe's state is free (power-of-two state buckets, landmarks and
        observations bucketed up to FIBA_MAX_*, a cap logged), with a
        larger LM and PCG budget.

        chain_override: the free states' keyframes, given directly
        (MergeInertialBA's two temporal windows around a weld); an IMU edge
        joins two consecutive entries only where they are prev_kf-linked,
        so disjoint runs couple through shared landmarks. force_fixed: the
        keyframes that become fixed pose states first (the windows'
        anchors), before the strongest out-of-window observers fill the
        remaining slots."""
        from ..utils import verbose

        m = self.map
        cal = self.imu_calib
        if chain_override is not None:
            chain = list(chain_override)
        else:
            whole = self._kf_chain(kid)
            chain = whole if full_chain else whole[-window:]
        T = len(chain)
        if T < 3:
            return
        kfs = [m.keyframes[k] for k in chain]
        if any(kf.vel is None for kf in kfs):
            return
        b0g, b0a = kfs[0].bg, kfs[0].ba
        name = "FullInertialBA" if full_chain else "LocalInertialBA"

        max_pts = FIBA_MAX_PTS if full_chain else IBA_MAX_PTS
        max_obs = FIBA_MAX_OBS if full_chain else IBA_MAX_OBS
        # the landmarks the window observes
        pt_ids: List[int] = []
        seen = set()
        n_seen = 0
        for kf in kfs:
            for mp in kf.mp_ids[kf.mp_ids >= 0]:
                mp = int(mp)
                if mp not in seen and m.points.alive[mp]:
                    seen.add(mp)
                    n_seen += 1
                    if len(pt_ids) < max_pts:
                        pt_ids.append(mp)
        if n_seen > len(pt_ids):
            verbose.print_mess(
                f"{name}: point cap hit, optimizing {len(pt_ids)} of "
                f"{n_seen} landmarks", verbose.Level.NORMAL)
        pt_index = {mp: i for i, mp in enumerate(pt_ids)}
        if len(pt_ids) < 20:
            return
        # fixed observers outside the window (none for the full chain),
        # ranked by how many optimized landmarks each observes: the slots go
        # to the strongest covisible anchors
        chain_set = set(chain)
        fixed_ids: List[int] = [k for k in force_fixed
                                if k in m.keyframes and k not in chain_set]
        if not full_chain:
            counts: Dict[int, int] = {}
            for mp in pt_ids:
                for k in m.obs.get(mp, {}):
                    if k not in chain_set and k not in fixed_ids:
                        counts[k] = counts.get(k, 0) + 1
            budget = max(total_slots - T - len(fixed_ids), 0)
            ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
            fixed_ids += [k for k, _ in ranked[:budget]]
            if len(counts) > budget:
                verbose.print_mess(
                    f"LocalInertialBA: fixed-observer cap, anchoring on the "
                    f"{budget} strongest of {len(counts)} out-of-window "
                    "observers", verbose.Level.VERBOSE)
            fixed_ids = fixed_ids[:max(total_slots - T, 0)]
        cam_ids = chain + fixed_ids
        cam_index = {k: i for i, k in enumerate(cam_ids)}
        Kp = _bucket(len(cam_ids), lo=8) if full_chain else total_slots

        R_wb = np.tile(np.eye(3, dtype=np.float32), (Kp, 1, 1))
        p_wb = np.zeros((Kp, 3), np.float32)
        v_w = np.zeros((Kp, 3), np.float32)
        bg = np.zeros((Kp, 3), np.float32)
        ba_ = np.zeros((Kp, 3), np.float32)
        fixed = np.ones(Kp, bool)
        state_valid = np.zeros(Kp, bool)
        for i, k in enumerate(cam_ids):
            kf = m.keyframes[k]
            R_wb[i], p_wb[i] = np_cam_to_body(kf.R, kf.t, cal.R_bc, cal.t_bc)
            if kf.vel is not None:
                v_w[i] = kf.vel
            bg[i] = kf.bg - b0g
            ba_[i] = kf.ba - b0a
            state_valid[i] = True
        if fix_anchor:
            fixed[1:T] = False  # the window free but its oldest anchor
        else:
            fixed[:T] = False  # FullInertialBA: every chain state free

        E = Kp - 1
        dts = np.zeros(E, np.float32)
        dR = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
        dV = np.zeros((E, 3), np.float32)
        dP = np.zeros((E, 3), np.float32)
        J = {n: np.zeros((E, 3, 3), np.float32)
             for n in ["JRg", "JVg", "JVa", "JPg", "JPa"]}
        L9 = np.zeros((E, 9, 9), np.float32)
        Lb = np.zeros((E, 6, 6), np.float32)
        e_valid = np.zeros(E, bool)
        for i in range(T - 1):
            pre = kfs[i + 1].pre_kf
            if pre is None or kfs[i + 1].prev_kf != chain[i] or pre.dt <= 0:
                continue
            pre_c = _relinearize_np(pre, b0g, b0a)
            dts[i] = float(pre_c.dt)
            dR[i], dV[i], dP[i] = pre_c.dR, pre_c.dV, pre_c.dP
            for n in J:
                J[n][i] = getattr(pre_c, n)
            c = np.asarray(pre_c.cov, np.float64)
            info9 = np.linalg.inv(c[:9, :9] + 1e-12 * np.eye(9))
            L9[i] = np.linalg.cholesky(0.5 * (info9 + info9.T))
            info6 = np.linalg.inv(c[9:, 9:] + 1e-10 * np.eye(6))
            Lb[i] = np.linalg.cholesky(0.5 * (info6 + info6.T))
            e_valid[i] = True
        if e_valid.sum() < 1:
            return

        obs_cam, obs_pt, uv, ur, stereo, s2 = [], [], [], [], [], []
        obs_ref = []
        dropped_obs = 0
        for mp in pt_ids:
            for k, slot in m.obs.get(mp, {}).items():
                ci = cam_index.get(k)
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
                s2.append(m.scale_factor ** (2.0 * int(kf.octave[slot])))
                obs_ref.append((mp, k))
        if dropped_obs:
            verbose.print_mess(
                f"{name}: obs cap hit, dropped {dropped_obs} of "
                f"{dropped_obs + len(obs_cam)} observations",
                verbose.Level.NORMAL)
        n_obs = len(obs_cam)
        if n_obs < 20:
            return

        def pad(a, n, fill=0, dtype=None):
            a = np.asarray(a, dtype)
            out = np.full((n,) + a.shape[1:], fill, a.dtype)
            out[: len(a)] = a
            return out

        # one set of shapes for the local window; the full chain buckets to
        # powers of two
        P_pad = _bucket(len(pt_ids), lo=2048) if full_chain else IBA_MAX_PTS
        O_pad = _bucket(n_obs, lo=4096) if full_chain else IBA_MAX_OBS
        obs_cam = pad(obs_cam, O_pad, 0, np.int32)
        obs_pt = pad(obs_pt, O_pad, 0, np.int32)
        valid = pad(np.ones(n_obs, bool), O_pad, False)
        on_card = self.device.type == "cuda"
        arrays = dict(
            R_wb=R_wb, p_wb=p_wb, v_w=v_w, bg=bg, ba=ba_, fixed=fixed,
            state_valid=state_valid,
            X=pad(m.points.pos[pt_ids], P_pad, 0, np.float32),
            p_valid=pad(np.ones(len(pt_ids), bool), P_pad, False),
            obs_cam=obs_cam, obs_pt=obs_pt,
            uv=pad(uv, O_pad, 0.0, np.float32),
            ur=pad(ur, O_pad, 0.0, np.float32),
            stereo=pad(stereo, O_pad, False), valid=valid,
            inv_sigma2=(1.0 / pad(s2, O_pad, 1.0, np.float32)).astype(
                np.float32),
            dts=dts, dR=dR, dV=dV, dP=dP, L9=L9, Lb=Lb, e_valid=e_valid, **J)
        prob = viba.VIBAProblem(
            **{k: self._t(v) for k, v in arrays.items()},
            plan=(ba.segment_plan(obs_cam, obs_pt, valid, Kp, P_pad,
                                  self.device) if on_card else None))
        # the whole-chain solve moves much further: a larger LM and PCG
        # budget (it runs only at the initialization events)
        solve_kw = (dict(stage_iters=(8, 24), cg_iters=80) if full_chain
                    else dict(stage_iters=(5, 10), cg_iters=40))
        R_bc = self._t(cal.R_bc.astype(np.float32))
        t_bc = self._t(cal.t_bc.astype(np.float32))
        g = imu_ops.gravity_like(R_bc)
        if self._viba_graph is not None:
            bf = torch.tensor(float(self.bf), device=self.device)
            res = self._viba_graph(
                viba.problem_tensors(prob, R_bc, t_bc, g, bf), cam=self.cam,
                **solve_kw)
        else:
            res = viba.local_inertial_ba(prob, self.cam, R_bc, t_bc,
                                         float(self.bf), g, **solve_kw)
        res = fetch(res)
        for i, k in enumerate(cam_ids):
            if fixed[i]:
                continue
            kf = m.keyframes[k]
            Rn = lie.np_normalize_rotation(res.R_wb[i])
            kf.R, kf.t = np_body_to_cam(Rn, res.p_wb[i], cal.R_bc, cal.t_bc)
            kf.vel = res.v_w[i].astype(np.float32)
            kf.bg = (b0g + res.bg[i]).astype(np.float32)
            kf.ba = (b0a + res.ba[i]).astype(np.float32)
        alive = m.points.alive[pt_ids]
        ids_arr = np.asarray(pt_ids)
        m.points.pos[ids_arr[alive]] = res.X[: len(pt_ids)][alive]
        for o in np.nonzero(~res.inlier[:n_obs])[0]:
            mp, k = obs_ref[o]
            m.remove_observation(mp, k)
        for mp in pt_ids:
            if m.points.alive[mp]:
                m.update_point(mp)
        m.change_index += 1

    def merge_inertial_ba(self, curr_kid: int, merge_kid: int):
        """MergeInertialBA: the visual-inertial BA over a map weld's region,
        in two temporal windows, all free: Nd = 6 keyframes back from the
        current one, and Nd/2 before the matched (merge) keyframe extended
        forward by its successors up to 2*Nd states in all; each anchored
        by the fixed keyframe before it. The two prev_kf chains stay
        disjoint after a weld, so the windows couple through the fused
        landmarks of the welding region and the covisible fixed observers.
        A window without a predecessor gives up its oldest state as a fixed
        pose anchor."""
        m = self.map
        if curr_kid not in m.keyframes or merge_kid not in m.keyframes:
            return
        Nd = 6
        chain_a = self._kf_chain(curr_kid)
        win_a = chain_a[-Nd:]
        anchor_a = chain_a[-Nd - 1] if len(chain_a) > Nd else None
        chain_b = self._kf_chain(merge_kid)
        win_b = chain_b[-(Nd // 2):]
        anchor_b = chain_b[-(Nd // 2) - 1] if len(chain_b) > Nd // 2 else None
        # extend the merge window forward (the successor walk)
        nxt = {kf.prev_kf: k for k, kf in m.keyframes.items()
               if kf.prev_kf >= 0}
        seen = set(win_a) | set(win_b)
        while len(win_a) + len(win_b) < 2 * Nd:
            nk = nxt.get(win_b[-1])
            if nk is None or nk in seen:
                break
            win_b.append(nk)
            seen.add(nk)
        # an anchor-less window: its oldest state becomes a fixed pose
        if anchor_a is None and len(win_a) > 1:
            anchor_a = win_a.pop(0)
        if anchor_b is None and len(win_b) > 1:
            anchor_b = win_b.pop(0)
        anchors = [a for a in (anchor_b, anchor_a) if a is not None]
        chain = win_b + win_a
        if len(chain) < 3:
            return
        self._local_inertial_ba(
            curr_kid, chain_override=chain, force_fixed=anchors,
            fix_anchor=not anchors, total_slots=MERGE_IBA_SLOTS)

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
            cam.fx, cam.fy, cam.cx, cam.cy, self.bf, self.tri_max_dist,
            ratio=0.8, binary=self.profile.binary,
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
            max_dist=self.fuse_max_dist, ratio=0.9,
            binary=self.profile.binary,
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
        other KFs (the single-octave form of the scale-band check). In
        inertial mode the temporal chain stays: the culled KF's
        preintegration merges into its successor's, and a cull that would
        open a gap over 3 s or touch the 3 newest chain KFs is skipped."""
        inertial = self.imu_calib is not None
        recent = set(self._kf_chain(kid)[-3:]) if inertial else set()
        for ckid in self.map.covisible_kfs(kid):
            kf = self.map.keyframes.get(ckid)
            if kf is None or ckid == self.map.kf_origin or ckid == kid:
                continue
            succ = None
            if inertial:
                if ckid in recent:
                    continue
                succ = next((k for k in self.map.keyframes.values()
                             if k.prev_kf == ckid), None)
                prev = self.map.keyframes.get(kf.prev_kf)
                if succ is not None and prev is not None:
                    if succ.timestamp - prev.timestamp > 3.0:
                        continue
            mps = kf.mp_ids[kf.mp_ids >= 0]
            if len(mps) == 0:
                continue
            redundant = 0
            for mp in mps:
                if self.map.points.n_obs[int(mp)] >= 4:  # this KF + 3 others
                    redundant += 1
            if redundant > 0.9 * len(mps):
                if inertial and succ is not None:
                    if kf.pre_kf is not None and succ.pre_kf is not None:
                        succ.pre_kf = imu_ops.to_numpy(imu_ops.merge_previous(
                            imu_ops.to_tensors(kf.pre_kf, "cpu"),
                            imu_ops.to_tensors(succ.pre_kf, "cpu")))
                    succ.prev_kf = kf.prev_kf
                self.map.remove_keyframe(ckid)

"""The map data model: keyframes, map points, observations, covisibility.

A copy of ``xfeatslam_tpu/slam/map.py`` (host numpy, no device code; the
port keeps its own). The reference's pointer graph (ORB-SLAM3's
KeyFrame.cc, MapPoint.cc, Map.cc) becomes growable struct-of-arrays for
the map points, which ship to the device as padded snapshots;
observations are index pairs, and the covisibility graph is recounted
incrementally from shared observations (KeyFrame::UpdateConnections,
threshold 15). Single writer, no locks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np


@dataclass
class KeyFrame:
    """Persistent map node: frozen frame measurements + pose + graph links
    (role of ORB-SLAM3's KeyFrame.h)."""

    kid: int
    frame_id: int
    timestamp: float
    kpts_un: np.ndarray  # (K,2) undistorted pixels
    desc: np.ndarray  # (K,64)
    valid: np.ndarray  # (K,) bool
    ur: np.ndarray  # (K,) right-u, <0 if none
    depth: np.ndarray  # (K,) metric depth, <=0 if none
    angle: np.ndarray = None  # (K,) keypoint orientation (0 for XFeat)
    octave: np.ndarray = None  # (K,) pyramid level (0 for XFeat)
    R: np.ndarray = None  # (3,3) world->camera
    t: np.ndarray = None  # (3,)
    mp_ids: np.ndarray = None  # (K,) int64, -1 = none
    parent: int = -1  # spanning tree
    children: Set[int] = field(default_factory=set)
    loop_edges: Set[int] = field(default_factory=set)
    merge_edges: Set[int] = field(default_factory=set)
    bad: bool = False
    # retrieval descriptor: VLAD over a fixed random codebook
    # (retrieval.aggregate_global_desc), in place of a BoW vector
    global_desc: np.ndarray = None
    # inertial state: body velocity in world (None until IMU
    # initialization), gyro / acc bias, the preintegration from prev_kf
    # (ops.imu.Preintegrated of numpy arrays) and the chain predecessor
    vel: Optional[np.ndarray] = None
    bg: np.ndarray = None
    ba: np.ndarray = None
    pre_kf: object = None
    prev_kf: int = -1

    def __post_init__(self):
        if self.bg is None:
            self.bg = np.zeros(3, np.float32)
        if self.ba is None:
            self.ba = np.zeros(3, np.float32)
        if self.angle is None:
            self.angle = np.zeros(len(self.kpts_un), np.float32)
        if self.octave is None:
            self.octave = np.zeros(len(self.kpts_un), np.int32)
        if self.mp_ids is None:
            self.mp_ids = np.full(len(self.kpts_un), -1, np.int64)
        if self.global_desc is None:
            from .retrieval import aggregate_global_desc

            self.global_desc = aggregate_global_desc(self.desc, self.valid)

    def center(self) -> np.ndarray:
        return (-self.R.T @ self.t).astype(np.float32)


class MapPointStore:
    """Growable struct-of-arrays for map points (role of MapPoint.cc)."""

    def __init__(self, capacity: int = 4096, desc_dim: int = 64):
        self.desc_dim = desc_dim
        self._grow_to(capacity)
        self.n = 0
        self.free: List[int] = []

    def _grow_to(self, cap):
        if not hasattr(self, "pos"):
            self.cap = cap
            self.pos = np.zeros((cap, 3), np.float32)
            self.desc = np.zeros((cap, self.desc_dim), np.float32)
            self.normal = np.zeros((cap, 3), np.float32)
            self.dmin = np.zeros(cap, np.float32)
            self.dmax = np.zeros(cap, np.float32)
            self.n_obs = np.zeros(cap, np.int32)
            self.visible = np.zeros(cap, np.int32)
            self.found = np.zeros(cap, np.int32)
            self.alive = np.zeros(cap, bool)
            self.first_kf = np.full(cap, -1, np.int64)
            self.angle = np.zeros(cap, np.float32)
            self.octave = np.zeros(cap, np.int32)
            return
        old = self.cap
        new = max(cap, old * 2)
        for name in ["pos", "desc", "normal"]:
            a = getattr(self, name)
            b = np.zeros((new,) + a.shape[1:], a.dtype)
            b[:old] = a
            setattr(self, name, b)
        for name, dt, fill in [
            ("dmin", np.float32, 0), ("dmax", np.float32, 0),
            ("n_obs", np.int32, 0), ("visible", np.int32, 0),
            ("found", np.int32, 0), ("alive", bool, False),
            ("first_kf", np.int64, -1), ("angle", np.float32, 0),
            ("octave", np.int32, 0),
        ]:
            a = getattr(self, name)
            b = np.full((new,), fill, dt)
            b[:old] = a
            setattr(self, name, b)
        self.cap = new

    def alloc(self, pos, desc, first_kf=-1, angle=0.0) -> int:
        if self.free:
            i = self.free.pop()
        else:
            if self.n >= self.cap:
                self._grow_to(self.cap * 2)
            i = self.n
            self.n += 1
        self.pos[i] = pos
        self.desc[i] = desc
        self.normal[i] = 0
        self.dmin[i] = 0.0
        self.dmax[i] = 1e9
        self.n_obs[i] = 0
        self.visible[i] = 1
        self.found[i] = 1
        self.alive[i] = True
        self.first_kf[i] = first_kf
        self.angle[i] = angle
        return i

    def release(self, i):
        self.alive[i] = False
        self.free.append(i)


class SlamMap:
    """One SLAM map (role of Map.cc plus the observation bookkeeping of
    MapPoint and KeyFrame)."""

    COVIS_THRESHOLD = 15  # KeyFrame::UpdateConnections threshold

    def __init__(self, map_id: int = 0, desc_dim: int = 64,
                 scale_factor: float = 1.2, n_levels: int = 1):
        self.map_id = map_id
        self.desc_dim = desc_dim
        # extractor pyramid geometry: drives the scale-invariance band and
        # PredictScale (1 level for XFeat)
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.keyframes: Dict[int, KeyFrame] = {}
        self.points = MapPointStore(desc_dim=desc_dim)
        # mp_id -> {kf_id: slot}
        self.obs: Dict[int, Dict[int, int]] = {}
        # covisibility weights kf -> kf -> shared count
        self.covis: Dict[int, Dict[int, int]] = {}
        # culled-KF anchors: kid -> (parent_kid, R_cp, t_cp) with
        # T_kid = T_cp * T_parent recorded at cull time, the chain the
        # trajectory savers walk when a reference keyframe went bad
        self.culled: Dict[int, tuple] = {}
        # called as on_kf_removed(map_id, kid) after a KF is culled
        self.on_kf_removed = None
        self.kf_origin: Optional[int] = None
        self.change_index = 0
        # bumped only by whole-map frame changes (merges, IMU-init rescale)
        self.geometry_epoch = 0
        self.imu_initialized = False
        self.imu_ba1 = False
        self.imu_ba2 = False
        self.imu_bg = np.zeros(3, np.float32)
        self.imu_ba = np.zeros(3, np.float32)

    def apply_scaled_rotation(self, R_wg: np.ndarray, s: float):
        """Map::ApplyScaledRotation: rotate the world so gravity becomes
        (0,0,-9.81) and rescale it to metric.

        Convention: new world X' = s * R_wg^T @ X, so camera poses become
        R_cw' = R_cw @ R_wg, t_cw' = s * t_cw (camera-frame geometry scales
        uniformly by s) and velocities v' = s * R_wg^T @ v."""
        R_wg = np.asarray(R_wg, np.float32)
        s = float(s)
        for kf in self.keyframes.values():
            kf.R = (kf.R @ R_wg).astype(np.float32)
            kf.t = (s * kf.t).astype(np.float32)
            if kf.vel is not None:
                kf.vel = (s * (R_wg.T @ kf.vel)).astype(np.float32)
        alive = self.points.alive
        self.points.pos[alive] = s * (self.points.pos[alive] @ R_wg)
        self.points.normal[alive] = self.points.normal[alive] @ R_wg
        self.points.dmin[alive] *= s
        self.points.dmax[alive] *= s
        self.change_index += 1
        self.geometry_epoch += 1

    # -- keyframes ---------------------------------------------------------

    def add_keyframe(self, kf: KeyFrame):
        self.keyframes[kf.kid] = kf
        self.covis.setdefault(kf.kid, {})
        if self.kf_origin is None:
            self.kf_origin = kf.kid
        # register observations already present in kf.mp_ids
        for slot in np.nonzero(kf.mp_ids >= 0)[0]:
            self.add_observation(int(kf.mp_ids[slot]), kf.kid, int(slot),
                                 update_links=False)
        self.update_connections(kf.kid)
        self.change_index += 1

    def remove_keyframe(self, kid: int):
        """SetBadFlag semantics (KeyFrame.cc): drop observations, reconnect
        children to the grandparent, record the relative-to-parent anchor
        for trajectory re-basing, and notify the hook."""
        kf = self.keyframes[kid]
        parent = kf.parent if kf.parent in self.keyframes else -1
        if parent >= 0:
            pkf = self.keyframes[parent]
            R_cp = (kf.R @ pkf.R.T).astype(np.float32)
            t_cp = (kf.t - R_cp @ pkf.t).astype(np.float32)
        else:
            R_cp, t_cp = kf.R.copy(), kf.t.copy()
        self.culled[kid] = (parent, R_cp, t_cp)
        for slot in np.nonzero(kf.mp_ids >= 0)[0]:
            self.remove_observation(int(kf.mp_ids[slot]), kid)
        for other, _w in list(self.covis.get(kid, {}).items()):
            self.covis[other].pop(kid, None)
        self.covis.pop(kid, None)
        for ch in list(kf.children):
            child = self.keyframes.get(ch)
            if child is not None:
                child.parent = kf.parent
                if kf.parent >= 0:
                    self.keyframes[kf.parent].children.add(ch)
        if kf.parent >= 0:
            self.keyframes[kf.parent].children.discard(kid)
        kf.bad = True
        del self.keyframes[kid]
        self.change_index += 1
        if self.on_kf_removed is not None:
            self.on_kf_removed(self.map_id, kid)

    def update_connections(self, kid: int):
        """Recount shared map points with all other KFs; keep edges with
        weight >= 15 (or the single best), maintain the spanning tree
        (KeyFrame::UpdateConnections)."""
        kf = self.keyframes[kid]
        counts: Dict[int, int] = {}
        for mp in kf.mp_ids[kf.mp_ids >= 0]:
            for okf in self.obs.get(int(mp), {}):
                if okf != kid:
                    counts[okf] = counts.get(okf, 0) + 1
        if not counts:
            self.covis[kid] = {}
            return
        best_kf = max(counts, key=counts.get)
        edges = {k: w for k, w in counts.items() if w >= self.COVIS_THRESHOLD}
        if not edges:
            edges = {best_kf: counts[best_kf]}
        old = self.covis.get(kid, {})
        for k in old:
            if k in self.covis and kid in self.covis[k] and k not in edges:
                del self.covis[k][kid]
        self.covis[kid] = dict(edges)
        for k, w in edges.items():
            self.covis.setdefault(k, {})[kid] = w
        # spanning tree: the first connection becomes the parent
        if kf.parent < 0 and kid != self.kf_origin:
            kf.parent = best_kf
            self.keyframes[best_kf].children.add(kid)

    def covisible_kfs(self, kid: int, n: Optional[int] = None) -> List[int]:
        edges = self.covis.get(kid, {})
        order = sorted(edges, key=edges.get, reverse=True)
        return order if n is None else order[:n]

    # -- map points --------------------------------------------------------

    def create_point(self, pos, desc, first_kf=-1, angle=0.0,
                     octave: int = 0, dist_ref: float = None) -> int:
        """Allocate a landmark; when the creating view's distance is known,
        set the scale-invariance band at once (tracking creates depth
        points without update_point)."""
        mp = self.points.alloc(pos, desc, first_kf, angle)
        self.points.octave[mp] = octave
        if dist_ref is not None and dist_ref > 0:
            if self.n_levels > 1:
                dmax = dist_ref * (self.scale_factor ** int(octave))
                self.points.dmax[mp] = dmax
                self.points.dmin[mp] = dmax / (
                    self.scale_factor ** (self.n_levels - 1)
                )
            else:
                self.points.dmax[mp] = 2.0 * dist_ref
                self.points.dmin[mp] = 0.5 * dist_ref
        self.obs[mp] = {}
        self.change_index += 1
        return mp

    def _recount_obs(self, mp: int):
        """nObs with stereo observations counting double (an RGB-D
        keypoint carries a right coordinate and counts as two)."""
        n = 0
        for kid, slot in self.obs.get(mp, {}).items():
            kf = self.keyframes.get(kid)
            if kf is not None:
                n += 2 if kf.ur[slot] > 0 else 1
        self.points.n_obs[mp] = n

    def add_observation(self, mp: int, kid: int, slot: int,
                        update_links: bool = True):
        self.obs.setdefault(mp, {})[kid] = slot
        kf = self.keyframes[kid]
        kf.mp_ids[slot] = mp
        self._recount_obs(mp)
        if update_links:
            self.update_point(mp)

    def remove_observation(self, mp: int, kid: int):
        o = self.obs.get(mp)
        if o is None or kid not in o:
            return
        slot = o.pop(kid)
        kf = self.keyframes.get(kid)
        if kf is not None and kf.mp_ids[slot] == mp:
            kf.mp_ids[slot] = -1
        self._recount_obs(mp)
        if len(o) <= 1 and self.points.alive[mp]:
            # a point observed by <= 1 KF after erasure dies
            self.remove_point(mp)

    def remove_point(self, mp: int):
        for kid, slot in list(self.obs.get(mp, {}).items()):
            kf = self.keyframes.get(kid)
            if kf is not None and kf.mp_ids[slot] == mp:
                kf.mp_ids[slot] = -1
        self.obs.pop(mp, None)
        if self.points.alive[mp]:
            self.points.release(mp)
        self.change_index += 1

    def replace_point(self, old: int, new: int):
        """MapPoint::Replace: rebind all observations of ``old`` to ``new``
        (unless the KF already sees ``new``)."""
        if old == new:
            return
        for kid, slot in list(self.obs.get(old, {}).items()):
            kf = self.keyframes.get(kid)
            if kf is None:
                continue
            if kid not in self.obs.get(new, {}):
                kf.mp_ids[slot] = new
                self.obs.setdefault(new, {})[kid] = slot
            else:
                kf.mp_ids[slot] = -1
        self.points.found[new] += self.points.found[old]
        self.points.visible[new] += self.points.visible[old]
        self.obs.pop(old, None)
        if self.points.alive[old]:
            self.points.release(old)
        self._recount_obs(new)
        self.update_point(new)

    def update_point(self, mp: int):
        """ComputeDistinctiveDescriptors + UpdateNormalAndDepth: the
        median-distance descriptor among the observations; viewing normal =
        mean direction; scale band from the reference KF's distance
        (single-octave XFeat: band = [d/2, 2d])."""
        o = self.obs.get(mp, {})
        if not o:
            return
        descs = []
        dirs = []
        pos = self.points.pos[mp]
        for kid, slot in o.items():
            kf = self.keyframes.get(kid)
            if kf is None:
                continue
            descs.append(kf.desc[slot])
            d = pos - kf.center()
            n = np.linalg.norm(d)
            if n > 1e-9:
                dirs.append(d / n)
        if not descs:
            return
        D = np.stack(descs)
        if len(D) == 1:
            best = 0
        else:
            dist = np.linalg.norm(D[:, None] - D[None, :], axis=-1)
            best = int(np.argmin(np.median(dist, axis=1)))
        self.points.desc[mp] = D[best]
        best_kid = list(o.keys())[best] if best < len(o) else next(iter(o))
        bkf = self.keyframes.get(best_kid)
        if bkf is not None:
            self.points.angle[mp] = bkf.angle[o[best_kid]]
        if dirs:
            nrm = np.mean(dirs, axis=0)
            n = np.linalg.norm(nrm)
            self.points.normal[mp] = nrm / n if n > 1e-9 else nrm
        ref_kid = min(o)
        ref_kf = self.keyframes[ref_kid]
        dist_ref = float(np.linalg.norm(pos - ref_kf.center()))
        oct_ref = int(ref_kf.octave[o[ref_kid]])
        self.points.octave[mp] = oct_ref
        if self.n_levels > 1:
            # MapPoint::UpdateNormalAndDepth: dmax = dist * sf^octave,
            # dmin = dmax / sf^(nLevels-1)
            dmax = dist_ref * (self.scale_factor ** oct_ref)
            self.points.dmax[mp] = dmax
            self.points.dmin[mp] = dmax / (
                self.scale_factor ** (self.n_levels - 1)
            )
        else:
            # single-scale backend: a symmetric distance band
            self.points.dmax[mp] = 2.0 * dist_ref
            self.points.dmin[mp] = 0.5 * dist_ref

    def predict_scale(self, mp_ids: np.ndarray, dists: np.ndarray) -> np.ndarray:
        """MapPoint::PredictScale: level = ceil(log(dmax/dist)/log(sf)),
        clipped to the pyramid."""
        ratio = self.points.dmax[mp_ids] / np.maximum(dists, 1e-9)
        level = np.ceil(
            np.log(np.maximum(ratio, 1e-9)) / np.log(self.scale_factor)
        )
        return np.clip(level, 0, self.n_levels - 1).astype(np.int32)

    # -- snapshots for the device ---------------------------------------------

    def point_snapshot(self, ids: np.ndarray, pad_to: int):
        """Padded (pos, desc, valid, ids) arrays for a set of map points."""
        ids = np.asarray(ids, np.int64)[:pad_to]
        n = len(ids)
        pos = np.zeros((pad_to, 3), np.float32)
        desc = np.zeros((pad_to, self.desc_dim), np.float32)
        valid = np.zeros(pad_to, bool)
        out_ids = np.full(pad_to, -1, np.int64)
        if n:
            alive = self.points.alive[ids]
            pos[:n] = self.points.pos[ids]
            desc[:n] = self.points.desc[ids]
            valid[:n] = alive
            out_ids[:n] = ids
        return pos, desc, valid, out_ids

    def num_keyframes(self):
        return len(self.keyframes)

    def num_points(self):
        return int(self.points.alive.sum())

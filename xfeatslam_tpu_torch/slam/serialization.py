"""Atlas checkpoint and resume: whole-map save and load.

Counterpart of ``xfeatslam_tpu/slam/serialization.py`` (the role of
System::SaveAtlas / LoadAtlas), in the same file format: one zip holding
``atlas.json``, an optional ``codebook.npy`` and one compressed npz per
map (keyframe measurements, poses, the point store, the observation index)
with a json header whose config checksum is computed from the same string
as the JAX package's. So an atlas saved by either package loads in the
other. Host numpy only.

The pyramid state of an ORB map goes in keys of the port's own, which the
JAX package's loader does not read: each keyframe's keypoint octaves
(``kf{kid}_octave``) and the points' octave and scale band
(``pts_octave``, ``pts_dmin``, ``pts_dmax``), without which a loaded
8-level map would predict every point at octave 0. A file without them
(the JAX package's) loads with zeros there, as the JAX package loads it;
the atlas takes the maps' pyramid geometry from their headers.

A keyframe's inertial state travels too: its velocity and biases
(``kf{kid}_imu``), its chain link (``kf{kid}_meta``) and its preintegration
from the previous keyframe (``kf{kid}_pre``) as the JAX package's flat
292-float record (dt, dR, dV, dP, cov15, JRg, JVg, JVa, JPg, JPa, bg, ba;
empty without one), with the map's IMU flags and biases in the header.
"""

from __future__ import annotations

import hashlib
import io
import json
import zipfile

import numpy as np

from ..ops.imu import Preintegrated
from .atlas import Atlas
from .map import KeyFrame, SlamMap

FORMAT_VERSION = 1
# the checksum's namespace: the JAX package's name, so both packages accept
# each other's files
_CHECKSUM_TAG = "xfeatslam_tpu"
# the flat record of a preintegration: each field's shape, in file order
_PRE_SHAPES = ((), (3, 3), (3,), (3,), (15, 15), (3, 3), (3, 3), (3, 3),
               (3, 3), (3, 3), (3,), (3,))
PRE_RECORD_SIZE = sum(int(np.prod(s)) for s in _PRE_SHAPES)  # 292


def _config_checksum(desc_dim: int) -> str:
    """Stands in for the reference's vocabulary MD5 gate: a load into a
    mismatched descriptor setup must fail loudly."""
    return hashlib.md5(
        f"{_CHECKSUM_TAG}:v{FORMAT_VERSION}:d{desc_dim}".encode()).hexdigest()


def flatten_pre(pre) -> np.ndarray:
    """A host ``Preintegrated`` as the flat float32 (292,) record."""
    return np.concatenate([np.asarray(a, np.float32).reshape(-1)
                           for a in pre])


def unflatten_pre(v: np.ndarray) -> Preintegrated:
    """The flat (292,) record as a host ``Preintegrated`` (dt a float32
    scalar, the rest float32 arrays)."""
    v = np.asarray(v, np.float32)
    if v.shape != (PRE_RECORD_SIZE,):
        raise ValueError(f"a preintegration record has {PRE_RECORD_SIZE} "
                         f"floats, not {v.shape}")
    fields, i = [], 0
    for shape in _PRE_SHAPES:
        n = int(np.prod(shape))
        fields.append(v[i:i + n].reshape(shape).copy())
        i += n
    fields[0] = np.float32(fields[0])
    return Preintegrated(*fields)


def save_map(m: SlamMap, f):
    kids = sorted(m.keyframes)
    kf_blobs = {}
    for kid in kids:
        kf = m.keyframes[kid]
        kf_blobs[f"kf{kid}_kpts_un"] = kf.kpts_un
        kf_blobs[f"kf{kid}_desc"] = kf.desc
        kf_blobs[f"kf{kid}_valid"] = kf.valid
        kf_blobs[f"kf{kid}_ur"] = kf.ur
        kf_blobs[f"kf{kid}_depth"] = kf.depth
        kf_blobs[f"kf{kid}_angle"] = kf.angle
        kf_blobs[f"kf{kid}_octave"] = kf.octave
        kf_blobs[f"kf{kid}_R"] = kf.R
        kf_blobs[f"kf{kid}_t"] = kf.t
        kf_blobs[f"kf{kid}_mp"] = kf.mp_ids
        kf_blobs[f"kf{kid}_meta"] = np.array(
            [kf.frame_id, kf.parent, kf.prev_kf], np.int64)
        kf_blobs[f"kf{kid}_ts"] = np.float64(kf.timestamp)
        # inertial state: velocity (nan when not estimated), biases and the
        # flat preintegration from prev_kf (empty without one)
        vel = np.full(3, np.nan, np.float32) if kf.vel is None else kf.vel
        kf_blobs[f"kf{kid}_imu"] = np.concatenate(
            [vel, kf.bg, kf.ba]).astype(np.float32)
        kf_blobs[f"kf{kid}_pre"] = (np.zeros(0, np.float32)
                                    if kf.pre_kf is None
                                    else flatten_pre(kf.pre_kf))
    n = m.points.n
    obs_flat = []
    for mp, o in m.obs.items():
        for kid, slot in o.items():
            obs_flat.append((mp, kid, slot))
    np.savez_compressed(
        f,
        header=np.bytes_(json.dumps({
            "version": FORMAT_VERSION,
            "map_id": m.map_id,
            "desc_dim": m.desc_dim,
            "scale_factor": m.scale_factor,
            "n_levels": m.n_levels,
            "kf_ids": kids,
            "kf_origin": m.kf_origin,
            "imu_initialized": m.imu_initialized,
            "imu_ba1": m.imu_ba1,
            "imu_ba2": m.imu_ba2,
            "imu_bg": [float(x) for x in m.imu_bg],
            "imu_ba": [float(x) for x in m.imu_ba],
            "checksum": _config_checksum(m.desc_dim),
        }).encode()),
        pts_pos=m.points.pos[:n],
        pts_desc=m.points.desc[:n],
        pts_normal=m.points.normal[:n],
        pts_nobs=m.points.n_obs[:n],
        pts_alive=m.points.alive[:n],
        pts_first=m.points.first_kf[:n],
        pts_angle=m.points.angle[:n],
        pts_octave=m.points.octave[:n],
        pts_dmin=m.points.dmin[:n],
        pts_dmax=m.points.dmax[:n],
        obs=np.asarray(obs_flat, np.int64).reshape(-1, 3),
        **kf_blobs,
    )


def load_map(f) -> SlamMap:
    data = np.load(f, allow_pickle=False)
    header = json.loads(bytes(data["header"]).decode())
    if header["checksum"] != _config_checksum(header["desc_dim"]):
        raise ValueError("atlas checkpoint checksum mismatch "
                         "(incompatible descriptor configuration)")
    m = SlamMap(map_id=header["map_id"], desc_dim=header["desc_dim"],
                scale_factor=header.get("scale_factor", 1.2),
                n_levels=header.get("n_levels", 1))
    for kid in header["kf_ids"]:
        meta = data[f"kf{kid}_meta"]
        kf = KeyFrame(
            kid=kid,
            frame_id=int(meta[0]),
            timestamp=float(data[f"kf{kid}_ts"]),
            kpts_un=data[f"kf{kid}_kpts_un"],
            desc=data[f"kf{kid}_desc"],
            valid=data[f"kf{kid}_valid"],
            ur=data[f"kf{kid}_ur"],
            depth=data[f"kf{kid}_depth"],
            angle=data[f"kf{kid}_angle"],
            R=data[f"kf{kid}_R"],
            t=data[f"kf{kid}_t"],
            mp_ids=data[f"kf{kid}_mp"].copy(),
            octave=data.get(f"kf{kid}_octave"),
        )
        kf.parent = int(meta[1])
        if len(meta) > 2:
            kf.prev_kf = int(meta[2])
        imu = data.get(f"kf{kid}_imu")
        if imu is not None:
            if np.isfinite(imu[0]):
                kf.vel = imu[0:3].copy()
            kf.bg = imu[3:6].copy()
            kf.ba = imu[6:9].copy()
        pre = data.get(f"kf{kid}_pre")
        if pre is not None and len(pre):
            kf.pre_kf = unflatten_pre(pre)
        m.keyframes[kid] = kf
        m.covis.setdefault(kid, {})
    m.kf_origin = header["kf_origin"]
    m.imu_initialized = bool(header.get("imu_initialized", False))
    m.imu_ba1 = bool(header.get("imu_ba1", False))
    m.imu_ba2 = bool(header.get("imu_ba2", False))
    m.imu_bg = np.asarray(header.get("imu_bg", [0, 0, 0]), np.float32)
    m.imu_ba = np.asarray(header.get("imu_ba", [0, 0, 0]), np.float32)
    # point store
    n = len(data["pts_pos"])
    while m.points.cap < n:
        m.points._grow_to(m.points.cap * 2)
    m.points.n = n
    m.points.pos[:n] = data["pts_pos"]
    m.points.desc[:n] = data["pts_desc"]
    m.points.normal[:n] = data["pts_normal"]
    m.points.n_obs[:n] = data["pts_nobs"]
    m.points.alive[:n] = data["pts_alive"]
    m.points.first_kf[:n] = data["pts_first"]
    m.points.angle[:n] = data["pts_angle"]
    for name in ("octave", "dmin", "dmax"):
        if f"pts_{name}" in data:
            getattr(m.points, name)[:n] = data[f"pts_{name}"]
    m.points.free = [i for i in range(n) if not m.points.alive[i]]
    # observations and the graph links (Atlas::PostLoad)
    for (mp, kid, slot) in data["obs"]:
        if m.points.alive[mp] and kid in m.keyframes:
            m.obs.setdefault(int(mp), {})[int(kid)] = int(slot)
    for kid in header["kf_ids"]:
        kf = m.keyframes[kid]
        if kf.parent >= 0 and kf.parent in m.keyframes:
            m.keyframes[kf.parent].children.add(kid)
        m.update_connections(kid)
    return m


def save_atlas(atlas: Atlas, path: str):
    """One zip holding each map as an npz. A data-derived retrieval
    codebook, when installed, travels with the file: the stored global
    descriptors were aggregated under it."""
    from . import retrieval

    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        meta = {
            "version": FORMAT_VERSION,
            "desc_dim": atlas.desc_dim,
            "active_id": atlas.active_id,
            "map_ids": sorted(atlas.maps),
        }
        z.writestr("atlas.json", json.dumps(meta))
        cb = retrieval.installed_codebook(atlas.desc_dim)
        if cb is not None:
            buf = io.BytesIO()
            np.save(buf, cb)
            z.writestr("codebook.npy", buf.getvalue())
        for mid, m in atlas.maps.items():
            buf = io.BytesIO()
            save_map(m, buf)
            z.writestr(f"map{mid}.npz", buf.getvalue())


def load_atlas(path: str) -> Atlas:
    from . import retrieval

    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("atlas.json").decode())
        atlas = Atlas(desc_dim=meta["desc_dim"])
        atlas.maps.clear()
        cb = None
        if "codebook.npy" in z.namelist():
            cb = np.load(io.BytesIO(z.read("codebook.npy")))
        for mid in meta["map_ids"]:
            buf = io.BytesIO(z.read(f"map{mid}.npz"))
            atlas.maps[mid] = load_map(buf)
        if atlas.maps:
            # maps made after the load share the loaded maps' pyramid
            m = atlas.maps[meta["map_ids"][0]]
            atlas.scale_factor, atlas.n_levels = m.scale_factor, m.n_levels
        atlas.active_id = meta["active_id"]
        atlas._next_map_id = (max(meta["map_ids"]) + 1 if meta["map_ids"]
                              else 0)
    # install the file's codebook only after every map loaded (a failed
    # load must not change the process-wide registry); a file without one
    # restores the seeded default its globals were aggregated under
    retrieval.use_codebook(cb, dim=atlas.desc_dim)
    return atlas

"""The PyTorch port's atlas files (``slam/serialization.py``) against the JAX
package's: the same zip-of-npz format and the same config checksum, so an
atlas saved by either package loads in the other with every array equal
(keyframe measurements, poses, slot bindings, the point store, the
observations and the covisibility rebuilt from them). Then a port System
saves its atlas and a second System resumes from the file: the same maps,
one retrieval index over every keyframe, tracking LOST until it
relocalizes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xfeatslam_tpu.slam import atlas as jatlas  # noqa: E402
from xfeatslam_tpu.slam import serialization as jser  # noqa: E402
from xfeatslam_tpu.utils import synthetic as jsyn  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402
from xfeatslam_tpu_torch.slam import atlas as tatlas  # noqa: E402
from xfeatslam_tpu_torch.slam import serialization as tser  # noqa: E402
from xfeatslam_tpu_torch.slam import settings as tset  # noqa: E402
from xfeatslam_tpu_torch.slam import system as tsys  # noqa: E402
from xfeatslam_tpu_torch.slam.tracking import State  # noqa: E402
from xfeatslam_tpu_torch.utils import synthetic as tsyn  # noqa: E402

KF_FIELDS = ("kpts_un", "desc", "valid", "ur", "depth", "angle", "R", "t",
             "mp_ids", "global_desc")
PT_FIELDS = ("pos", "desc", "normal", "n_obs", "alive", "first_kf", "angle")


def two_maps(syn, atlas_mod):
    """An atlas of two loop maps (the second with a culled keyframe, the
    first active), built by one package."""
    atlas = atlas_mod.Atlas(desc_dim=64)
    atlas.maps.clear()
    for mid, seed in ((0, 0), (1, 3)):
        m, _, _ = syn.make_loop_map(np.random.default_rng(seed), n_kf=10,
                                    n_pts=300, bf=40.0)
        m.map_id = mid
        atlas.maps[mid] = m
    atlas.maps[1].remove_keyframe(4)
    atlas.active_id = 0
    atlas._next_map_id = 2
    return atlas


def assert_same_atlas(a, b):
    assert sorted(a.maps) == sorted(b.maps) and a.active_id == b.active_id
    for mid, ma in a.maps.items():
        mb = b.maps[mid]
        assert sorted(ma.keyframes) == sorted(mb.keyframes)
        assert ma.kf_origin == mb.kf_origin and ma.map_id == mb.map_id
        for k, ka in ma.keyframes.items():
            kb = mb.keyframes[k]
            for f in KF_FIELDS:
                x, y = getattr(ka, f), getattr(kb, f)
                assert x.dtype == y.dtype and np.array_equal(x, y), f
            assert (ka.frame_id, ka.timestamp, ka.parent, ka.children) == (
                kb.frame_id, kb.timestamp, kb.parent, kb.children)
        n = ma.points.n
        assert n == mb.points.n
        for f in PT_FIELDS:
            assert np.array_equal(getattr(ma.points, f)[:n],
                                  getattr(mb.points, f)[:n]), f
        assert ma.obs == mb.obs
        assert ma.covis == mb.covis


def test_jax_atlas_loads_in_port(tmp_path):
    path = str(tmp_path / "jax.osa")
    ref = two_maps(jsyn, jatlas)
    jser.save_atlas(ref, path)
    got = tser.load_atlas(path)
    assert isinstance(got, tatlas.Atlas)
    assert_same_atlas(jser.load_atlas(path), got)


def test_port_atlas_loads_in_jax(tmp_path):
    path = str(tmp_path / "port.osa")
    src = two_maps(tsyn, tatlas)
    tser.save_atlas(src, path)
    got = jser.load_atlas(path)
    assert_same_atlas(tser.load_atlas(path), got)
    # and the port's reload is the map it saved
    for mid, m in src.maps.items():
        for k, kf in m.keyframes.items():
            np.testing.assert_array_equal(got.maps[mid].keyframes[k].t, kf.t)


def test_checksum_is_the_jax_packages():
    for d in (64, 256):
        assert tser._config_checksum(d) == jser._config_checksum(d)


def test_system_atlas_round_trip(tmp_path):
    Km = [517.3 * 0.25, 516.5 * 0.25, 318.6 * 0.25, 255.3 * 0.25]
    settings = tset.Settings(cam=tc.Pinhole.from_list(Km), bf=10.0,
                             depth_map_factor=1.0, n_features=100)
    a = tsys.System(settings, tsys.Sensor.RGBD, device="cpu")
    assert a.loop_closing is not None  # loop closing is on by default
    m, _, _ = tsyn.make_loop_map(np.random.default_rng(0), n_kf=8,
                                 n_pts=200, bf=10.0)
    m.map_id = a.map.map_id
    a.atlas.maps[m.map_id] = m
    path = str(tmp_path / "system.osa")
    a.save_atlas(path)
    b = tsys.System(settings, tsys.Sensor.RGBD, device="cpu")
    b.load_atlas(path)
    assert_same_atlas(a.atlas, b.atlas)
    assert b.map is b.atlas.active and b.tracking.map is b.map
    assert b.loop_closing.map is b.map
    assert b.tracking.state == State.LOST
    # one index over every keyframe, shared by relocalization
    assert b.tracking.retrieval is b.loop_closing.retrieval
    assert sorted(b.loop_closing.retrieval._index) == sorted(
        (m.map_id, k) for k in m.keyframes)
    # culling a loaded keyframe evicts it from the new index
    b.map.remove_keyframe(3)
    assert (m.map_id, 3) not in b.loop_closing.retrieval._index
    assert b.shutdown()["loops_closed"] == 0

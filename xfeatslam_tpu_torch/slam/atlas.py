"""Atlas: the multi-map container (role of ORB-SLAM3's Atlas.cc).

A copy of ``xfeatslam_tpu/slam/atlas.py``: the active map plus the maps
frozen after tracking loss. ``System`` builds one even without loop
closing; map merging comes with the loop-closing slice.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from .map import SlamMap


class Atlas:
    def __init__(self, desc_dim: int = 64, scale_factor: float = 1.2,
                 n_levels: int = 1):
        self.desc_dim = desc_dim
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self._next_map_id = 0
        self.maps: Dict[int, SlamMap] = {}
        self.active_id: Optional[int] = None
        # KF-removal hook shared by every map, called as hook(map_id, kid)
        self.kf_removed_hook: Optional[Callable[[int, int], None]] = None
        # map-merge record: dissolved_map_id -> (absorbing_map_id,
        # kid_offset), chased by trajectory resolution
        self.remaps: Dict[int, Tuple[int, int]] = {}
        self.create_new_map()

    @property
    def active(self) -> SlamMap:
        return self.maps[self.active_id]

    def create_new_map(self) -> SlamMap:
        """Freeze the current map and start a fresh one
        (Tracking::CreateMapInAtlas)."""
        m = SlamMap(map_id=self._next_map_id, desc_dim=self.desc_dim,
                    scale_factor=self.scale_factor, n_levels=self.n_levels)
        m.on_kf_removed = self._dispatch_kf_removed
        self.maps[m.map_id] = m
        self.active_id = m.map_id
        self._next_map_id += 1
        return m

    def _dispatch_kf_removed(self, map_id: int, kid: int):
        if self.kf_removed_hook is not None:
            self.kf_removed_hook(map_id, kid)

    def change_map(self, map_id: int):
        """Relocalized into a stored map (Atlas::ChangeMap)."""
        assert map_id in self.maps
        self.active_id = map_id

    def remove_map(self, map_id: int):
        del self.maps[map_id]

    def all_maps(self) -> List[SlamMap]:
        return list(self.maps.values())

    def total_keyframes(self):
        return sum(m.num_keyframes() for m in self.maps.values())

    def total_points(self):
        return sum(m.num_points() for m in self.maps.values())

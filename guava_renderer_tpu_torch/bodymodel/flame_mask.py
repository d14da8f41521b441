"""FLAME region masks (counterpart of `guava_renderer_tpu/bodymodel/flame_mask.py`).

Loads FLAME_masks.pkl (region -> vertex ids) through the asset unpickler,
adds the lip rings of `flame_regions.py`, and answers order-preserving
vertex queries and face queries.
"""

from __future__ import annotations

import os

import numpy as np

from .data import _as_array, load_asset_pickle
from .flame_regions import LIP_OUTSIDE_RING_LOWER, LIP_OUTSIDE_RING_UPPER

_EXTRA_REGIONS = {
    "lip_outside_ring_upper": LIP_OUTSIDE_RING_UPPER,
    "lip_outside_ring_lower": LIP_OUTSIDE_RING_LOWER,
}


class FlameMask:
    def __init__(self, masks_path: str | None = None, faces: np.ndarray | None = None):
        self.regions: dict[str, np.ndarray] = {}
        if masks_path and os.path.exists(masks_path):
            for k, v in load_asset_pickle(masks_path).items():
                self.regions[k] = _as_array(v).astype(np.int64)
        self.regions.update({k: np.asarray(v, np.int64) for k, v in _EXTRA_REGIONS.items()})
        self.faces = None if faces is None else np.asarray(faces)

    def region_names(self) -> list[str]:
        return sorted(self.regions)

    def get_vid_by_region(self, regions: list[str], keep_order: bool = True) -> np.ndarray:
        """Vertex ids of the union of regions. keep_order=True keeps each
        region's stored order (the teeth read the lip rings in order);
        False returns the sorted unique union."""
        parts = [self.regions[r] for r in regions]
        cat = np.concatenate(parts) if parts else np.zeros(0, np.int64)
        if keep_order:
            _, first = np.unique(cat, return_index=True)
            return cat[np.sort(first)] if len(regions) > 1 else cat
        return np.unique(cat)

    def get_fid_by_region(self, regions: list[str], all_vertices: bool = True) -> np.ndarray:
        """Face ids inside (all_vertices=True) or touching the region."""
        if self.faces is None:
            raise ValueError("construct FlameMask with faces to query face ids")
        member = np.isin(self.faces, self.get_vid_by_region(regions, keep_order=False))
        hit = member.all(1) if all_vertices else member.any(1)
        return np.nonzero(hit)[0]

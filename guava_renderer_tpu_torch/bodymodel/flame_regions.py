"""FLAME 2020 topology vertex-id constants (the port's own copy of
`guava_renderer_tpu/bodymodel/flame_regions.py`).

Mesh-topology labels of the standard 5023-vertex FLAME 2020 template (the
public vertex numbering of the FLAME ecosystem); asset data, not code. The
teeth graft reads the outer lip rings (15 vertices each, left to right).
"""

import numpy as np

LIP_OUTSIDE_RING_UPPER = np.array(
    [1713, 1715, 1716, 1735, 1696, 1694, 1657, 3543, 2774, 2811, 2813, 2850, 2833, 2832, 2830],
    np.int32,
)

LIP_OUTSIDE_RING_LOWER = np.array(
    [1576, 1577, 1773, 1774, 1795, 1802, 1865, 3503, 2948, 2905, 2898, 2881, 2880, 2713, 2712],
    np.int32,
)

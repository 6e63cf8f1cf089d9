"""SAH of a binary BVH, with the reference's constants.

The part of ``mcpt/bvh/metrics.py`` that the cluster planner and the tests
need.  EPO, LCV and the BVH quality harness are ported with Slice 4.
"""

from __future__ import annotations

import numpy as np

C_INN = 1.2  # internal-node traversal cost (auxiliary.h:9-11)
C_TRI = 1.0  # triangle-intersection cost


def _area(bbmin, bbmax):
    d = np.maximum(bbmax - bbmin, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def sah(bvh) -> float:
    """``(Σ_internal C_INN·A(n) + Σ_leaf C_TRI·A(n)) / A(root)``
    (``bvhtest.cpp:104-115``)."""
    bbmin = bvh.bbmin.cpu().numpy()
    bbmax = bvh.bbmax.cpu().numpy()
    n_internal = bbmin.shape[0] // 2  # == N-1 for 2N-1 nodes
    areas = _area(bbmin, bbmax)
    total = C_INN * areas[:n_internal].sum() + C_TRI * areas[n_internal:].sum()
    return float(total / max(areas[0], 1e-30))

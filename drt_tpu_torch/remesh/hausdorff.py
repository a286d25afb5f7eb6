"""Hausdorff / mean surface-distance evaluation (the port's own copy of
drt_tpu/remesh/hausdorff.py).

The reference's accuracy protocol is manual: README.md:13 instructs running
meshlabserver's Hausdorff filter between the reconstruction and the scan
ground truth. This module makes it a one-call in-process evaluation
(vertex-sampled point-to-surface distances, the same protocol MeshLab's
default Hausdorff filter uses).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from drt_tpu_torch.remesh.surface import SurfaceIndex


class DistanceStats(NamedTuple):
    mean: float
    rms: float
    max: float


def point_mesh_distance(points: np.ndarray, vertices: np.ndarray,
                        faces: np.ndarray) -> np.ndarray:
    """Distance from each point to the surface (exact point-triangle over
    KDTree candidates)."""
    _, d = SurfaceIndex(vertices, faces).closest_points(points)
    return d


def hausdorff_distance(v_a, f_a, v_b, f_b,
                       symmetric: bool = True) -> DistanceStats:
    """Vertex-sampled surface distance A->B (and B->A if symmetric; the
    combined stats take the max/mean over both directions, matching the
    usual symmetric-Hausdorff reporting)."""
    d_ab = point_mesh_distance(np.asarray(v_a, np.float64), v_b, f_b)
    if not symmetric:
        return DistanceStats(float(d_ab.mean()),
                             float(np.sqrt((d_ab ** 2).mean())),
                             float(d_ab.max()))
    d_ba = point_mesh_distance(np.asarray(v_b, np.float64), v_a, f_a)
    mean = 0.5 * (d_ab.mean() + d_ba.mean())
    rms = np.sqrt(0.5 * ((d_ab ** 2).mean() + (d_ba ** 2).mean()))
    mx = max(d_ab.max(), d_ba.max())
    return DistanceStats(float(mean), float(rms), float(mx))

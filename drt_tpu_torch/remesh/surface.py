"""Closest-point-on-surface queries (host, numpy + scipy KDTree; the port's
own copy of drt_tpu/remesh/surface.py).

Used by the remesher's reproject step (the reference delegates this to
meshlabserver's ReprojectFlag, optim.py:30) and by the Hausdorff evaluation
(the reference's manual meshlabserver protocol, README.md:13).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def closest_point_on_triangles(p: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Exact closest point on each triangle to each query point.

    p: [N,3]; tri: [N,3,3] (one candidate triangle per point).
    Returns [N,3]. Vectorized Ericson-style region classification.
    """
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    ab = b - a
    ac = c - a
    ap = p - a

    d1 = np.einsum("ij,ij->i", ab, ap)
    d2 = np.einsum("ij,ij->i", ac, ap)

    bp = p - b
    d3 = np.einsum("ij,ij->i", ab, bp)
    d4 = np.einsum("ij,ij->i", ac, bp)

    cp = p - c
    d5 = np.einsum("ij,ij->i", ab, cp)
    d6 = np.einsum("ij,ij->i", ac, cp)

    out = np.empty_like(p)
    done = np.zeros(len(p), dtype=bool)

    def setw(m, val):
        m = m & ~done
        out[m] = val[m] if val.ndim == 2 else val
        done[m] = True

    # vertex regions
    setw((d1 <= 0) & (d2 <= 0), a)
    setw((d3 >= 0) & (d4 <= d3), b)
    setw((d6 >= 0) & (d5 <= d6), c)

    # edge AB
    vc = d1 * d4 - d3 * d2
    m = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    w = np.divide(d1, d1 - d3, out=np.zeros_like(d1),
                  where=np.abs(d1 - d3) > 1e-300)
    setw(m, a + w[:, None] * ab)

    # edge AC
    vb = d5 * d2 - d1 * d6
    m = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    w = np.divide(d2, d2 - d6, out=np.zeros_like(d2),
                  where=np.abs(d2 - d6) > 1e-300)
    setw(m, a + w[:, None] * ac)

    # edge BC
    va = d3 * d6 - d5 * d4
    m = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    denom = (d4 - d3) + (d5 - d6)
    w = np.divide(d4 - d3, denom, out=np.zeros_like(denom),
                  where=np.abs(denom) > 1e-300)
    setw(m, b + w[:, None] * (c - b))

    # interior
    denom = va + vb + vc
    v = np.divide(vb, denom, out=np.zeros_like(denom),
                  where=np.abs(denom) > 1e-300)
    w = np.divide(vc, denom, out=np.zeros_like(denom),
                  where=np.abs(denom) > 1e-300)
    setw(np.ones(len(p), dtype=bool), a + v[:, None] * ab + w[:, None] * ac)
    return out


class SurfaceIndex:
    """Spatial index of a triangle mesh for closest-point queries: KDTree on
    triangle centroids; exact point-triangle distance on the k nearest
    candidates."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray, k: int = 8):
        self.vertices = np.asarray(vertices, dtype=np.float64)
        self.faces = np.asarray(faces, dtype=np.int64)
        self.tri = self.vertices[self.faces]           # [F,3,3]
        self.centroids = self.tri.mean(axis=1)
        self.tree = cKDTree(self.centroids)
        # candidate count adapts below to mesh size
        self.k = min(k, len(self.faces))

    def closest_points(self, p: np.ndarray):
        """Returns (points [N,3], dists [N]) — closest surface points."""
        p = np.asarray(p, dtype=np.float64)
        _, idx = self.tree.query(p, k=self.k)          # [N,k]
        if self.k == 1:
            idx = idx[:, None]
        N, k = idx.shape
        cand_tri = self.tri[idx.reshape(-1)]           # [N*k,3,3]
        pts = closest_point_on_triangles(
            np.repeat(p, k, axis=0), cand_tri).reshape(N, k, 3)
        d2 = np.sum((pts - p[:, None, :]) ** 2, axis=2)
        best = np.argmin(d2, axis=1)
        rows = np.arange(N)
        return pts[rows, best], np.sqrt(d2[rows, best])

"""Differentiable Möller–Trumbore re-intersection (port of
drt_tpu/geometry/mt.py).

Given each ray already matched to a triangle by the non-differentiable
oracle, recompute (u, v, t, n) differentiably w.r.t. the triangle vertices.
det is guarded so masked lanes with degenerate triangles stay finite.
"""

from __future__ import annotations

import torch

from drt_tpu_torch.geometry.vec import clip, cross, dot3, safe_normalize


def moller_trumbore(origin, ray_dir, triangles, det_eps: float = 1e-12):
    """Per-ray matched-triangle intersection with triangles [...,3,3]
    (vertex, xyz); origin, ray_dir [...,3]. Returns (u, v, t, n) as
    moller_trumbore_verts does."""
    return moller_trumbore_verts(origin, ray_dir, triangles[..., 0, :],
                                 triangles[..., 1, :], triangles[..., 2, :],
                                 det_eps)


def moller_trumbore_verts(origin, ray_dir, v0, v1, v2,
                          det_eps: float = 1e-12):
    """origin, ray_dir, v0, v1, v2: [...,3]. Returns (u, v, t, n) with n the
    unit geometric normal (the reference disables vertex-normal
    interpolation, DiffRender.py:103-114)."""
    edge1 = v1 - v0
    edge2 = v2 - v0

    pvec = cross(ray_dir, edge2)
    det = dot3(edge1, pvec)
    det_safe = torch.where(torch.abs(det) > det_eps, det,
                           torch.full_like(det, det_eps))
    inv_det = 1.0 / det_safe

    tvec = origin - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross(tvec, edge1)
    v = dot3(ray_dir, qvec) * inv_det
    t = dot3(edge2, qvec) * inv_det

    n = safe_normalize(cross(edge1, edge2))
    return u, v, t, n



# Structure of arrays: every 3-vector a tuple of its [N] components.

def _s(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _x(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _d(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def moller_trumbore_soa(origin, ray_dir, v0, v1, v2, det_eps: float = 1e-12):
    """moller_trumbore with every 3-vector as a 3-tuple of [N] tensors. Same
    math, same guards; returns (u, v, t, n) with n also a 3-tuple."""
    edge1 = _s(v1, v0)
    edge2 = _s(v2, v0)

    pvec = _x(ray_dir, edge2)
    det = _d(edge1, pvec)
    det_safe = torch.where(torch.abs(det) > det_eps, det,
                           torch.full_like(det, det_eps))
    inv_det = 1.0 / det_safe

    tvec = _s(origin, v0)
    u = _d(tvec, pvec) * inv_det
    qvec = _x(tvec, edge1)
    v = _d(ray_dir, qvec) * inv_det
    t = _d(edge2, qvec) * inv_det

    ncr = _x(edge1, edge2)
    # the guard of vec.safe_normalize: zero vectors give zero, not NaN
    nlen = torch.sqrt(clip(_d(ncr, ncr), 1e-20))
    n = (ncr[0] / nlen, ncr[1] / nlen, ncr[2] / nlen)
    return u, v, t, n

"""Differentiable mesh metrics (port of drt_tpu/geometry/metrics.py)."""

from __future__ import annotations

import math

import torch

from drt_tpu_torch.geometry.scatter import gather_rows
from drt_tpu_torch.geometry.vec import clip, cross, dot3, safe_normalize


def _masked_mean(x, mask):
    cnt = torch.clamp(mask.sum(), min=1)
    return torch.where(mask, x, torch.zeros_like(x)).sum() / cnt


def face_areas(triangles):
    """Twice the area: the parallelogram norm, as the reference's `JIT_area`
    (DiffRender.py:124-131), which omits the 1/2."""
    e1 = triangles[..., 1, :] - triangles[..., 0, :]
    e2 = triangles[..., 2, :] - triangles[..., 0, :]
    return torch.linalg.norm(cross(e1, e2), dim=-1)


def area_var(triangles, face_valid):
    """Relative variance of face areas (reference JIT_area_var,
    DiffRender.py:134-138); the mean is detached there too."""
    area = face_areas(triangles)
    ave = _masked_mean(area, face_valid).detach()
    rel = (area - ave) / clip(ave, 1e-20)
    return _masked_mean(rel * rel, face_valid)


def edge_var(vertices, edges, edge_valid):
    """Relative variance of edge lengths (reference JIT_edge_var,
    DiffRender.py:141-147); the mean is detached."""
    ln = torch.linalg.norm(vertices[edges[:, 0]] - vertices[edges[:, 1]],
                           dim=-1)
    ave = _masked_mean(ln, edge_valid).detach()
    rel = (ln - ave) / clip(ave, 1e-20)
    return _masked_mean(rel * rel, edge_valid)


def edge_face_normals(vertices, faces, edge_faces):
    """Unit normals of the two faces adjacent to each edge
    (reference edge_face_norm, DiffRender.py:149-163)."""
    ef = faces[edge_faces].reshape(-1)              # [E*2*3] vertex ids
    tri = gather_rows(vertices, ef).reshape(*edge_faces.shape, 3, 3)
    e1 = tri[:, :, 1, :] - tri[:, :, 0, :]
    e2 = tri[:, :, 2, :] - tri[:, :, 0, :]
    n = safe_normalize(cross(e1, e2))               # [E,2,3]
    return n[:, 0, :], n[:, 1, :]


def dihedral_cos(vertices, faces, edge_faces):
    """Cosine between adjacent-face normals per edge
    (reference Scene.dihedral_angle, DiffRender.py:440-443)."""
    n1, n2 = edge_face_normals(vertices, faces, edge_faces)
    return dot3(n1, n2)


def corner_angles_and_normals(triangles, face_valid):
    """Per-corner interior angles [F,3] and unit face normals [F,3]
    (reference JIT_corner_angles, DiffRender.py:165-187). Padded/degenerate
    faces give zeros, not NaN."""
    u = triangles[..., 1, :] - triangles[..., 0, :]
    v = triangles[..., 2, :] - triangles[..., 0, :]
    w = triangles[..., 2, :] - triangles[..., 1, :]

    face_n = safe_normalize(cross(u, v))
    un = safe_normalize(u)
    vn = safe_normalize(v)
    wn = safe_normalize(w)

    a0 = torch.arccos(clip(dot3(un, vn), -1.0, 1.0))
    a1 = torch.arccos(clip(dot3(-un, wn), -1.0, 1.0))
    a2 = math.pi - a0 - a1
    angles = torch.stack([a0, a1, a2], dim=-1)      # [F,3]

    valid = face_valid[..., None]
    return (torch.where(valid, angles, torch.zeros_like(angles)),
            torch.where(valid, face_n, torch.zeros_like(face_n)))

"""Angle-weighted vertex normals (port of drt_tpu/geometry/normals.py).

The JAX `segment_sum` over the 3F corner contributions becomes one
`scatter_rows` into [V,3] (the row scatter-add kernel on the card). Weights
(corner angles) are detached, matching the reference's `.detach()`
(DiffRender.py:332).
"""

from __future__ import annotations

from drt_tpu_torch.geometry.metrics import corner_angles_and_normals
from drt_tpu_torch.geometry.scatter import gather_rows, scatter_rows
from drt_tpu_torch.geometry.vec import safe_normalize


def vertex_normals(vertices, faces, face_valid):
    """[Vp,3] angle-weighted unit vertex normals."""
    idx = faces.reshape(-1)
    tri = gather_rows(vertices, idx).reshape(-1, 3, 3)          # [Fp,3,3]
    angles, face_n = corner_angles_and_normals(tri, face_valid)
    contrib = angles.detach()[..., None] * face_n[:, None, :]   # [Fp,3,3]
    seg = scatter_rows(contrib.reshape(-1, 3), idx, vertices.shape[0])
    return safe_normalize(seg)

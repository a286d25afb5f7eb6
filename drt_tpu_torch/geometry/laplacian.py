"""Uniform-weight graph Laplacian over padded vertex neighbourhoods (port of
drt_tpu/geometry/laplacian.py).

The reference keeps a sparse (V x V) uniform-weight matrix from trimesh's
vertex_neighbors (`Scene.init_weightM`, DiffRender.py:357-370) for its
experimental Laplacian gradient hooks (DiffRender.py:403-418). Here the
matrix-vector product is a gather over the padded [V,D] neighbour table of
MeshState.
"""

from __future__ import annotations

import torch


def neighbor_average(vertices, neighbors, neighbor_valid):
    """weightM @ vertices: the mean of each vertex's 1-ring neighbours."""
    gathered = vertices[neighbors]                      # [Vp,D,3]
    m = neighbor_valid[..., None]
    s = torch.where(m, gathered, torch.zeros_like(gathered)).sum(dim=1)
    cnt = torch.clamp(neighbor_valid.sum(dim=1, keepdim=True), min=1)
    return s / cnt


def uniform_laplacian_smooth(vertices, neighbors, neighbor_valid):
    """Laplacian displacement: vertices minus their neighbour mean
    (reference laplac_hook, DiffRender.py:403-409)."""
    return vertices - neighbor_average(vertices, neighbors, neighbor_valid)


def laplacian_grad_hook(grad, vertices, neighbors, neighbor_valid,
                        weight: float):
    """Add `weight * laplacian(vertices)` to the vertex gradient (the
    reference's experimental laplac_hook, DiffRender.py:403-409, off by
    default there and here). The Laplacian carries no gradient."""
    lap = uniform_laplacian_smooth(vertices.detach(), neighbors,
                                   neighbor_valid)
    return weight * lap + grad


def laplacian_normal_grad_hook(grad, vertices, normals, neighbors,
                               neighbor_valid, weight: float,
                               threshold: float = 0.005):
    """The normal-projected variant (reference laplac_normal_hook,
    DiffRender.py:411-418): the Laplacian projected on the vertex normal,
    with magnitudes below `threshold` zeroed, added to the gradient."""
    lap = uniform_laplacian_smooth(vertices.detach(), neighbors,
                                   neighbor_valid)
    ln = (lap * normals).sum(dim=1, keepdim=True)
    ln = torch.where(torch.abs(ln) < threshold, torch.zeros_like(ln), ln)
    return weight * ln + grad

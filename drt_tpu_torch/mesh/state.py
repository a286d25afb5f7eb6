"""Padded mesh state (port of drt_tpu/mesh/state.py).

The same power-of-two padding and `*_valid` masks as the JAX package, so
face ids (and hence oracle tri_ids) match it one for one. Padded faces are
the degenerate triangle (0,0,0): zero area, never hit, masked out of every
reduction. A plain dataclass replaces the flax struct; `with_vertices`
returns a new state rather than mutating this one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from drt_tpu_torch import spans
from drt_tpu_torch.geometry.normals import vertex_normals
from drt_tpu_torch.mesh.topology import (
    MeshTopology, build_topology, mean_edge_length, morton_order_faces,
)


def _bucket(n: int, minimum: int = 256) -> int:
    """Round up to the next power of two (>= minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class MeshState:
    """Differentiable mesh state + padded topology caches. `vertices` is the
    only tensor gradients flow into."""

    vertices: torch.Tensor        # [Vp,3] float
    faces: torch.Tensor           # [Fp,3] int64 (padded: (0,0,0))
    face_valid: torch.Tensor      # [Fp] bool
    vert_valid: torch.Tensor      # [Vp] bool
    edges: torch.Tensor           # [Ep,2] int64 (padded: (0,0))
    edge_valid: torch.Tensor      # [Ep] bool
    edge_faces: torch.Tensor      # [Ep,2] int64
    neighbors: torch.Tensor       # [Vp,D] int64 (pad -1 -> clamped to 0)
    neighbor_valid: torch.Tensor  # [Vp,D] bool
    normals: torch.Tensor         # [Vp,3] angle-weighted vertex normals
    mean_len: torch.Tensor        # scalar — mean edge length at load time
    num_vertices: int
    num_faces: int
    num_edges: int

    def with_vertices(self, vertices: torch.Tensor) -> "MeshState":
        """Swap vertices and recompute vertex normals (reference
        `update_verticex`, DiffRender.py:378-384): the train step's
        `normals` chain (drt_tpu_torch/spans.py)."""
        normals = spans.chain_output("normals", vertex_normals(
            spans.chain_input("normals", vertices), self.faces,
            self.face_valid))
        return dataclasses.replace(self, vertices=vertices, normals=normals)

    def chain(self, name: str) -> "MeshState":
        """The same state with `vertices` behind a view that the train
        step's chain `name` alone reads (spans.chain_input), so its
        backward segment closes when its vertex gradient is complete."""
        return dataclasses.replace(
            self, vertices=spans.chain_input(name, self.vertices))

    def host_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Unpadded (vertices [V,3] f64, faces [F,3] i64) on the host."""
        v = self.vertices[: self.num_vertices].detach().cpu().double()
        f = self.faces[: self.num_faces].cpu()
        return v.numpy(), f.numpy().astype(np.int64)


def build_mesh_state(
    vertices: np.ndarray,
    faces: np.ndarray,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    require_watertight: bool = True,
    topology: Optional[MeshTopology] = None,
    bucket_min: int = 256,
) -> MeshState:
    """Build a padded MeshState from host arrays (analog of `update_mesh`,
    reference DiffRender.py:303-317)."""
    vertices = np.asarray(vertices, dtype=np.float64)
    V = len(vertices)
    if topology is None:
        # Morton-order faces so the chunked oracle culls well.
        faces = morton_order_faces(vertices, np.asarray(faces))
        topo = build_topology(faces, V)
    else:
        topo = topology
    if require_watertight and not topo.is_watertight:
        raise ValueError("mesh is not watertight")

    F, E = topo.num_faces, topo.num_edges
    Vp, Fp, Ep = (_bucket(V, bucket_min), _bucket(F, bucket_min),
                  _bucket(E, bucket_min))

    v_pad = np.zeros((Vp, 3), dtype=np.float64)
    v_pad[:V] = vertices
    f_pad = np.zeros((Fp, 3), dtype=np.int64)
    f_pad[:F] = topo.faces
    e_pad = np.zeros((Ep, 2), dtype=np.int64)
    e_pad[:E] = topo.edges
    ef_pad = np.zeros((Ep, 2), dtype=np.int64)
    ef_pad[:E] = topo.edge_faces

    D = topo.neighbors.shape[1]
    nbr = np.zeros((Vp, D), dtype=np.int64)
    nbr_valid = np.zeros((Vp, D), dtype=bool)
    nbr_valid[:V] = topo.neighbors >= 0
    nbr[:V] = np.maximum(topo.neighbors, 0)

    def mask(n, total):
        m = np.zeros(total, dtype=bool)
        m[:n] = True
        return m

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=device)

    verts = t(v_pad, dtype)
    faces_t = t(f_pad)
    face_valid = t(mask(F, Fp))
    return MeshState(
        vertices=verts,
        faces=faces_t,
        face_valid=face_valid,
        vert_valid=t(mask(V, Vp)),
        edges=t(e_pad),
        edge_valid=t(mask(E, Ep)),
        edge_faces=t(ef_pad),
        neighbors=t(nbr),
        neighbor_valid=t(nbr_valid),
        normals=vertex_normals(verts, faces_t, face_valid),
        mean_len=t(mean_edge_length(vertices, topo.edges), dtype),
        num_vertices=V,
        num_faces=F,
        num_edges=E,
    )

"""The mesh's connectivity, worked out from the faces alone (numpy).

A frozen copy of the port's host topology (its Morton face order and its
edge grouping), so that face and edge indices mean the same on both sides,
without importing it."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def morton_order_faces(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Faces reordered along the Z-order curve of their centroids (stable)."""
    cent = vertices[faces].mean(axis=1)
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-12)
    q = np.clip(((cent - lo) / span * 1023.0).astype(np.uint64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return faces[np.argsort(code, kind="stable")]


def edges_and_faces(faces: np.ndarray):
    """(edges [E,2], edge_faces [E,2]) of a closed mesh: each undirected
    edge as its sorted vertex pair, in lexicographic order, with the two
    faces that share it (in the order of the directed edges, each face's
    three in winding order, the faces' first edges first). Raises unless
    every edge has exactly two faces."""
    f = len(faces)
    directed = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                               faces[:, [2, 0]]])
    face_of = np.concatenate([np.arange(f)] * 3)
    es = np.sort(directed, axis=1)
    order = np.lexsort((es[:, 1], es[:, 0]))
    es, fs = es[order], face_of[order]
    new = np.ones(len(es), dtype=bool)
    new[1:] = np.any(es[1:] != es[:-1], axis=1)
    starts = np.nonzero(new)[0]
    sizes = np.diff(np.append(starts, len(es)))
    if not np.all(sizes == 2):
        raise ValueError("the mesh is not closed: an edge has "
                         f"{sorted(set(sizes.tolist()) - {2})} faces")
    return es[starts], np.stack([fs[starts], fs[starts + 1]], axis=1)


@dataclasses.dataclass(frozen=True)
class RefMesh:
    """A mesh as the reference computes on it, on one device."""

    vertices: torch.Tensor      # [V,3] float32
    faces: torch.Tensor         # [F,3] int64, Morton order
    edges: torch.Tensor         # [E,2] int64
    edge_faces: torch.Tensor    # [E,2] int64
    mean_len: float             # mean edge length (float64 on the host)


def ref_mesh(vertices: np.ndarray, faces: np.ndarray, device) -> RefMesh:
    v = np.asarray(vertices, dtype=np.float64)
    f = morton_order_faces(v, np.asarray(faces, dtype=np.int64))
    e, ef = edges_and_faces(f)
    d = v[e[:, 0]] - v[e[:, 1]]
    mean_len = float(np.linalg.norm(d, axis=1).mean())

    def t(a, dt=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)
    return RefMesh(t(v, torch.float32), t(f), t(e), t(ef), mean_len)

"""Carry state across from the JAX package as numpy arrays.

`mesh_state_from_arrays` and `view_batch_from_arrays` take the fields of
drt_tpu's MeshState and ViewBatch (as numpy arrays, plus the three static
counts of the mesh) and build the port's, so both packages start from
identical state. Integer topology becomes int64 (torch's index type);
floating fields keep their dtype. `train_state_from_arrays` does the same
for the optimizer state of `make_train_step`.
"""

from __future__ import annotations

import numpy as np
import torch

from drt_tpu_torch.data.views import ViewBatch
from drt_tpu_torch.mesh.state import MeshState

_MESH_INT = ("faces", "edges", "edge_faces", "neighbors")
_MESH_BOOL = ("face_valid", "vert_valid", "edge_valid", "neighbor_valid")
_MESH_FLOAT = ("vertices", "normals", "mean_len")
_MESH_STATIC = ("num_vertices", "num_faces", "num_edges")


def _tensor(a, device, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    return t.to(device=device, dtype=dtype) if dtype else t.to(device)


def mesh_state_from_arrays(d: dict, device) -> MeshState:
    """d: {field: numpy array} for every MeshState field."""
    kw = {k: _tensor(d[k], device, torch.int64) for k in _MESH_INT}
    kw.update({k: _tensor(d[k], device, torch.bool) for k in _MESH_BOOL})
    kw.update({k: _tensor(d[k], device) for k in _MESH_FLOAT})
    kw.update({k: int(d[k]) for k in _MESH_STATIC})
    return MeshState(**kw)


def view_batch_from_arrays(d: dict, device) -> ViewBatch:
    """d: {field: numpy array} for every ViewBatch field."""
    return ViewBatch(**{k: _tensor(d[k], device,
                                   torch.bool if k == "valid" else None)
                        for k in ViewBatch._fields})


_STATE_FLOAT = ("params", "m", "v", "v_per", "init_v")


def train_state_from_arrays(d: dict, device) -> dict:
    """d: {field: numpy array} for every field of drt_tpu's train-step state
    (params, m, v, v_per, count, init_v, silh_max)."""
    st = {k: _tensor(d[k], device) for k in _STATE_FLOAT}
    st["count"] = _tensor(d["count"], device, torch.int32)
    st["silh_max"] = _tensor(d["silh_max"], device, torch.int64)
    return st

"""The hit oracle: closest ray-triangle intersection, non-differentiable
(port of drt_tpu/intersect/api.py).

Backends:
- "brute": blocked all-pairs Möller–Trumbore in torch; exact, the ground
  truth on the CPU.
- "culled": the chunk-culled algorithm in plain torch, waves of nearest
  chunks as one float32 matrix product (intersect/culled.py).
- "cuda":  the chunk-culled closest-hit kernel (intersect/cuda_kernel.py).
  On CUDA tensors it launches the hand-written kernels; on CPU tensors
  their plain PyTorch versions run the same algorithm.
- "auto":  "cuda".

Every backend takes an explicit keyword `coherent=`: True for camera-pixel
rays, False for post-refraction and silhouette rays. It picks the cuda
backend's candidate prepass; brute and culled ignore it. An incoherent
query whose rays all read one origin row (`one_origin`: the silhouette
sampler's, which passes `cam_origin.expand(N, 3)`) takes the cuda
backend's one-origin route, its rays sorted along the screen inside the
oracle (intersect/cuda_kernel.py).

Convention: Hits(t [N] f32, tri_id [N] i32), tri_id == -1 and t == inf on a
miss.
"""

from __future__ import annotations

import functools
import json
import math
import os
from typing import Callable, NamedTuple

import torch

# The measured A/B of the two incoherent routes of the cuda backend, written
# from the card by `scripts/tune_torch_oracle.py --what resort`.
RESORT_TABLE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "reports", "torch_resort_ab.json")


class Hits(NamedTuple):
    t: torch.Tensor       # [N] float32, inf on miss
    tri_id: torch.Tensor  # [N] int32, -1 on miss

    @property
    def hit(self) -> torch.Tensor:
        return self.tri_id >= 0


@functools.lru_cache(maxsize=1)
def _resort_ab_table():
    """((faces_padded, winner), ...) from RESORT_TABLE, or () if absent."""
    try:
        with open(RESORT_TABLE) as fh:
            rows = json.load(fh)["rows"]
        return tuple((int(r["faces_padded"]), str(r["winner"]))
                     for r in rows)
    except (OSError, ValueError, KeyError, TypeError):
        return ()


def one_origin(origins: torch.Tensor) -> bool:
    """Whether every ray of an [N,3] origin tensor reads the same row in
    memory (stride 0 along the rays, as `origin.expand(N, 3)` gives): a
    property of the tensor, seen without reading the device. A query of
    rays that share one point but arrive as separate rows is not one."""
    return (origins.dim() == 2 and origins.shape[0] > 1
            and origins.stride(0) == 0)


def nearest_measured(rows, num_faces: int, default):
    """The value of the row of ((faces_padded, value), ...) nearest
    num_faces in log space; `default` where nothing was measured."""
    if not rows:
        return default
    _, value = min(rows, key=lambda kv:
                   abs(math.log(kv[0] / max(num_faces, 1))))
    return value


def _auto_incoherent(num_faces: int) -> str:
    """The nearest measured mesh size's winner; "ray" (the exact per-ray
    prepass) where nothing was measured."""
    return nearest_measured(_resort_ab_table(), num_faces, "ray")


def get_intersect_fn(backend: str = "auto", incoherent: str = "auto",
                     **kw) -> Callable:
    """Returns intersect(origins [N,3], dirs [N,3], vertices, faces,
    face_valid, *, coherent) -> Hits. `kw` go to the backend on every
    query, as in the JAX package (e.g. t_min; group for "cuda"; ray_chunk,
    tri_chunk for "brute"). Inputs are detached: the oracle is a
    stop-gradient query (the reference casts to float32 OptiX buffers,
    DiffRender.py:387-388); gradients flow through the differentiable
    re-intersection of the matched triangles instead.

    incoherent: how the cuda backend answers coherent=False queries.
    "ray" is the exact per-ray candidate prepass (csrc/candidates.cu);
    "resort" Morton-sorts the rays so the cheap tile prepass applies, then
    scatters the hits back (intersect/resort.py); "auto" takes the measured
    winner for the mesh size from RESORT_TABLE, and "ray" where that table
    has no row. Both routes give the same hits bit for bit. A one-origin
    query (`one_origin`) takes neither: its keys would be one origin, so
    the cuda backend sorts it by direction instead."""
    if incoherent not in ("auto", "ray", "resort"):
        raise ValueError(f"unknown incoherent strategy: {incoherent}")
    if backend == "auto":
        backend = "cuda"
    if backend == "brute":
        from drt_tpu_torch.intersect.brute import intersect_brute as fn
    elif backend == "culled":
        from drt_tpu_torch.intersect.culled import intersect_culled as fn
    elif backend == "cuda":
        from drt_tpu_torch.intersect.cuda_kernel import intersect_cuda as fn
    else:
        raise ValueError(f"unknown intersect backend: {backend}")

    def wrapped(origins, dirs, vertices, faces, face_valid=None, *,
                coherent: bool) -> Hits:
        args = (origins.detach(), dirs.detach(), vertices.detach(), faces,
                face_valid)
        if backend == "cuda" and not coherent and not one_origin(origins):
            strat = incoherent
            if strat == "auto":
                strat = _auto_incoherent(faces.shape[0])
            if strat == "resort":
                from drt_tpu_torch.intersect.resort import resorted_intersect
                # the unsorted query's shift, so t is the per-ray route's
                # to the bit
                return resorted_intersect(
                    fn, *args, coherent=True,
                    shift=args[0].float().mean(dim=0), **kw)
        return fn(*args, coherent=coherent, **kw)

    return wrapped

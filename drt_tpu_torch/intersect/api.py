"""The hit oracle: closest ray-triangle intersection, non-differentiable
(port of drt_tpu/intersect/api.py).

Backends:
- "brute": blocked all-pairs Möller–Trumbore in torch; exact, the ground
  truth on the CPU.
- "cuda":  the chunk-culled closest-hit kernel (intersect/cuda_kernel.py).
  On CUDA tensors it launches the hand-written kernels; on CPU tensors
  their plain PyTorch versions run the same algorithm.
- "auto":  "cuda".

Every backend takes an explicit keyword `coherent=`: True for camera-pixel
rays, False for post-refraction and silhouette rays. It picks the cuda
backend's candidate prepass; brute ignores it.

Convention: Hits(t [N] f32, tri_id [N] i32), tri_id == -1 and t == inf on a
miss.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Hits(NamedTuple):
    t: torch.Tensor       # [N] float32, inf on miss
    tri_id: torch.Tensor  # [N] int32, -1 on miss

    @property
    def hit(self) -> torch.Tensor:
        return self.tri_id >= 0


def get_intersect_fn(backend: str = "auto") -> Callable:
    """Returns intersect(origins [N,3], dirs [N,3], vertices, faces,
    face_valid, *, coherent) -> Hits. Inputs are detached: the oracle is a
    stop-gradient query (the reference casts to float32 OptiX buffers,
    DiffRender.py:387-388); gradients flow through the differentiable
    re-intersection of the matched triangles instead."""
    if backend == "auto":
        backend = "cuda"
    if backend == "brute":
        from drt_tpu_torch.intersect.brute import intersect_brute as fn
    elif backend == "cuda":
        from drt_tpu_torch.intersect.cuda_kernel import intersect_cuda as fn
    else:
        raise ValueError(f"unknown intersect backend: {backend}")

    def wrapped(origins, dirs, vertices, faces, face_valid=None, *,
                coherent: bool) -> Hits:
        return fn(origins.detach(), dirs.detach(), vertices.detach(), faces,
                  face_valid, coherent=coherent)

    return wrapped

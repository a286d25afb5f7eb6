"""Ray-axis data parallelism over torch.distributed (port of
drt_tpu/parallel/sharding.py).

The JAX package places arrays on a one-axis device mesh, "rays", and lets
GSPMD partition one jitted step: the mesh (vertices, faces, topology) is
replicated, the per-pixel ray arrays are sharded, and the [V,3] vertex
gradient is reduced once. Here each device is one process:

- the mesh axis becomes a process group (`RayMesh`);
- `replicate` broadcasts rank 0's tensors, so every rank holds its bits;
- `shard_views` keeps this rank's contiguous slice of each per-pixel array;
- the train step (`make_train_step(ray_mesh=...)`, optimize/loop.py) sums
  the gradient, the loss and its parts with one all_reduce, so every rank
  applies the same update.

NCCL carries the collectives between cards, gloo on the CPU and between
ranks that share one card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch
import torch.distributed as dist

from drt_tpu_torch.data.views import ViewBatch
from drt_tpu_torch.intersect.api import Hits
from drt_tpu_torch.optimize.loop import make_train_step


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """The ranks that split the ray axis: their process group, this rank's
    place in it and the device its tensors live on."""

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device

    @property
    def root(self) -> int:
        """Global rank of the group's rank 0, the source of `replicate`."""
        return dist.get_global_rank(self.group, 0)


def make_ray_mesh(group=None, device=None) -> RayMesh:
    """The ray mesh over `group` (torch.distributed's WORLD group if None),
    which must be initialized (`init_multihost`). A JAX `Mesh` axis becomes
    a process group here: one process per device.

    device: this rank's device; by default cuda:<local rank>, the local rank
    being LOCAL_RANK (torchrun sets it) or else the global rank, modulo the
    cards torch sees. It raises without a card: pass device="cpu" to run on
    the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_ray_mesh: torch.distributed is not "
                           "initialized; call init_multihost first")
    group = dist.group.WORLD if group is None else group
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_ray_mesh: torch sees no CUDA device; "
                               "pass device='cpu' to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return RayMesh(group, dist.get_rank(group), dist.get_world_size(group),
                   torch.device(device))


def replicate(mesh: RayMesh, tree):
    """`tree` (a tensor, or a MeshState or dict of them, such as a train
    state) copied to this rank's device with every tensor broadcast from
    rank 0, so every rank then holds rank 0's bits. Every rank passes a tree
    of the same structure and shapes; fields that are not tensors (a
    MeshState's counts) stay as they are."""
    if isinstance(tree, torch.Tensor):
        x = tree.to(mesh.device, copy=True).contiguous()
        dist.broadcast(x, mesh.root, group=mesh.group)
        return x
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: replicate(mesh, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    return tree


def _ray_slice(n: int, mesh: RayMesh) -> slice:
    if n % mesh.size:
        raise ValueError(
            f"{n} rays do not divide over {mesh.size} ranks; pad the ray "
            "batch to a multiple first "
            "(drt_tpu_torch.parallel.pad_views_to_multiple)")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_views(mesh: RayMesh, views: ViewBatch) -> ViewBatch:
    """This rank's contiguous slice of the per-pixel arrays [V,N,...]
    (screen_pixel, valid, ray_dir, and origin when it is per-pixel) on its
    device; masks, cameras and compact [V,1,3] origins stay whole. Every
    rank passes the same global views. Raises ValueError when N does not
    divide over the ranks, as the JAX package's even-shard placement does."""
    sl = _ray_slice(views.ray_dir.shape[1], mesh)

    def put(x, sharded):
        return (x[:, sl] if sharded else x).to(mesh.device).contiguous()

    return ViewBatch(
        screen_pixel=put(views.screen_pixel, True),
        valid=put(views.valid, True),
        mask=put(views.mask, False),
        origin=put(views.origin, views.origin.shape[1] > 1),
        ray_dir=put(views.ray_dir, True),
        R=put(views.R, False), K=put(views.K, False),
        R_inv=put(views.R_inv, False), K_inv=put(views.K_inv, False),
    )


def pad_views_to_multiple(views: ViewBatch, multiple: int) -> ViewBatch:
    """Pad the per-pixel ray axis of a ViewBatch to a multiple of
    `multiple`, so that `shard_views` accepts it. Padding lanes repeat the
    view's last real ray (no zero directions) with valid=False, so every
    loss masks them out and the padded batch gives the unpadded batch's
    loss and gradient. Returns `views` itself when no padding is needed."""
    n = views.ray_dir.shape[1]
    pad = (-n) % multiple
    if pad == 0:
        return views

    def pad_rays(x, fill_last: bool):
        if x.ndim < 2 or x.shape[1] != n:
            return x                      # compact [V,1,3] origins, cameras
        tail = x[:, -1:].repeat_interleave(pad, dim=1)
        if not fill_last:                 # validity: padding lanes are False
            tail = torch.zeros_like(tail)
        return torch.cat([x, tail], dim=1)

    return views._replace(
        screen_pixel=pad_rays(views.screen_pixel, True),
        valid=pad_rays(views.valid, False),
        origin=pad_rays(views.origin, True),
        ray_dir=pad_rays(views.ray_dir, True),
    )


def _all_gather(mesh: RayMesh, x: torch.Tensor) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


def shard_mapped_intersect(intersect_fn: Callable,
                           mesh: RayMesh) -> Callable:
    """A hit oracle over global rays that splits the work by rank: each
    rank answers its contiguous slice of the rays through `intersect_fn`
    and all_gather returns the global Hits to every rank. The oracle is
    per ray, so nothing else crosses ranks. The ray count must divide over
    the ranks. (The train step does not need this: its rays are already
    this rank's own.)"""

    def sharded(origins, dirs, vertices, faces, face_valid=None, *,
                coherent: bool) -> Hits:
        sl = _ray_slice(origins.shape[0], mesh)
        h = intersect_fn(origins[sl], dirs[sl], vertices, faces, face_valid,
                         coherent=coherent)
        return Hits(_all_gather(mesh, h.t), _all_gather(mesh, h.tri_id))

    return sharded


def make_sharded_train_step(make_step_kwargs: dict, mesh: RayMesh,
                            mesh_state, views: ViewBatch,
                            wrap_intersect: bool = True):
    """A train step over the ranks of `mesh`, with its data placed:
    returns ((init_state, step, final_vertices), mesh_state_placed,
    views_placed), where the mesh state is replicated from rank 0 and the
    views are this rank's shard of the rays. The step is
    `make_train_step(**make_step_kwargs, ray_mesh=mesh)`: each rank traces
    its own rays and one all_reduce sums the gradient, so every rank applies
    the same update. Every rank calls the step with the same lr and view
    indices.

    Two keywords of the JAX package have nothing to do here.
    wrap_intersect: the JAX package shard_maps the oracle because its step
    traces the global rays; here each rank's step holds only its own rays,
    so the oracle is called as it is (`shard_mapped_intersect` is for
    callers that hold global rays). ray_shard_count: it scales the JAX
    package's per-device threshold for its AoS triangle gather; the port's
    gather has one route, so make_train_step has no such keyword."""
    step = make_train_step(**make_step_kwargs, ray_mesh=mesh)
    return step, replicate(mesh, mesh_state), shard_views(mesh, views)

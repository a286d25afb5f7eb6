"""Silhouette-edge detection and the differentiable edge sampler (port of
drt_tpu/render/silhouette.py; reference DiffRender.py:189-267, 445-479).

A fixed budget of K edges is selected (`select_edges`, of fixed size K
like JAX's `jnp.nonzero(size=K)`, so it never waits on the host) and
carried with a validity mask. The sampler is a `torch.autograd.Function`:
its backward turns the per-edge occupancy residual into 2D endpoint
gradients dE = -N * f * g (DiffRender.py:236-242, 263-267); the ray casts
inside it are a non-differentiable oracle query.

The loss (`optimize.losses.silhouette_loss`) and the train step run the same
chain as three CUDA kernels around the query (render/silhouette_kernels.py,
csrc/silhouette.cu); `primary_visibility` states the samples in torch
operations, for the tests that hold them to the JAX package's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from drt_tpu_torch.geometry.scatter import gather_rows
from drt_tpu_torch.geometry.vec import const_like, constant, cross
from drt_tpu_torch.render.camera import CameraM, project_vertices


def silhouette_edge_mask(vertices, faces, edge_faces, edge_valid,
                         cam_origin) -> torch.Tensor:
    """[Ep] bool: edges whose two faces face the camera differently (XOR,
    reference DiffRender.py:445-457), on detached vertices."""
    tri = vertices.detach()[faces[edge_faces]]        # [Ep,2,3,3]
    e1 = tri[:, :, 1, :] - tri[:, :, 0, :]
    e2 = tri[:, :, 2, :] - tri[:, :, 0, :]
    n = cross(e1, e2)
    to_cam = cam_origin[None, None, :] - tri[:, :, 0, :]
    d = torch.sum(n * to_cam, dim=-1)                 # [Ep,2]
    return torch.logical_xor(d[:, 0] > 0, d[:, 1] > 0) & edge_valid


def select_edges(silh: torch.Tensor, budget: int):
    """(edge_idx [budget] int64, sel_valid [budget] bool, count []) for
    silh [Ep] bool: the indices of its first `budget` True entries in
    order, 0 past the last (`jnp.nonzero(silh, size=budget,
    fill_value=0)`, which truncates where more are True), True where an
    entry was selected, and the number of True entries. A fixed-size
    selection (the k-th True entry is where the running count first
    reaches k), so nothing waits for the count on the host."""
    silh_count = silh.sum()
    sel = torch.arange(budget, device=silh.device)
    sel_valid = sel < silh_count
    edge_idx = torch.searchsorted(torch.cumsum(silh, 0), sel + 1)
    return torch.where(sel_valid, edge_idx, 0), sel_valid, silh_count


class EdgeSamples(NamedTuple):
    pixel: torch.Tensor    # [K,2] int32 (x, y) sampled pixel per edge
    pixel_f: torch.Tensor  # [K,2] float sample point (detached), for
                           # bilinear mask sampling
    output: torch.Tensor   # [K] the 0.5 occupancy value (grads flow here)
    valid: torch.Tensor    # [K] bool — selected, boundary-crossing, in view
    count: torch.Tensor    # [] true number of silhouette edges (may be > K)


def _edge_sample_fwd_math(E_pos, K_inv, R_inv, cam_origin, intersect_fn,
                          vertices, faces, face_valid):
    """E_pos [K,2,2] projected endpoints -> (sample_point [K,2], N [K,2]
    screen edge normal, f [K] inside-minus-outside occupancy)."""
    ax, ay = E_pos[:, 0, 0], E_pos[:, 0, 1]
    bx, by = E_pos[:, 1, 0], E_pos[:, 1, 1]
    sample_point = torch.stack([(ax + bx) * 0.5, (ay + by) * 0.5], dim=1)
    N = torch.stack([ay - by, bx - ax], dim=1)
    n_len = torch.linalg.norm(N, dim=1, keepdim=True)
    N_unit = N / torch.maximum(n_len, const_like(n_len, 1e-12))

    f_point = torch.cat([sample_point + N_unit, sample_point - N_unit])
    ones = torch.ones_like(f_point[:, :1])
    # back-projected rays; directions intentionally un-normalized
    cam_p = torch.cat([f_point, ones], dim=1) @ K_inv.T
    world_p = (torch.cat([cam_p, ones], dim=1) @ R_inv.T)[:, :3]
    ray_dir = world_p - cam_origin[None, :]
    # one origin row for every ray (stride 0): the cuda oracle sees that the
    # rays share it and sorts them along the screen (its one-origin route)
    ray_org = cam_origin.expand(ray_dir.shape)
    hits = intersect_fn(ray_org, ray_dir, vertices, faces, face_valid,
                        coherent=False)
    K = E_pos.shape[0]
    occ = hits.hit.to(E_pos.dtype)
    return sample_point, N, occ[:K] - occ[K:]


class _EdgeSampler(torch.autograd.Function):
    """Returns (pixel [K,2] i32, output [K], f [K], bc_valid [K]); only
    `output` carries a gradient, into E_pos."""

    @staticmethod
    def forward(ctx, E_pos, K_inv, R_inv, cam_origin, intersect_fn,
                vertices, faces, face_valid):
        sample_point, N, f = _edge_sample_fwd_math(
            E_pos, K_inv, R_inv, cam_origin, intersect_fn, vertices, faces,
            face_valid)
        pixel = sample_point.to(torch.int32)
        output = torch.full((E_pos.shape[0],), 0.5, dtype=E_pos.dtype,
                            device=E_pos.device)
        bc_valid = torch.abs(f) > 1e-5                 # boundary-crossing
        ctx.save_for_backward(N, f)
        ctx.mark_non_differentiable(pixel, f, bc_valid)
        return pixel, output, f, bc_valid

    @staticmethod
    def backward(ctx, _g_pixel, g_output, _g_f, _g_valid):
        N, f = ctx.saved_tensors
        scale = (f * g_output)[:, None, None]
        dE = (-N)[:, None, :].expand(N.shape[0], 2, 2) * scale
        return dE, None, None, None, None, None, None, None


def primary_visibility(mesh, camera: CameraM, cam_origin,
                       intersect_fn: Callable, budget: int,
                       resy: int, resx: int,
                       detach_depth: bool = True) -> EdgeSamples:
    """Select up to `budget` silhouette edges, project their endpoints
    (camera depth detached by default, DiffRender.py:471) and run the edge
    sampler (reference primary_visibility, DiffRender.py:459-479, including
    the viewport clip at :478)."""
    silh = silhouette_edge_mask(mesh.vertices, mesh.faces, mesh.edge_faces,
                                mesh.edge_valid, cam_origin)
    edge_idx, sel_valid, silh_count = select_edges(silh, budget)

    V = gather_rows(mesh.vertices,
                    mesh.edges[edge_idx].reshape(-1))        # [2K,3]
    E_pos = project_vertices(camera, V, detach_depth=detach_depth)
    E_pos = E_pos.reshape(budget, 2, 2)

    pixel, output, _f, bc_valid = _EdgeSampler.apply(
        E_pos, camera.K_inv, camera.R_inv, cam_origin, intersect_fn,
        mesh.vertices.detach(), mesh.faces, mesh.face_valid)

    in_view = ((pixel[:, 0] >= 0) & (pixel[:, 0] < resx - 1)
               & (pixel[:, 1] >= 0) & (pixel[:, 1] < resy - 1))
    valid = sel_valid & bc_valid & in_view
    hi = constant((resx - 1, resy - 1), torch.int32, pixel.device)
    pixel = torch.minimum(pixel.clamp_min(0), hi)
    pixel_f = E_pos.detach().mean(dim=1)                     # midpoint
    return EdgeSamples(pixel, pixel_f, output, valid, silh_count)

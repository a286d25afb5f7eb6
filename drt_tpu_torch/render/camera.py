"""Pinhole camera: ray generation and vertex projection (port of
drt_tpu/render/camera.py; reference captured_data.py:23-40,
DiffRender.py:459-490). Matmuls run in full float32/float64: the package
turns TF32 off (drt_tpu_torch/__init__.py), and the silhouette loss depends
on sub-pixel projections."""

from __future__ import annotations

from typing import NamedTuple

import torch

from drt_tpu_torch.geometry.vec import safe_normalize


class CameraM(NamedTuple):
    """Camera matrices, as the reference's camera_M tuple."""
    R: torch.Tensor          # [4,4] world->camera extrinsic ("cam_proj")
    K: torch.Tensor          # [3,3] intrinsics
    R_inv: torch.Tensor      # [4,4]
    K_inv: torch.Tensor      # [3,3]


def generate_rays(resy: int, resx: int, camera: CameraM,
                  supersample: int = 1):
    """Back-project every pixel: (origin [N,3], dir [N,3] unit),
    N = resy*resx*supersample^2, pixel centres at integer coordinates on the
    z=1 plane (reference captured_data.py:23-40); with supersample 1, pixel
    (x,y) is at row-major index y*resx + x.

    supersample s > 1 gives each pixel an s x s grid of sub-pixel rays at
    (i + 0.5)/s - 0.5 along each axis, row-major over the fine
    (resy*s x resx*s) grid: the sub-rays of pixel (y,x) sit at fine rows
    s*y..s*y+s-1 and columns s*x..s*x+s-1. s = 1 gives the integer centres
    bit for bit."""
    K_inv, R_inv = camera.K_inv, camera.R_inv
    kw = dict(dtype=K_inv.dtype, device=K_inv.device)
    s = int(supersample)
    ys = (torch.arange(resy * s, **kw) + 0.5) / s - 0.5
    xs = (torch.arange(resx * s, **kw) + 0.5) / s - 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    pixel = torch.stack([px, py, torch.ones_like(py)], dim=2).reshape(-1, 3)
    cam_p = pixel @ K_inv.T
    world_p = cam_p @ R_inv[:3, :3].T + R_inv[:3, 3]
    origin = R_inv[:3, 3]
    ray_dir = safe_normalize(world_p - origin)
    return origin.expand(ray_dir.shape), ray_dir


def project_vertices(camera: CameraM, V: torch.Tensor,
                     detach_depth: bool = False):
    """World points -> pixel coordinates [N,2]. detach_depth stops the
    gradient through camera-space depth (reference DiffRender.py:471)."""
    ones = torch.ones((*V.shape[:-1], 1), dtype=V.dtype, device=V.device)
    v_cam = torch.cat([V, ones], dim=-1) @ camera.R.T             # [N,4]
    if detach_depth:
        v_cam = torch.cat([v_cam[..., :2], v_cam[..., 2:3].detach(),
                           v_cam[..., 3:]], dim=-1)
    v_pix = v_cam[..., :3] @ camera.K.T
    return v_pix[..., :2] / v_pix[..., 2:3]

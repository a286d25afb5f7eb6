"""Synthetic capture generator (port of drt_tpu/data/synthetic.py).

Renders the environment-matting observation the real rig measures from a
known ground-truth mesh: a ring of pinhole cameras around the object, a
virtual screen plane behind it, the 2-bounce tracer giving the screen point
each pixel sees through the glass, and the hit mask for the silhouette.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from drt_tpu_torch.data.masks import process_mask
from drt_tpu_torch.data.views import CaptureData, stack_views
from drt_tpu_torch.intersect.api import get_intersect_fn
from drt_tpu_torch.mesh.state import build_mesh_state
from drt_tpu_torch.render.camera import CameraM, generate_rays
from drt_tpu_torch.render.trace import render_mask, render_transparent


def look_at_extrinsic(cam_pos, target, up=(0.0, 0.0, 1.0)):
    """4x4 world->camera matrix, camera +z looking at `target`."""
    cam_pos = np.asarray(cam_pos, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    z = target - cam_pos
    z /= np.linalg.norm(z)
    x = np.cross(z, up)
    if np.linalg.norm(x) < 1e-9:            # looking along up
        x = np.cross(z, np.array([1.0, 0.0, 0.0]))
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    Rm = np.stack([x, y, z])
    R4 = np.eye(4)
    R4[:3, :3] = Rm
    R4[:3, 3] = -Rm @ cam_pos
    return R4


def intrinsics(resy, resx, fov_deg=45.0):
    f = 0.5 * resx / np.tan(np.deg2rad(fov_deg) / 2)
    return np.array([[f, 0.0, resx / 2.0],
                     [0.0, f, resy / 2.0],
                     [0.0, 0.0, 1.0]])


def ring_cameras(gt_vertices, num_views, cam_distance_factor=3.5,
                 screen_distance_factor=2.5, elevation_deg=10.0):
    """Per view (R [4,4], screen_point [3], screen_normal [3]), numpy."""
    center = gt_vertices.mean(axis=0)
    radius = float(np.linalg.norm(gt_vertices - center, axis=1).max())
    elev = np.deg2rad(elevation_deg)
    out = []
    for i in range(num_views):
        th = 2 * np.pi * i / num_views
        cam_pos = center + cam_distance_factor * radius * np.array(
            [np.cos(th) * np.cos(elev), np.sin(th) * np.cos(elev),
             np.sin(elev)])
        R = look_at_extrinsic(cam_pos, center)
        z_cam = R[2, :3]                       # camera viewing direction
        out.append((R, center + screen_distance_factor * radius * z_cam,
                    -z_cam))
    return out


@torch.no_grad()
def synthesize_capture(
    gt_vertices: np.ndarray,
    gt_faces: np.ndarray,
    name: str = "synthetic",
    num_views: int = 72,
    resy: int = 128,
    resx: int = 128,
    ior: float = 1.4723,
    ext_ior: float = 1.00029,
    cam_distance_factor: float = 3.5,
    screen_distance_factor: float = 2.5,
    fov_deg: float = 45.0,
    elevation_deg: float = 10.0,
    backend: str = "auto",
    num_view_used: int = 72,
    cache_path: str | None = None,
    device="cuda",
) -> CaptureData:
    """Render a synthetic capture of `gt` (float32, on `device`) in the
    per-view structure the h5 loader produces.

    cache_path: optional .npz path, loaded if it exists and written after
    synthesis otherwise, with the JAX package's keys, so a capture cached by
    one package loads in the other."""
    if cache_path and os.path.exists(cache_path):
        z = np.load(cache_path)
        views = [dict(screen_pixel=z[f"sp{i}"], valid=z[f"va{i}"],
                      mask=z[f"mk{i}"], origin=z[f"or{i}"],
                      ray_dir=z[f"rd{i}"], R=z[f"R{i}"], K=z[f"K{i}"])
                 for i in range(int(z["num_views"]))]
        return CaptureData(name=name, resy=int(z["resy"]),
                           resx=int(z["resx"]),
                           num_views=int(z["num_views"]),
                           views=stack_views(views, device=device),
                           num_view_used=num_view_used)
    ms = build_mesh_state(gt_vertices, gt_faces, device=device)
    fn = get_intersect_fn(backend)
    K = intrinsics(resy, resx, fov_deg)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    views = []
    for R, screen_point, screen_normal in ring_cameras(
            np.asarray(gt_vertices, np.float64), num_views,
            cam_distance_factor, screen_distance_factor, elevation_deg):
        cam = CameraM(f32(R), f32(K), f32(np.linalg.inv(R)),
                      f32(np.linalg.inv(K)))
        origin, ray_dir = generate_rays(resy, resx, cam)
        res = render_transparent(origin, ray_dir, ms, fn, ior, ext_ior)
        # exit rays against the screen plane
        sn, spt = f32(screen_normal), f32(screen_point)
        denom = torch.sum(res.direction * sn, dim=1)
        denom_safe = torch.where(torch.abs(denom) > 1e-9, denom,
                                 torch.full_like(denom, 1e-9))
        t = torch.sum((spt - res.origin) * sn, dim=1) / denom_safe
        pt = res.origin + t[:, None] * res.direction
        valid = res.valid & (t > 0) & (torch.abs(denom) > 1e-9)
        screen_pixel = torch.where(valid[:, None], pt, torch.zeros_like(pt))
        mask_img = render_mask(origin, ray_dir, ms, fn).reshape(resy, resx)
        views.append(dict(
            screen_pixel=screen_pixel.cpu().numpy(),
            valid=valid.cpu().numpy(),
            mask=process_mask((mask_img > 0.5).cpu().numpy()
                              .astype(np.uint8)),
            origin=origin[:1].cpu().numpy(),   # pinhole: one per view
            ray_dir=ray_dir.cpu().numpy(),
            R=R, K=K,
        ))
    if cache_path:
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)),
                    exist_ok=True)
        payload = {"num_views": num_views, "resy": resy, "resx": resx}
        for i, vw in enumerate(views):
            payload.update({f"sp{i}": vw["screen_pixel"], f"va{i}": vw["valid"],
                            f"mk{i}": vw["mask"], f"or{i}": vw["origin"],
                            f"rd{i}": vw["ray_dir"], f"R{i}": vw["R"],
                            f"K{i}": vw["K"]})
        np.savez_compressed(cache_path, **payload)
    return CaptureData(name=name, resy=resy, resx=resx, num_views=num_views,
                       views=stack_views(views, device=device),
                       num_view_used=num_view_used)

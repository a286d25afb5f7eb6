"""The benchmark's synthetic capture: a ring of pinhole cameras around the
ground-truth mesh, a screen plane behind it, and for every pixel the point
of the screen its ray meets after two refractions, with the soft
silhouette mask: the semantics of the port's `synthesize_capture`, made
here in plain PyTorch with the yardstick's own oracle, so that a change to
the program cannot move the inputs it is judged on.

A rig may state `"supersample": s` (an integer of at least 1; a rig
without the key takes 1): each pixel then gets an s x s grid of sub-pixel
rays, the layout of the port's `generate_rays(supersample=)`, and each
valid sub-ray keeps its own screen point. The mask stays one a pixel, the
hit of the ray through the pixel's centre, so the silhouette views are
those of the same rig at s = 1.

The capture depends on the configuration alone. It is made once per
checkout and kept in a cache directory (the harness gives
port_bench/.cache/): each view's matting-valid lanes and their screen
points, and its binary mask bit-packed; `load` rebuilds the views on the
device from that (the rays from the cameras, the soft masks from the
binary ones).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from port_bench.reference.mesh import ref_mesh
from port_bench.reference.oracle import Scene, closest_hit
from port_bench.reference.step import trace_exit

FORMAT = 1
TRACE_BLOCK = 2 ** 21   # rays a block of `make`'s traces


class Views(NamedTuple):
    """The capture on the device, one row per view, with the fields of the
    port's ViewBatch."""
    screen_pixel: torch.Tensor  # [V,N,3] float32, 0 where not valid;
                                # N = s^2 resy resx (`supersample`)
    valid: torch.Tensor         # [V,N] bool
    mask: torch.Tensor          # [V,resy,resx] float32 soft mask
    origin: torch.Tensor        # [V,1,3] the pinhole
    ray_dir: torch.Tensor       # [V,N,3] unit
    R: torch.Tensor             # [V,4,4] world to camera
    K: torch.Tensor             # [V,3,3]
    R_inv: torch.Tensor
    K_inv: torch.Tensor


def look_at(cam_pos, target, up=(0.0, 0.0, 1.0)):
    """4x4 world-to-camera matrix, camera +z looking at target."""
    z = np.asarray(target, np.float64) - cam_pos
    z /= np.linalg.norm(z)
    x = np.cross(z, np.asarray(up, np.float64))
    if np.linalg.norm(x) < 1e-9:
        x = np.cross(z, np.array([1.0, 0.0, 0.0]))
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.eye(4)
    R[:3, :3] = np.stack([x, y, z])
    R[:3, 3] = -R[:3, :3] @ cam_pos
    return R


def ring(gt_vertices: np.ndarray, rig: dict):
    """Per view (R, K, screen point, screen normal), float64."""
    center = gt_vertices.mean(axis=0)
    radius = float(np.linalg.norm(gt_vertices - center, axis=1).max())
    elev = np.deg2rad(rig["elevation_deg"])
    f = 0.5 * rig["resx"] / np.tan(np.deg2rad(rig["fov_deg"]) / 2)
    K = np.array([[f, 0.0, rig["resx"] / 2.0], [0.0, f, rig["resy"] / 2.0],
                  [0.0, 0.0, 1.0]])
    out = []
    for i in range(rig["num_views"]):
        th = 2 * np.pi * i / rig["num_views"]
        pos = center + rig["cam_distance_factor"] * radius * np.array(
            [np.cos(th) * np.cos(elev), np.sin(th) * np.cos(elev),
             np.sin(elev)])
        R = look_at(pos, center)
        z = R[2, :3]
        out.append((R, K, center + rig["screen_distance_factor"] * radius * z,
                    -z))
    return out


def supersample(rig: dict) -> int:
    """The rig's sub-pixel rays along each axis: its "supersample", 1
    where it states none."""
    s = rig.get("supersample", 1)
    if isinstance(s, bool) or not isinstance(s, int) or s < 1:
        raise ValueError(f"rig {rig.get('name')!r}: supersample {s!r} is "
                         "not an integer of at least 1")
    return s


def camera_rays(resy, resx, K_inv, R_inv, s=1):
    """(origin [3], unit directions [s^2 resy resx, 3]): each pixel's s x s
    sub-pixel rays at (i + 0.5)/s - 0.5 along each axis, row-major over the
    fine (resy s x resx s) grid, so that the sub-rays of pixel (y, x) sit
    at fine rows s y .. s y + s - 1 and columns s x .. s x + s - 1. With
    s = 1 the rays go through the integer pixel centres, row-major."""
    kw = dict(dtype=K_inv.dtype, device=K_inv.device)
    py, px = torch.meshgrid((torch.arange(resy * s, **kw) + 0.5) / s - 0.5,
                            (torch.arange(resx * s, **kw) + 0.5) / s - 0.5,
                            indexing="ij")
    pix = torch.stack([px, py, torch.ones_like(py)], dim=2).reshape(-1, 3)
    world = (pix @ K_inv.T) @ R_inv[:3, :3].T + R_inv[:3, 3]
    origin = R_inv[:3, 3]
    d = world - origin
    return origin, d / torch.sqrt(torch.clamp((d * d).sum(-1), min=1e-20))[
        :, None]


def soft_mask(hit: torch.Tensor) -> torch.Tensor:
    """The soft mask [H,W] float32 of a binary silhouette [H,W] bool: the
    signed distance to the silhouette clipped to one pixel each way and
    mapped to [0,1] (1 inside; 0.5 one pixel out; (2 - sqrt 2)/2 a
    diagonal pixel out; 0 beyond), with the bottom row set to 0.5."""
    m = hit.to(torch.float32)[None, None]
    pad = torch.nn.functional.pad(m, (1, 1, 1, 1))
    h, w = hit.shape
    near = torch.zeros_like(hit)
    diag = torch.zeros_like(hit)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == dx == 0:
                continue
            nb = pad[0, 0, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w] > 0
            if dy == 0 or dx == 0:
                near |= nb
            else:
                diag |= nb
    diag_val = (1.0 - (math.sqrt(2.0) - 1.0)) / 2.0
    out = torch.zeros((h, w), dtype=torch.float64, device=hit.device)
    out = torch.where(diag, diag_val, out)
    out = torch.where(near, 0.5, out)
    out = torch.where(hit, 1.0, out)
    out[-1] = 0.5
    return out.to(torch.float32)


def _cameras(R, K, device):
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(R, **f32), torch.as_tensor(K, **f32),
            torch.as_tensor(np.linalg.inv(R), **f32),
            torch.as_tensor(np.linalg.inv(K), **f32))


def _blocks(n: int):
    """The slices of n rays that `make` traces at a time."""
    return [slice(b, min(b + TRACE_BLOCK, n))
            for b in range(0, n, TRACE_BLOCK)]


@torch.no_grad()
def make(gt_vertices: np.ndarray, gt_faces: np.ndarray, cfg: dict, device):
    """Render the capture: per view (valid lane indices int64, their screen
    points [n,3] float32, binary mask [resy*resx] bool), on the host. The
    rays are traced in blocks of TRACE_BLOCK."""
    rig = cfg["rig"]
    resy, resx, s = rig["resy"], rig["resx"], supersample(rig)
    mesh = ref_mesh(gt_vertices, gt_faces, device)
    scene = Scene(mesh.vertices, mesh.faces)
    out = []
    t0 = time.time()
    for i, (R, K, spt, sn) in enumerate(
            ring(np.asarray(gt_vertices, np.float64), rig)):
        if i % 12 == 0:
            print(f"capture: view {i} of {rig['num_views']}, "
                  f"{time.time() - t0:.1f} s", file=sys.stderr, flush=True)
        _, _, R_inv, K_inv = _cameras(R, K, device)
        origin, d = camera_rays(resy, resx, K_inv, R_inv, s)
        centre = d if s == 1 else camera_rays(resy, resx, K_inv, R_inv)[1]
        first = torch.cat([closest_hit(origin.expand(centre[b].shape),
                                       centre[b], scene)[1]
                           for b in _blocks(centre.shape[0])])
        sn_t = torch.as_tensor(sn, dtype=torch.float32, device=device)
        sp_t = torch.as_tensor(spt, dtype=torch.float32, device=device)
        lanes, points = [], []
        for b in _blocks(d.shape[0]):
            o2, d2, kept, esc, _ = trace_exit(
                origin.expand(d[b].shape), d[b], mesh.vertices, mesh.faces,
                scene, cfg["ior"], cfg["ext_ior"])
            denom = (d2 * sn_t).sum(-1)
            safe = torch.where(torch.abs(denom) > 1e-9, denom,
                               torch.full_like(denom, 1e-9))
            t = ((sp_t - o2) * sn_t).sum(-1) / safe
            ok = esc & (t > 0) & (torch.abs(denom) > 1e-9)
            lanes.append(kept[ok] + b.start)
            points.append((o2 + t[:, None] * d2)[ok])
        out.append((torch.cat(lanes).cpu().numpy(),
                    torch.cat(points).cpu().numpy(),
                    (first >= 0).cpu().numpy()))
    return out


def cache_key(cfg: dict) -> str:
    keys = {"format": FORMAT, "rig": cfg["rig"], "ior": cfg["ior"],
            "ext_ior": cfg["ext_ior"],
            "ground_truth": cfg["ground_truth"]["sha256"]}
    return hashlib.sha256(json.dumps(keys, sort_keys=True).encode()
                          ).hexdigest()[:16]


def build_or_read(gt_vertices, gt_faces, cfg: dict, device, cache_dir: str):
    """The capture's arrays from the cache, made and written there first
    if absent (atomically: written aside, then renamed)."""
    path = os.path.join(cache_dir, f"capture-{cache_key(cfg)}.npz")
    if not os.path.exists(path):
        views = make(gt_vertices, gt_faces, cfg, device)
        counts = np.array([len(v[0]) for v in views], dtype=np.int64)
        payload = dict(
            counts=counts,
            lanes=np.concatenate([v[0] for v in views]).astype(np.int32),
            points=np.concatenate([v[1] for v in views]).astype(np.float32),
            masks=np.stack([np.packbits(v[2]) for v in views]))
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, path)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load(gt_vertices, gt_faces, cfg: dict, device, cache_dir: str) -> Views:
    """The capture as device tensors (see `Views`): N = s^2 resy resx lanes
    a view (s the rig's `supersample`), the mask [V,resy,resx]; in float32,
    the one precision it is made in; a configuration that states another
    is refused."""
    if cfg["dtype"] != "float32":
        raise ValueError(f"configuration {cfg['name']!r} states "
                         f"{cfg['dtype']}; the capture is float32")
    rig = cfg["rig"]
    resy, resx, nv = rig["resy"], rig["resx"], rig["num_views"]
    s = supersample(rig)
    n = s * s * resy * resx
    arr = build_or_read(gt_vertices, gt_faces, cfg, device, cache_dir)
    cams = [_cameras(R, K, device)
            for R, K, _, _ in ring(np.asarray(gt_vertices, np.float64), rig)]
    R, K, R_inv, K_inv = (torch.stack(x) for x in zip(*cams))
    lanes = torch.as_tensor(arr["lanes"], device=device).long()
    points = torch.as_tensor(arr["points"], device=device)
    view_of = torch.repeat_interleave(
        torch.arange(nv, device=device),
        torch.as_tensor(arr["counts"], device=device))
    flat = view_of * n + lanes
    valid = torch.zeros(nv * n, dtype=torch.bool, device=device)
    valid[flat] = True
    sp = torch.zeros((nv * n, 3), dtype=torch.float32, device=device)
    sp[flat] = points
    bits = torch.as_tensor(arr["masks"], device=device)
    shifts = torch.arange(7, -1, -1, device=device, dtype=torch.uint8)
    hit = ((bits[:, :, None] >> shifts) & 1).reshape(nv, -1)[
        :, :resy * resx] > 0
    masks = torch.stack([soft_mask(h.reshape(resy, resx)) for h in hit])
    origin = torch.empty((nv, 1, 3), dtype=torch.float32, device=device)
    ray_dir = torch.empty((nv, n, 3), dtype=torch.float32, device=device)
    for i in range(nv):
        origin[i, 0], ray_dir[i] = camera_rays(resy, resx, K_inv[i],
                                               R_inv[i], s)
    return Views(screen_pixel=sp.reshape(nv, n, 3), valid=valid.reshape(nv, n),
                 mask=masks, origin=origin, ray_dir=ray_dir, R=R, K=K,
                 R_inv=R_inv, K_inv=K_inv)

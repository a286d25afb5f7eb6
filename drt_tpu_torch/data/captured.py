"""Loader and writer for the reference's h5 capture files (port of
drt_tpu/data/captured.py).

Schema (reference captured_data.py:99-108, 141-148):
  cam_proj [72,4,4]        world->camera extrinsics
  cam_k    [3,3]           shared intrinsics
  screen_position [72,N,3] environment-matting target per pixel
  mask     [72,resy,resx]  binary silhouette
  ray_origin/ray_dir [72,N,3]  (Pointgray captures only; Redmi rays are
                                computed from K,R — captured_data.py:149)

The capture files themselves are not vendored upstream; this loader exists
for users who have them. Camera rig assignment and resolutions: reference
optim.py:133-134, captured_data.py:90-91,131-132. `h5py` is imported at
first use, so the package imports without it.
"""

from __future__ import annotations

import numpy as np
import torch

from drt_tpu_torch.config import POINTGRAY_OBJECTS, REDMI_OBJECTS
from drt_tpu_torch.data.masks import process_mask
from drt_tpu_torch.data.views import CaptureData, stack_views


def _redmi_rays(R: np.ndarray, K: np.ndarray, resy: int, resx: int):
    """Per-pixel rays of a pinhole view from its K and R, in float32 as the
    JAX package makes them (its arrays are float32 with x64 off)."""
    from drt_tpu_torch.render.camera import CameraM, generate_rays

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32)

    cam = CameraM(f32(R), f32(K), f32(np.linalg.inv(R)),
                  f32(np.linalg.inv(K)))
    o, d = generate_rays(resy, resx, cam)
    return o.numpy(), d.numpy()


def load_h5_capture(path: str, name: str, num_view_used: int = 72,
                    num_views: int | None = None, resy: int | None = None,
                    resx: int | None = None, device="cuda") -> CaptureData:
    """Load a capture in the reference schema, its views on `device`. The
    object name selects the rig (optim.py:133-134): Pointgray captures carry
    per-pixel rays, Redmi rays are synthesized from K,R
    (captured_data.py:149). num_views and resy/resx default to what the
    FILE contains (cam_proj count, mask shape), so reduced-resolution or
    reduced-view captures load through the same path as full rig
    captures."""
    import h5py

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_h5_capture(device='cuda'): torch sees no "
                           "CUDA device; pass device='cpu' to run on the CPU")
    if name in POINTGRAY_OBJECTS:
        has_rays = True
    elif name in REDMI_OBJECTS:
        has_rays = False
    else:
        raise ValueError(f"unknown object {name!r}")

    views = []
    with h5py.File(path, "r") as h5:
        if num_views is None:
            num_views = int(h5["cam_proj"].shape[0])
        if resy is None or resx is None:
            resy, resx = (int(s) for s in h5["mask"].shape[1:3])
        K = np.asarray(h5["cam_k"][:])
        for i in range(num_views):
            R = np.asarray(h5["cam_proj"][i])
            screen_pixel = np.asarray(h5["screen_position"][i]).reshape(-1, 3)
            mask = process_mask(np.asarray(h5["mask"][i]))
            valid = screen_pixel[:, 0] != 0
            if has_rays:
                origin = np.asarray(h5["ray_origin"][i]).reshape(-1, 3)
                ray_dir = np.asarray(h5["ray_dir"][i]).reshape(-1, 3)
            else:
                origin, ray_dir = _redmi_rays(R, K, resy, resx)
            views.append(dict(screen_pixel=screen_pixel, valid=valid,
                              mask=mask, origin=origin, ray_dir=ray_dir,
                              R=R, K=K))

    return CaptureData(name=name, resy=resy, resx=resx, num_views=num_views,
                       views=stack_views(views, device=device),
                       num_view_used=min(num_view_used, num_views))


def save_h5_capture(cap: CaptureData, path: str) -> None:
    """Write a CaptureData out in the reference's h5 schema
    (captured_data.py:99-108): cam_proj/cam_k/screen_position/mask and, for
    Pointgray-rig objects, per-pixel ray_origin/ray_dir. Masks are stored
    binary (the schema's convention; process_mask re-softens them on load).

    Lets synthetic captures be consumed by the upstream reference verbatim,
    and gives load_h5_capture a round-trip test fixture.
    """
    import h5py

    def host(x, dtype=None):
        a = x.detach().cpu().numpy()
        return a.astype(dtype) if dtype is not None else a

    has_rays = cap.name in POINTGRAY_OBJECTS
    v = cap.views
    num = cap.num_views
    n_pix = cap.resy * cap.resx
    with h5py.File(path, "w") as h5:
        h5.create_dataset("cam_k", data=host(v.K[0], np.float64))
        h5.create_dataset("cam_proj", data=host(v.R, np.float64))
        # invalid pixels carry screen_position == 0 (the schema's validity
        # convention: captured_data.py:106  valid = screen_pixel[:,0] != 0)
        sp = host(v.screen_pixel, np.float64)
        sp[~host(v.valid)] = 0.0
        h5.create_dataset("screen_position", data=sp)
        binary = (host(v.mask) >= 0.99).astype(np.uint8)
        h5.create_dataset("mask", data=binary)
        if has_rays:
            d = host(v.ray_dir, np.float64)
            o = np.broadcast_to(host(v.origin, np.float64), (num, n_pix, 3))
            h5.create_dataset("ray_origin", data=o)
            h5.create_dataset("ray_dir", data=d)

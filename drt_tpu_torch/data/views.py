"""View containers and view-index generators (port of
drt_tpu/data/views.py; reference captured_data.py:43-82). All views are
stacked into device tensors once; a step indexes a view with `take`."""

from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple

import numpy as np
import torch

from drt_tpu_torch.render.camera import CameraM


class ViewBatch(NamedTuple):
    """Stacked views; leading axis = view index."""

    screen_pixel: torch.Tensor  # [V,N,3]
    valid: torch.Tensor         # [V,N] bool
    mask: torch.Tensor          # [V,resy,resx] soft mask
    origin: torch.Tensor        # [V,N,3], or [V,1,3] for pinhole captures
    ray_dir: torch.Tensor       # [V,N,3]
    R: torch.Tensor             # [V,4,4]
    K: torch.Tensor             # [V,3,3]
    R_inv: torch.Tensor         # [V,4,4]
    K_inv: torch.Tensor         # [V,3,3]

    def take(self, v, rays: bool = True):
        """One view as (screen_pixel, valid, mask, origin, ray_dir, camera);
        compact [1,3] origins are broadcast back to per-pixel.

        v: an int, or a one-element int64 tensor on the views' device (a
        CUDA graph selects its views by device index): the same bits, taken
        by `index_select` without a host read (indexing by a 0-d tensor
        would read it). rays=False leaves out what only the ray loss reads:
        screen_pixel, valid and ray_dir are None and origin is the view's
        first [1,3] row, all a silhouette view needs."""
        if isinstance(v, torch.Tensor):
            i = v.reshape(1)

            def pick(x):
                return x.index_select(0, i)[0]
        else:
            def pick(x):
                return x[v]
        cam = CameraM(pick(self.R), pick(self.K), pick(self.R_inv),
                      pick(self.K_inv))
        if not rays:
            return (None, None, pick(self.mask), pick(self.origin[:, :1]),
                    None, cam)
        origin = pick(self.origin)
        ray_dir = pick(self.ray_dir)
        if origin.shape[0] == 1 and ray_dir.shape[0] != 1:
            origin = origin.expand(ray_dir.shape)
        return (pick(self.screen_pixel), pick(self.valid), pick(self.mask),
                origin, ray_dir, cam)


@dataclasses.dataclass
class CaptureData:
    """A capture: stacked views + capture geometry metadata."""

    name: str
    resy: int
    resx: int
    num_views: int
    views: ViewBatch
    num_view_used: int = 72

    def ray_view_generator(self, seed: int = 0,
                           special_case_mouse: bool = True) -> Iterator[int]:
        """Infinite shuffled ray-loss view indices (reference
        captured_data.py:61-75, with the mouse view list at :66-69)."""
        step = max(1, self.num_views // max(1, self.num_view_used))
        index = list(np.arange(0, self.num_views, step))
        if special_case_mouse and self.name == "mouse":
            index = list(np.arange(-5, 10)) + list(np.arange(22, 40))
        rng = np.random.default_rng(seed)
        while True:
            rng.shuffle(index)
            for i in index:
                yield int(i) % self.num_views

    def silh_view_generator(self, seed: int = 1) -> Iterator[int]:
        """Infinite shuffled stream over all views (captured_data.py:77-82)."""
        index = list(np.arange(self.num_views))
        rng = np.random.default_rng(seed)
        while True:
            rng.shuffle(index)
            for i in index:
                yield int(i)


def downsample_capture(cap: CaptureData, k: int) -> CaptureData:
    """Subsample a capture's pixel grid by k in each dimension, keeping
    pixels (k*i, k*j), so that one full-resolution synthesis serves every
    lower resolution. The intrinsics scale exactly: u' = u/k, so
    K' = diag(1/k, 1/k, 1) @ K (up to the half-pixel-centre offset, less
    than k/2 px). K_inv is inverted in float64 and then cast, as in the JAX
    package."""
    v = cap.views
    resy, resx = cap.resy // k, cap.resx // k

    def grid(a):
        """[V,N,...] row-major -> subsampled and flattened again."""
        full = a.reshape((a.shape[0], cap.resy, cap.resx) + a.shape[2:])
        sub = full[:, ::k, ::k]
        return sub.reshape((a.shape[0], resy * resx) + a.shape[2:])

    scale = torch.tensor([1.0 / k, 1.0 / k, 1.0], dtype=v.K.dtype,
                         device=v.K.device)
    K = v.K * scale[None, :, None]
    origin = v.origin if v.origin.shape[1] == 1 else grid(v.origin)
    views = ViewBatch(
        screen_pixel=grid(v.screen_pixel),
        valid=grid(v.valid),
        mask=v.mask[:, ::k, ::k].contiguous(),
        origin=origin,
        ray_dir=grid(v.ray_dir),
        R=v.R, K=K, R_inv=v.R_inv,
        K_inv=torch.linalg.inv(K.double()).to(v.K_inv.dtype),
    )
    return dataclasses.replace(cap, resy=resy, resx=resx, views=views)


def stack_views(view_list, dtype=torch.float32, device="cuda") -> ViewBatch:
    """view_list: dicts with numpy screen_pixel/valid/mask/origin/ray_dir/
    R/K. Inverses are computed here in float64."""
    def cat(key):
        return np.stack([np.asarray(v[key]) for v in view_list])

    def cat_origin():
        arrs = [np.asarray(v["origin"]) for v in view_list]
        if all((a == a[0]).all() for a in arrs):
            return np.stack([a[:1] for a in arrs])
        return np.stack(arrs)

    R = cat("R").astype(np.float64)
    K = cat("K").astype(np.float64)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    return ViewBatch(
        screen_pixel=t(cat("screen_pixel")),
        valid=t(cat("valid").astype(bool), torch.bool),
        mask=t(cat("mask")),
        origin=t(cat_origin()),
        ray_dir=t(cat("ray_dir")),
        R=t(R), K=t(K), R_inv=t(np.linalg.inv(R)), K_inv=t(np.linalg.inv(K)),
    )

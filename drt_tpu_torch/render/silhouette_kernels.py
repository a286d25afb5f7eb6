"""A silhouette view's loss as three hand-written CUDA kernels around its
oracle query (csrc/silhouette.cu), with their plain versions and the
autograd Function that joins them.

`silhouette_view_loss(mesh, cam, intersect_fn, budget, resy, resx,
bilinear_mask)` is what `optimize.losses.silhouette_loss` computes through
`render.silhouette.primary_visibility` (drt_tpu/render/silhouette.py:29-55
and :143-173, drt_tpu/render/camera.py:68, drt_tpu/optimize/losses.py:
109-146): (loss, count), the loss differentiable in the mesh's vertices.

- before the query (`silhouette_pre_*`): each face's side of the camera,
  the silhouette edges (the two faces' sides differ, the edge valid), the
  first `budget` of them in edge order, edge 0 past the count, and the
  count; the selected edges' endpoints projected with the camera depth
  detached, each edge's screen midpoint and normal N, and the two sample
  points one pixel either side along N back-projected into the query's ray
  directions;
- the oracle query, as `primary_visibility` makes it: one origin row
  expanded over the 2K rays (the oracle's one-origin route);
- after it (`silhouette_post_*`): f = occupancy (upper) - occupancy
  (lower), the pixel, the edge's validity (selected, |f| > 1e-5, in view),
  the mask read (truncated, or bilinear), |mask - 0.5| summed over the
  valid edges in one fixed tree, and each edge's coefficient sign(mask -
  0.5) f (0 where not valid);
- the backward (`silhouette_backward_*`): the loss's cotangent into the 2K
  endpoint rows, dE = -N f g_output for both endpoints, then the
  projection's backward with the depth detached; `scatter_rows`
  (csrc/scatter.cu) adds them into the vertex gradient.

The camera, its origin and the mask come from the stacked views at the
view's index (`ViewCamera`): on the card the kernels read them there, so a
step takes no copy of a view.

On CPU tensors each part runs its plain version: torch operations on the
components in csrc/silhouette.cu's order, each product and sum rounded on
its own, the backward written out by hand. On CUDA tensors each launches its
kernel, which gives the plain version's bits, or raises; nothing falls back.
tests/test_torch_silhouette_kernels.py holds the plain versions to the JAX
package.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from drt_tpu_torch import kernels
from drt_tpu_torch.geometry.scatter import scatter_rows
from drt_tpu_torch.geometry.vec import (comp_cross as _cross, comp_dot as _dot,
                                        comp_sub as _sub, components as _cols,
                                        const_like, tree_sum)
from drt_tpu_torch.render import silhouette as _silhouette

# csrc/silhouette.cu's launch shapes: the post kernel's sum runs over
# SUM_BLOCKS virtual blocks of BLOCK threads; the backward's threads a
# block.
BLOCK = 1024
SUM_BLOCKS = 16
BWD_BLOCK = 256


class ViewCamera(NamedTuple):
    """A view's camera, origin and mask, as rows of the stacked views:
    R, R_inv [V,4,4], K, K_inv [V,3,3], origin [V,3] (each view's origin
    row; any stride between views), mask [V,H,W] (read at pixels below
    the loss's resy and resx, as the mask's own rows lie); `view` the
    view's row, a [1] int64 tensor on their device."""
    R: torch.Tensor
    K: torch.Tensor
    R_inv: torch.Tensor
    K_inv: torch.Tensor
    origin: torch.Tensor
    mask: torch.Tensor
    view: torch.Tensor


def view_camera(views, i) -> ViewCamera:
    """View i of a `ViewBatch` (an int, or a one-element int64 tensor on the
    views' device): no copy of the view, no host read."""
    if not isinstance(i, torch.Tensor):
        i = torch.full((1,), i, dtype=torch.int64, device=views.origin.device)
    return ViewCamera(views.R, views.K, views.R_inv, views.K_inv,
                      views.origin[:, 0], views.mask, i.reshape(1))


def one_camera(cam, origin, mask) -> ViewCamera:
    """The ViewCamera of one view: its camera (a `CameraM`), origin [3] and
    mask [H,W]."""
    return ViewCamera(cam.R[None], cam.K[None], cam.R_inv[None],
                      cam.K_inv[None], origin.reshape(1, 3), mask[None],
                      torch.zeros(1, dtype=torch.int64, device=origin.device))


def tuple_camera(view) -> ViewCamera:
    """The camera of a view tuple as `ViewBatch.take` gives it
    (screen_pixel, valid, mask, origin, ray_dir, camera)."""
    _sp, _valid, mask, origin, _rd, cam = view
    return one_camera(cam, origin[0], mask)


def _pick(x, view):
    return x.index_select(0, view)[0]


class PreOut(NamedTuple):
    """What the pre kernel writes."""
    edge_idx: torch.Tensor   # [K] int64 the selected edges, 0 past the count
    count: torch.Tensor      # [] int64 the silhouette edges (may exceed K)
    origin: torch.Tensor     # [3] the view's origin
    ray_dir: torch.Tensor    # [2K,3] the upper sample points' rays, then
                             # the lower ones' (not normalized)
    sample: torch.Tensor     # [K,2] screen midpoint (x, y)
    normal: torch.Tensor     # [K,2] screen normal N = (ay - by, bx - ax)
    pix: torch.Tensor        # [2K,3] each endpoint's (x, y, depth p2)
    vidx: torch.Tensor       # [2K] int64 each endpoint's vertex


# -- the arithmetic, on tuples of components -----------------------------------

def _project(R, K, V):
    """csrc/silhouette.cu's `project`: (x, y, p2) of rows V (components)."""
    c = [((R[j, 0] * V[0] + R[j, 1] * V[1]) + R[j, 2] * V[2]) + R[j, 3]
         for j in range(3)]
    p = [(K[i, 0] * c[0] + K[i, 1] * c[1]) + K[i, 2] * c[2]
         for i in range(3)]
    return p[0] / p[2], p[1] / p[2], p[2]


def _back_project(Ki, Ri, o, fx, fy):
    """csrc/silhouette.cu's `back_project`: the direction [N,3] from o
    through screen points (fx, fy)."""
    c = [(Ki[i, 0] * fx + Ki[i, 1] * fy) + Ki[i, 2] for i in range(3)]
    return torch.stack(
        [(((Ri[i, 0] * c[0] + Ri[i, 1] * c[1]) + Ri[i, 2] * c[2]) + Ri[i, 3])
         - o[i] for i in range(3)], dim=1)


# -- the plain versions ---------------------------------------------------------

def silhouette_pre_plain(vertices, faces, edge_faces, edge_valid, edges,
                         cam: ViewCamera, budget: int) -> PreOut:
    """Plain version of csrc/silhouette.cu's pre kernel (vertices taken
    detached)."""
    v = vertices.detach()
    R, K, Ri, Ki = (_pick(x, cam.view) for x in (cam.R, cam.K, cam.R_inv,
                                                  cam.K_inv))
    o = _pick(cam.origin, cam.view)
    v0, v1, v2 = (_cols(v[faces[:, j]]) for j in range(3))
    n = _cross(_sub(v1, v0), _sub(v2, v0))
    up = _dot(n, _sub(o, v0)) > const_like(v, 0.0)
    side = up[edge_faces]
    silh = (side[:, 0] != side[:, 1]) & edge_valid
    edge_idx, _sel_valid, count = _silhouette.select_edges(silh, budget)
    vidx = edges[edge_idx].reshape(-1)
    x, y, p2 = _project(R, K, _cols(v[vidx]))
    pix = torch.stack([x, y, p2], dim=1)
    ax, ay, bx, by = x[0::2], y[0::2], x[1::2], y[1::2]
    half = const_like(v, 0.5)
    sx, sy = (ax + bx) * half, (ay + by) * half
    nx, ny = ay - by, bx - ax
    den = torch.maximum(torch.sqrt(nx * nx + ny * ny), const_like(v, 1e-12))
    ux, uy = nx / den, ny / den
    ray_dir = torch.cat([_back_project(Ki, Ri, o, sx + ux, sy + uy),
                         _back_project(Ki, Ri, o, sx - ux, sy - uy)])
    return PreOut(edge_idx, count, o.clone(), ray_dir,
                  torch.stack([sx, sy], dim=1), torch.stack([nx, ny], dim=1),
                  pix, vidx)


def loss_sum(values: torch.Tensor) -> torch.Tensor:
    """The sum (0-d) of the slots' values [K] in csrc/silhouette.cu's fixed
    order: value s in virtual thread s % (SUM_BLOCKS * BLOCK), in ascending
    s, then the halving trees over each block's threads and the blocks."""
    return tree_sum(values, (SUM_BLOCKS, BLOCK))


def silhouette_post_plain(tri_id, sample, count, cam: ViewCamera, resy: int,
                          resx: int, bilinear: bool = False):
    """Plain version of csrc/silhouette.cu's post kernel: (loss [], coef
    [K]) from the query's tri_id [2K] and the pre kernel's sample and
    count."""
    mask = _pick(cam.mask, cam.view)
    k = sample.shape[0]
    occ = (tri_id >= 0).to(sample.dtype)
    f = occ[:k] - occ[k:]
    sx, sy = sample[:, 0], sample[:, 1]
    px, py = sx.to(torch.int32), sy.to(torch.int32)
    valid = ((torch.arange(k, device=sample.device) < count)
             & (torch.abs(f) > const_like(f, 1e-5))
             & (px >= 0) & (px < resx - 1) & (py >= 0) & (py < resy - 1))
    zero, one = const_like(f, 0.0), const_like(f, 1.0)
    if bilinear:
        x0 = torch.floor(sx).long().clamp(0, resx - 2)
        y0 = torch.floor(sy).long().clamp(0, resy - 2)
        wx = torch.minimum(torch.maximum(sx - x0.to(sx.dtype), zero), one)
        wy = torch.minimum(torch.maximum(sy - y0.to(sy.dtype), zero), one)
        r0 = (one - wx) * mask[y0, x0] + wx * mask[y0, x0 + 1]
        r1 = (one - wx) * mask[y0 + 1, x0] + wx * mask[y0 + 1, x0 + 1]
        picked = (one - wy) * r0 + wy * r1
    else:
        picked = mask[py.clamp(0, resy - 1).long(),
                      px.clamp(0, resx - 1).long()]
    diff = picked - const_like(f, 0.5)
    sign = torch.sign(diff)
    coef = torch.where(valid, sign * f, zero)
    return loss_sum(torch.where(valid, sign * diff, zero)), coef


def silhouette_backward_plain(normal, coef, pix, cam: ViewCamera, g):
    """Plain version of csrc/silhouette.cu's backward: dV [2K,3], the
    loss's gradient in the 2K endpoint rows for its cotangent g (0-d)."""
    R, K = _pick(cam.R, cam.view), _pick(cam.K, cam.view)
    c = coef.repeat_interleave(2)
    t = c * g
    n = normal.repeat_interleave(2, dim=0)
    dx, dy = n[:, 0] * t, n[:, 1] * t
    x, y, p2 = _cols(pix)
    g0, g1 = dx / p2, dy / p2
    g2 = -((dx * x + dy * y) / p2)
    gc = [(K[0, j] * g0 + K[1, j] * g1) + K[2, j] * g2 for j in range(2)]
    dV = torch.stack([R[0, k] * gc[0] + R[1, k] * gc[1] for k in range(3)],
                     dim=1)
    return torch.where((c != 0)[:, None], dV, const_like(dV, 0.0))


# -- the kernels' wrappers ------------------------------------------------------

@kernels.checks("silhouette_pre", "silhouette_post", "silhouette_backward")
def _check_lib(lib):
    """csrc/silhouette.cu's launch shapes, which fix the loss's summation
    order, and a card that schedules its cluster."""
    got = (lib.silhouette_block(), lib.silhouette_sum_blocks(),
           lib.silhouette_bwd_block())
    if got != (BLOCK, SUM_BLOCKS, BWD_BLOCK):
        raise RuntimeError(f"csrc/silhouette.cu launches (block, sum "
                           f"blocks, backward block) {got}, the plain "
                           f"version sums as {(BLOCK, SUM_BLOCKS)}")
    if lib.silhouette_cluster_size() < 1:
        raise RuntimeError("silhouette: the card schedules no cluster of "
                           "the kernels' CTAs")


def _check_cam(cam: ViewCamera, dtype, device, resy=None, resx=None):
    n = cam.R.shape[0]
    for name, t, shape in (("R", cam.R, (n, 4, 4)), ("K", cam.K, (n, 3, 3)),
                           ("R_inv", cam.R_inv, (n, 4, 4)),
                           ("K_inv", cam.K_inv, (n, 3, 3))):
        kernels.expect(name, t, shape, dtype, device)
    o = cam.origin
    if (tuple(o.shape) != (n, 3) or o.dtype != dtype or o.device != device
            or o.stride(1) != 1):
        raise ValueError(f"origin: expected [{n},3] {dtype} rows on {device},"
                         f" got {tuple(o.shape)} {o.dtype} on {o.device}")
    if resy is not None:
        m = cam.mask
        if (m.dim() != 3 or m.shape[0] != n or m.shape[1] < resy
                or m.shape[2] < resx or m.dtype != dtype
                or m.device != device or m.stride(2) != 1):
            raise ValueError(f"mask: expected [{n},>={resy},>={resx}] {dtype} "
                             f"rows on {device}, got {tuple(m.shape)} "
                             f"{m.dtype} on {m.device}")
    kernels.expect("view", cam.view, (1,), torch.int64, device)


def silhouette_pre_cuda(vertices, faces, edge_faces, edge_valid, edges,
                        cam: ViewCamera, budget: int) -> PreOut:
    """Launch csrc/silhouette.cu's pre kernel on the current stream: what
    `silhouette_pre_plain` gives, bit for bit. Nothing waits on the host."""
    v = vertices.detach()
    dev, dt = v.device, v.dtype
    kernels.expect("vertices", v, (None, 3), kernels.FLOATS, dev)
    kernels.need_cuda("silhouette_pre_cuda", v)
    nf, ne = faces.shape[0], edges.shape[0]
    kernels.expect("faces", faces, (nf, 3), torch.int64, dev)
    kernels.expect("edge_faces", edge_faces, (ne, 2), torch.int64, dev)
    kernels.expect("edge_valid", edge_valid, (ne,), torch.bool, dev)
    kernels.expect("edges", edges, (ne, 2), torch.int64, dev)
    _check_cam(cam, dt, dev)
    if budget < 1 or nf < 1:
        raise ValueError(f"silhouette_pre_cuda: budget {budget}, {nf} faces")
    f64 = dt == torch.float64
    lib = kernels.library("silhouette_pre")
    if lib.silhouette_pre_smem(nf, ne, f64) > lib.silhouette_pre_smem_cap():
        raise ValueError(f"silhouette_pre_cuda: {nf} faces and {ne} edges "
                         "exceed the pre kernel's shared memory")
    i64 = dict(dtype=torch.int64, device=dev)
    fl = dict(dtype=dt, device=dev)
    out = PreOut(torch.empty(budget, **i64), torch.empty((), **i64),
                 torch.empty(3, **fl), torch.empty((2 * budget, 3), **fl),
                 torch.empty((budget, 2), **fl), torch.empty((budget, 2), **fl),
                 torch.empty((2 * budget, 3), **fl),
                 torch.empty(2 * budget, **i64))
    kernels.launch(
        "silhouette_pre", v, ("silhouette_pre_launches",), verts=v, f64=f64,
        faces=faces, n_faces=nf, edge_faces=edge_faces,
        edge_valid=edge_valid, edges=edges, n_edges=ne, R=cam.R, K=cam.K,
        R_inv=cam.R_inv, K_inv=cam.K_inv, org=cam.origin,
        org_stride=cam.origin.stride(0), view=cam.view, budget=budget,
        edge_idx=out.edge_idx, count=out.count, org_out=out.origin,
        ray_dir=out.ray_dir, sample=out.sample, normal=out.normal,
        pix=out.pix, vidx=out.vidx)
    return out


def silhouette_post_cuda(tri_id, sample, count, cam: ViewCamera, resy: int,
                         resx: int, bilinear: bool = False):
    """Launch csrc/silhouette.cu's post kernel: what `silhouette_post_plain`
    gives, bit for bit (the loss a 0-d tensor on the card; nothing
    waits)."""
    k, dev, dt = sample.shape[0], sample.device, sample.dtype
    kernels.expect("sample", sample, (k, 2), kernels.FLOATS, dev)
    kernels.need_cuda("silhouette_post_cuda", sample)
    kernels.expect("tri_id", tri_id, (2 * k,), torch.int32, dev)
    kernels.expect("count", count, (), torch.int64, dev)
    _check_cam(cam, dt, dev, resy, resx)
    loss = torch.empty((), dtype=dt, device=dev)
    coef = torch.empty(k, dtype=dt, device=dev)
    kernels.launch(
        "silhouette_post", sample, ("silhouette_post_launches",),
        tri_id=tri_id, sample=sample, count=count, mask=cam.mask,
        f64=dt == torch.float64, mask_stride=cam.mask.stride(0),
        mask_row=cam.mask.stride(1), view=cam.view, resy=resy, resx=resx,
        bilinear=bool(bilinear), budget=k, loss=loss, coef=coef)
    return loss, coef


def silhouette_backward_cuda(normal, coef, pix, cam: ViewCamera, g):
    """Launch csrc/silhouette.cu's backward: what
    `silhouette_backward_plain` gives, bit for bit."""
    k, dev, dt = coef.shape[0], coef.device, coef.dtype
    kernels.expect("coef", coef, (k,), kernels.FLOATS, dev)
    kernels.need_cuda("silhouette_backward_cuda", coef)
    kernels.expect("normal", normal, (k, 2), dt, dev)
    kernels.expect("pix", pix, (2 * k, 3), dt, dev)
    kernels.expect("g", g, (), dt, dev)
    _check_cam(cam, dt, dev)
    dV = torch.empty((2 * k, 3), dtype=dt, device=dev)
    kernels.launch(
        "silhouette_backward", coef, ("silhouette_backward_launches",),
        normal=normal, coef=coef, pix=pix, R=cam.R, K=cam.K,
        f64=dt == torch.float64, view=cam.view, g=g, budget=k, dV=dV)
    return dV


# -- the autograd Function ------------------------------------------------------

class _SilhouetteView(torch.autograd.Function):
    """A silhouette view's loss (see `silhouette_view_loss`): the pre
    kernel, the oracle query and the post kernel forward; the backward
    kernel and the scatter of its rows backward."""

    @staticmethod
    def forward(ctx, vertices, mesh, cam, intersect_fn, budget, resy, resx,
                bilinear):
        v = vertices.detach()
        pre = kernels.on_device(v, silhouette_pre_cuda,
                                silhouette_pre_plain)(
            v, mesh.faces, mesh.edge_faces, mesh.edge_valid, mesh.edges, cam,
            budget)
        # one origin row for every ray (stride 0): the cuda oracle sees that
        # the rays share it and sorts them along the screen
        hits = intersect_fn(pre.origin.expand(pre.ray_dir.shape),
                            pre.ray_dir, v, mesh.faces, mesh.face_valid,
                            coherent=False)
        post = kernels.on_device(v, silhouette_post_cuda,
                                 silhouette_post_plain)
        loss, coef = post(
            hits.tri_id.contiguous(), pre.sample, pre.count, cam, resy, resx,
            bilinear)
        ctx.mark_non_differentiable(pre.count)
        ctx.save_for_backward(pre.normal, coef, pre.pix, pre.vidx)
        ctx.cam, ctx.num = cam, vertices.shape[0]
        return loss, pre.count

    @staticmethod
    def backward(ctx, g, _g_count):
        normal, coef, pix, vidx = ctx.saved_tensors
        dV = kernels.on_device(coef, silhouette_backward_cuda,
                               silhouette_backward_plain)(
            normal, coef, pix, ctx.cam, g.contiguous())
        return (scatter_rows(dV, vidx, ctx.num),) + (None,) * 7


def silhouette_view_loss(mesh, cam: ViewCamera, intersect_fn: Callable,
                         budget: int, resy: int, resx: int,
                         bilinear_mask: bool = False):
    """One silhouette view's loss and its true silhouette-edge count (0-d
    int64), as `optimize.losses.silhouette_loss` defines them, for the view
    `cam` (`view_camera`, `one_camera`, `tuple_camera`); differentiable in
    mesh.vertices. The camera and the mask must have the vertices' type."""
    return _SilhouetteView.apply(mesh.vertices, mesh, cam, intersect_fn,
                                 int(budget), int(resy), int(resx),
                                 bool(bilinear_mask))

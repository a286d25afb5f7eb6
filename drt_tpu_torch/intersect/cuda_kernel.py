"""Chunk-culled closest-hit oracle: three hand-written CUDA kernels a query
(port of drt_tpu/intersect/pallas_kernel.py, with the stages it takes from
drt_tpu/intersect/culled.py).

Stages:
1. shift the scene by the mean ray origin (small coordinates keep the
   Plücker products precise for small triangles): a torch mean, unless
   `shift` is given;
2. `pack`, the packing stages, one launch of csrc/pack.cu on CUDA tensors
   (its plain version `pack_plain`, made of the torch stages below, on CPU
   tensors): the [NC,19,C] Plücker coefficients of C=128 Morton-consecutive
   triangles a chunk (`_coef_packed` over `_triangle_coefficients`: the 19
   nonzero coefficients of a triangle, one chunk's rows contiguous so the
   closest-hit kernel takes them in one bulk copy, where the JAX package's
   dense [NC,10,4C] keeps zero blocks for the TPU's matrix unit); the chunk
   AABBs and validity (`_chunk_aabbs`: padded chunks are invalid so they are
   never candidates); with `group` > 1 (the second level of the candidate
   hierarchy) the boxes of `group` consecutive chunks (`_grouped_boxes`),
   which the prepass lists; and the ray features: shifted and padded
   origins, directions, o x d and the guarded inverse directions. A mesh
   above MAX_CHUNKS chunks is always grouped; below it incoherent queries
   take GROUP_INCOHERENT, the group measured fastest on the card;
3. `candidates`, the candidate prepass, per tile of rays
   (`RAY_TILE_COHERENT` or `RAY_TILE_INCOHERENT`): a nearest-first list of
   the boxes some ray of the tile may enter, and its length. One launch of
   the kernel csrc/candidates.cu scores, sorts and counts for every tile;
   its plain version `candidates_plain` runs on CPU tensors. Incoherent
   queries slab-test every (ray, box) pair exactly (`_candidates` is the
   plain version) over the boxes the tile's frustum enters
   (`frustum_kept_plain`: a superset of the boxes any of its rays enters,
   so the lists are the same); coherent queries bound a whole tile by
   interval arithmetic (`_candidates_tile`: a superset, cheap for camera
   rays);
4. `closest_hit`: the kernel (csrc/closest_hit.cu) on CUDA tensors, its
   plain version `closest_hit_plain` on CPU tensors. A listed group stands
   for its `group` chunks, visited in order; the per-ray gate drops those a
   ray does not enter, so the hits do not depend on the group but for ties
   between chunks at one t.
No fallback anywhere: a CUDA tensor launches the kernel or raises.

The one-origin route. An incoherent query whose rays all read one origin
row (`api.one_origin`: the silhouette sampler's) arrives in the mesh order
of its edges, so each ray tile's rays lie all over the silhouette and its
candidate list, the union of the boxes they enter, covers most of the
mesh. Such a query is sorted along the screen first: `ray_order` (one
launch of csrc/order.cu; plain version `ray_order_plain`) gives the order
of its rays by a Morton code of their directions, the packing stage reads
the rays through it, the prepass and the closest hit run on the sorted
lanes (`RAY_TILE_ONE_ORIGIN`, `GROUP_ONE_ORIGIN`), and the closest hit
writes each hit back to its ray's place. Its closest-hit blocks give a warp
RAY_LANES_ONE_ORIGIN rays, not 32: a silhouette query's rays graze the
surface and enter dozens of boxes each, and a warp walks the rays that
enter a chunk one after another, so fewer rays a warp cut the longest walk
and put more warps on the card. The shift stays the unsorted query's.
Every gate is the ray's own, so `hit` is the unsorted query's and t and
tri_id differ only at ties between chunks, as with groups. Every other
query keeps its route, launch for launch.

`t_min` (default 0) is the JAX package's: a chunk counts only where a ray
leaves its box beyond t_min, and a hit only where its t exceeds t_min.

Work is gated per ray: a chunk updates a ray only if the ray's own slab
test enters the chunk's box before its running best t. The JAX package's
`_kernel` lets a chunk update every ray of a tile once any one of its rays
overlaps; the port departs from it here (csrc/closest_hit.cu says why),
kernel and plain version alike, and both are held to the brute oracle.

The kernels are built, bound, launched and counted by
drt_tpu_torch/kernels.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from drt_tpu_torch import kernels
from drt_tpu_torch.intersect.api import Hits, one_origin
from drt_tpu_torch.intersect.resort import _spread3
from drt_tpu_torch.kernels import counters

_UV_EPS = 1e-5
# Rays per tile (one candidate list, one block of the prepass kernel), by the
# kind of query, and rays per block of the closest-hit kernel (a tile is a
# whole number of blocks).
RAY_TILE_COHERENT = 256
RAY_TILE_INCOHERENT = 128
BLOCK_RAYS = 64
# The one-origin route's ray tile, candidate group, closest-hit block and
# rays a warp, chosen on the card from the silhouette queries of
# dog_mid{20k,45k,90k} at their budgets (`scripts/tune_torch_oracle.py
# --what silhouette`, reports/torch_silhouette_order.json).
RAY_TILE_ONE_ORIGIN = 128
GROUP_ONE_ORIGIN = 1
BLOCK_RAYS_ONE_ORIGIN = 8
RAY_LANES_ONE_ORIGIN = 4
MAX_RAY_TILE = 256     # fixed in csrc/*.cu (`__launch_bounds__`)
TRI_CHUNK = 128        # fixed in csrc/closest_hit.cu
# Boxes one launch of the prepass kernel takes (csrc/candidates.cu: a key a
# box in shared memory); `group=None` groups larger meshes down to it.
MAX_CHUNKS = 16384
N_COEF = 19
ORDER_AXIS_BITS = 5    # a key's bits an axis, fixed in csrc/order.cu
# Elements of one [tiles, RT, NC] temporary of the plain prepass (and of the
# four [tiles, RT, C] products of the plain closest hit): the plain versions
# run over groups of tiles so a full view on a large mesh never
# materializes all at once.
_GROUP_ELEMS = 2 ** 25

# `group=None`'s least group for an incoherent query that is not one-origin.
# Measured on an H100 80GB HBM3 at 700 W (`scripts/tune_torch_oracle.py
# --what group`, reports/torch_group_ab.json, 2026-10-17): a step's
# incoherent queries' prepass and closest hit took 3.98-3.99 ms at group 4
# against 4.22-4.30 at group 1 on dog_mid45k, and 5.26-5.31 against
# 6.33-6.34 on dog_mid90k; group 16 was faster than 1 and slower than 4.
# Those queries included the silhouette views', which have since taken the
# one-origin route: a new measurement would time bounce 2 and the exit.
GROUP_INCOHERENT = 4


@kernels.checks("pack", "ray_order", "candidates", "closest_hit")
def _check_lib(lib):
    """The library's constants against this module's."""
    for name, want in (("closest_hit_tri_chunk", TRI_CHUNK),
                       ("closest_hit_max_ray_tile", MAX_RAY_TILE),
                       ("candidates_max_ray_tile", MAX_RAY_TILE),
                       ("candidates_max_chunks", MAX_CHUNKS),
                       ("pack_tri_chunk", TRI_CHUNK),
                       ("ray_order_axis_bits", ORDER_AXIS_BITS),
                       ("pack_n_coef", N_COEF)):
        if getattr(lib, name)() != want:
            raise RuntimeError(f"csrc: {name}() is {getattr(lib, name)()}, "
                               f"cuda_kernel.py expects {want}")


# --- stages feeding the kernel ---------------------------------------------

def _pad_axis0(x, m, value=0):
    p = (-x.shape[0]) % m
    if p:
        pad = x.new_full((p,) + tuple(x.shape[1:]), value)
        x = torch.cat([x, pad], dim=0)
    return x


def _triangle_coefficients(vertices, faces, face_valid, shift):
    """[F,10,4] Plücker MT coefficients (culled.py). Rows d(3), o x d(3),
    o(3), 1; columns det, u*det, v*det, t*det:
        det   =  d . (e2 x e1)
        u*det =  (o x d) . e2  -  d . (e2 x v0)
        v*det = -(o x d) . e1  +  d . (e1 x v0)
        t*det =  o . n - v0 . n          (n = e1 x e2)"""
    tri = vertices[faces].float() - shift[None, None, :]
    v0 = tri[:, 0]
    e1 = tri[:, 1] - v0
    e2 = tri[:, 2] - v0
    n = torch.linalg.cross(e1, e2, dim=-1)
    z3 = torch.zeros_like(v0)
    z1 = torch.zeros_like(v0[:, :1])
    col_det = torch.cat([torch.linalg.cross(e2, e1, dim=-1), z3, z3, z1], 1)
    col_u = torch.cat([-torch.linalg.cross(e2, v0, dim=-1), e2, z3, z1], 1)
    col_v = torch.cat([torch.linalg.cross(e1, v0, dim=-1), -e1, z3, z1], 1)
    col_t = torch.cat([z3, z3, n, -torch.sum(v0 * n, 1, keepdim=True)], 1)
    coef = torch.stack([col_det, col_u, col_v, col_t], dim=2)   # [F,10,4]
    # degenerate/padded triangles: zero coefficients -> det=0 -> never hit
    return torch.where(face_valid[:, None, None], coef,
                       torch.zeros_like(coef))


# (feature row, column) in `_triangle_coefficients` of the 19 nonzero
# Plücker coefficients, in the order the kernel and its plain version sum
# them: det (3 terms), u*det (6), v*det (6), t*det (4). The JAX package's
# dense [NC,10,4C] tensor holds coefficient k of triangle j of a chunk at
# [row, col * C + j].
COEF_ROWS = (0, 1, 2, 0, 1, 2, 3, 4, 5, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9)
COEF_COLS = (0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3)
_SUMS = ((0, 3), (3, 9), (9, 15), (15, 19))      # det, u*det, v*det, t*det


def _coef_packed(vertices, faces, face_valid, shift, tri_chunk):
    """[NC,19,C] coefficients: row k is coefficient k (COEF_ROWS/COEF_COLS)
    of the chunk's C triangles; a chunk is 19*C contiguous floats."""
    coef = _pad_axis0(_triangle_coefficients(vertices, faces, face_valid,
                                             shift), tri_chunk)
    NC = coef.shape[0] // tri_chunk
    c19 = coef[:, list(COEF_ROWS), list(COEF_COLS)]             # [Fp,19]
    return c19.reshape(NC, tri_chunk, N_COEF).permute(0, 2, 1).contiguous(), NC


def _chunk_aabbs(vertices, faces, face_valid, shift, tri_chunk):
    """Per-chunk AABBs [NC,3] x2 and chunk_valid [NC]: a chunk made only of
    padding faces must never be a candidate (its inverted +-big box would
    still pass a min/max slab test)."""
    tri = vertices[faces].float() - shift[None, None, :]
    big = 3e38
    fv = face_valid[:, None, None]
    lo = torch.where(fv, tri, torch.full_like(tri, big)).amin(dim=1)
    hi = torch.where(fv, tri, torch.full_like(tri, -big)).amax(dim=1)
    lo = _pad_axis0(lo, tri_chunk).reshape(-1, tri_chunk, 3)
    hi = _pad_axis0(hi, tri_chunk).reshape(-1, tri_chunk, 3)
    cv = _pad_axis0(face_valid, tri_chunk).reshape(-1, tri_chunk)
    return (lo.amin(dim=1).contiguous(), hi.amax(dim=1).contiguous(),
            cv.any(dim=1))


def _auto_group(nc: int, limit: int = MAX_CHUNKS) -> int:
    """The smallest power of two g with ceil(nc / g) <= limit: what
    `group=None` takes, so that a mesh of any size fits one launch of the
    prepass kernel."""
    g = 1
    while -(-nc // g) > limit:
        g *= 2
    return g


def _grouped_boxes(lo, hi, chunk_valid, group):
    """The chunk boxes for `group`: (lo, hi) [NCg,3] that the closest-hit
    kernel reads, NCg = NC rounded up to a multiple of group, and (lo, hi,
    valid) of the boxes the prepass scores: the chunks' own at group 1;
    above it, the min of `lo` and the max of `hi` over each group's valid
    chunks, valid where any of its chunks is (pallas_kernel.py:465-469; min
    and max are exact, so their order does not matter). Above 1, every
    chunk without a valid face (the mesh's padding, and the chunks that pad
    it to whole groups) gets the box +inf, which no slab test enters: JAX
    pads with +inf too, and an inverted +-3e38 box would pass the gate."""
    if group == 1:
        return lo, hi, (lo, hi, chunk_valid)
    inf = float("inf")
    valid = _pad_axis0(chunk_valid, group, False)
    invalid = ~valid[:, None]
    lo = _pad_axis0(lo, group).masked_fill(invalid, inf)
    hi_m = _pad_axis0(hi, group).masked_fill(invalid, -inf)
    ng = valid.shape[0] // group
    boxes = (lo.reshape(ng, group, 3).amin(dim=1),
             hi_m.reshape(ng, group, 3).amax(dim=1),
             valid.reshape(ng, group).any(dim=1))
    return lo, hi_m.masked_fill(invalid, inf), boxes


def _safe_inv(d):
    tiny = torch.where(d >= 0, torch.full_like(d, 1e-20),
                       torch.full_like(d, -1e-20))
    return 1.0 / torch.where(torch.abs(d) > 1e-20, d, tiny)


class Packed(NamedTuple):
    """What the packing stages give a query (NC = ceil(F / C) chunks, NCg
    NC rounded up to a multiple of the group, NG = NCg / group, Np the rays
    padded to whole tiles)."""
    coef: torch.Tensor       # [NCg,19,C] f32
    lo: torch.Tensor         # [NCg,3] f32 chunk boxes, closest hit's
    hi: torch.Tensor         # [NCg,3] f32
    box_lo: torch.Tensor     # [NG,3] f32 the boxes the prepass scores
    box_hi: torch.Tensor     # [NG,3] f32
    box_valid: torch.Tensor  # [NG] bool
    phi: torch.Tensor        # [9,Np] f32: d, o x d, o (shifted origins)
    inv: torch.Tensor        # [3,Np] f32: guarded 1/d


@torch.no_grad()
def pack_plain(vertices, faces, face_valid, shift, origins, dirs, *,
               group: int, ray_tile: int, order=None) -> Packed:
    """Plain version of csrc/pack.cu: the torch stages `_coef_packed`,
    `_chunk_aabbs` and `_grouped_boxes` over the mesh shifted by `shift`
    [3] f32, and the shifted rays padded to whole tiles of `ray_tile` (o = 0,
    d = 1), their cross product and `_safe_inv`. Every zero of the chunk
    boxes is made +0 (the kernel writes +0; torch's amin and amax keep
    whichever zero their order meets last). face_valid None: all valid.
    order ([>= N] int32, or None): lane i takes ray order[i]."""
    if order is not None:
        idx = order[:origins.shape[0]].long()
        origins, dirs = origins[idx], dirs[idx]
    if face_valid is None:
        face_valid = torch.ones(faces.shape[0], dtype=torch.bool,
                                device=faces.device)
    coef, _ = _coef_packed(vertices, faces, face_valid, shift, TRI_CHUNK)
    lo, hi, chunk_valid = _chunk_aabbs(vertices, faces, face_valid, shift,
                                       TRI_CHUNK)
    lo, hi, boxes = _grouped_boxes(lo + 0.0, hi + 0.0, chunk_valid, group)
    o = _pad_axis0(origins.float() - shift, ray_tile)
    d = _pad_axis0(dirs.float(), ray_tile, 1.0)
    inv = _safe_inv(d).t().contiguous()                      # [3,Np]
    w = torch.linalg.cross(o, d, dim=-1)
    phi = torch.cat([d, w, o], dim=1).t().contiguous()       # [9,Np]
    return Packed(_pad_axis0(coef, group), lo, hi, *boxes, phi, inv)


def _check_pack_inputs(vertices, faces, face_valid, shift, origins, dirs,
                       order=None):
    """Checks the packing kernel's inputs; origins may be one-origin (one
    contiguous row read by every ray)."""
    dev = origins.device
    kernels.expect("vertices", vertices, (None, 3), kernels.FLOATS, dev)
    kernels.expect("faces", faces, (None, 3), (torch.int64, torch.int32), dev)
    rows = origins[:1] if one_origin(origins) else origins
    kernels.expect("origins", rows, (None, 3), kernels.FLOATS, dev)
    kernels.expect("dirs", dirs, (origins.shape[0], 3), kernels.FLOATS, dev)
    kernels.expect("shift", shift, (3,), torch.float32, dev)
    kernels.expect("face_valid", face_valid, (faces.shape[0],), torch.bool,
                   dev)
    kernels.expect("order", order, (None,), torch.int32, dev)
    if order is not None and order.shape[0] < origins.shape[0]:
        raise ValueError(f"order: {order.shape[0]} entries for "
                         f"{origins.shape[0]} rays")


def _pack_sizes(n_faces, n_rays, group, ray_tile):
    """(NCg, NG, T) for F faces and N rays."""
    if group < 1 or ray_tile < 1:
        raise ValueError(f"group {group}, ray tile {ray_tile}: must be at "
                         "least 1")
    nc = -(-n_faces // TRI_CHUNK)
    ng = -(-nc // group)
    return ng * group, ng, -(-n_rays // ray_tile)


def pack_cuda(vertices, faces, face_valid, shift, origins, dirs, *,
              group: int, ray_tile: int, order=None) -> Packed:
    """Launch csrc/pack.cu on the current stream; inputs and result as in
    `pack_plain` (vertices, origins and dirs float32 or float64, faces
    int64 or int32, all contiguous on one CUDA device, but for one-origin
    origins, whose one row the kernel reads for every ray). At group 1 the
    prepass's boxes are the chunk boxes themselves."""
    _check_pack_inputs(vertices, faces, face_valid, shift, origins, dirs,
                       order)
    kernels.need_cuda("pack_cuda", origins)
    dev = origins.device
    F, N = faces.shape[0], origins.shape[0]
    ncg, ng, T = _pack_sizes(F, N, group, ray_tile)
    Np = T * ray_tile
    coef = torch.empty(ncg, N_COEF, TRI_CHUNK, device=dev)
    lo, hi = torch.empty(ncg, 3, device=dev), torch.empty(ncg, 3, device=dev)
    box_lo, box_hi = (lo, hi) if group == 1 else (
        torch.empty(ng, 3, device=dev), torch.empty(ng, 3, device=dev))
    box_valid = torch.empty(ng, dtype=torch.bool, device=dev)
    phi = torch.empty(9, Np, device=dev)
    inv = torch.empty(3, Np, device=dev)
    f64 = torch.float64
    kernels.launch(
        "pack", origins, ("pack_launches",), vertices=vertices,
        vert_f64=vertices.dtype == f64, faces=faces,
        faces_i64=faces.dtype == torch.int64, face_valid=face_valid,
        n_faces=F, shift=shift, origins=origins,
        org_f64=origins.dtype == f64,
        org_stride=0 if one_origin(origins) else 3, dirs=dirs,
        dir_f64=dirs.dtype == f64, order=order, n_rays=N, n_groups=ng,
        group=group, n_tiles=T, ray_tile=ray_tile, coef=coef, lo=lo, hi=hi,
        box_lo=box_lo, box_hi=box_hi, box_valid=box_valid, phi=phi, inv=inv)
    return Packed(coef, lo, hi, box_lo, box_hi, box_valid, phi, inv)


def pack(vertices, faces, face_valid, shift, origins, dirs, *, group: int,
         ray_tile: int, order=None) -> Packed:
    """The packing kernel on CUDA tensors, its plain version on CPU
    tensors."""
    return kernels.on_device(origins, pack_cuda, pack_plain)(
        vertices, faces, face_valid, shift, origins, dirs, group=group,
        ray_tile=ray_tile, order=order)


# --- the one-origin route's order of the rays ------------------------------

@torch.no_grad()
def ray_order_keys(dirs):
    """[N] int32 keys of csrc/order.cu: the Morton code of each direction
    quantised over the batch's own direction box, b = ORDER_AXIS_BITS bits
    an axis. Per axis the box is the min and max over the rays (NaN
    ignored), the scale the power of two 2^(b - e) for a span of frexp
    exponent e (inf from 2^128 up, 0 for a span that is not finite), so
    the cells form a power-of-two grid, and q = int(clamp((d - lo) *
    scale, 0, 2^b - 1)), a NaN giving 0. Of rays that leave one point, the
    directions are where they meet the screen: the keys order the screen
    along a Morton curve."""
    d = dirs.float()
    inf = float("inf")
    lo = torch.where(torch.isnan(d), inf, d).amin(dim=0)
    hi = torch.where(torch.isnan(d), -inf, d).amax(dim=0)
    span = hi - lo
    k = (ORDER_AXIS_BITS - torch.frexp(span).exponent).clamp(max=128)
    scale = torch.where(torch.isfinite(span),
                        ((k + 127) << 23).to(torch.int32).view(torch.float32),
                        0.0)
    q = (d - lo) * scale
    q = torch.where(torch.isnan(q), 0.0, q).clamp(
        0.0, float(2 ** ORDER_AXIS_BITS - 1)).to(torch.int32)
    return _spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1) | (
        _spread3(q[:, 2]) << 2)


@torch.no_grad()
def ray_order_plain(dirs, n_pad: int):
    """Plain version of csrc/order.cu: [n_pad] int32, the N rays' indices
    in the stable order of `ray_order_keys`, then N .. n_pad - 1 (the lanes
    that pad the rays to whole tiles keep their places)."""
    order = torch.argsort(ray_order_keys(dirs), stable=True)
    tail = torch.arange(dirs.shape[0], n_pad, device=dirs.device)
    return torch.cat([order, tail]).to(torch.int32)


def ray_order_cuda(dirs, n_pad: int):
    """Launch csrc/order.cu on the current stream: one cluster launch; the
    result as in `ray_order_plain`. dirs [N,3] float32 or float64,
    contiguous on a CUDA device."""
    N = dirs.shape[0]
    kernels.expect("dirs", dirs, (N, 3), kernels.FLOATS, dirs.device)
    kernels.need_cuda("ray_order_cuda", dirs)
    if n_pad < N:
        raise ValueError(f"{n_pad} lanes for {N} rays")
    lib = kernels.library("ray_order")
    order = torch.empty(n_pad, dtype=torch.int32, device=dirs.device)
    scratch = torch.empty(max(lib.ray_order_scratch_ints(N), 1),
                          dtype=torch.int32, device=dirs.device)
    kernels.launch("ray_order", dirs, what="ray_order", dirs=dirs,
                   dir_f64=dirs.dtype == torch.float64, n_rays=N, np=n_pad,
                   order=order, scratch=scratch)
    return order


def ray_order(dirs, n_pad: int):
    """The order kernel on CUDA tensors, its plain version on CPU
    tensors."""
    return kernels.on_device(dirs, ray_order_cuda, ray_order_plain)(dirs,
                                                                    n_pad)


def _sorted_candidates(score):
    """Nearest-first chunk order and candidate counts from [T,NC] scores
    (inf = not a candidate)."""
    order = torch.sort(score, dim=-1, stable=True).indices.to(torch.int32)
    count = torch.isfinite(score).sum(dim=-1).to(torch.int32)
    return order, count


def _score(overlap, t_entry):
    """max(t_entry, 0) where `overlap`, inf elsewhere; a zero is +0, so a
    sort that orders -0 before +0 cannot move a tie (the kernel writes +0
    too)."""
    return torch.where(overlap, torch.where(t_entry > 0.0, t_entry, 0.0),
                       float("inf"))


def _tile_scores(ot, it, lo_c, hi_c, chunk_valid, t_min=0.0):
    """[T,NC] scores of the tile-frustum prepass: the tile's rays become
    per-axis intervals of origin and inverse direction, and one interval
    slab test per (tile, chunk) bounds every ray's. ot/it: [T,3,RT] shifted
    origins and guarded inverse directions."""
    olo, ohi = ot.amin(dim=2), ot.amax(dim=2)               # [T,3]
    ilo, ihi = it.amin(dim=2)[:, None, :], it.amax(dim=2)[:, None, :]

    def bounds(planes):
        alo = planes[None] - ohi[:, None, :]                 # [T,NC,3]
        ahi = planes[None] - olo[:, None, :]
        p = torch.stack([alo * ilo, alo * ihi, ahi * ilo, ahi * ihi])
        return p.amin(dim=0), p.amax(dim=0)

    t1lo, t1hi = bounds(lo_c)
    t2lo, t2hi = bounds(hi_c)
    entry_lo = torch.minimum(t1lo, t2lo).amax(dim=-1)       # [T,NC]
    exit_hi = torch.maximum(t1hi, t2hi).amin(dim=-1)
    return _score((entry_lo <= exit_hi) & (exit_hi > t_min)
                  & chunk_valid[None], entry_lo)


def _candidates_tile(ot, dt, lo_c, hi_c, chunk_valid, t_min=0.0):
    """Tile-frustum prepass in plain torch (`_tile_scores`, then the stable
    sort). The candidate list is a conservative superset of the per-ray
    prepass (a tile straddling an axis sign keeps every chunk). ot/dt:
    [T,3,RT]. Returns (cand [T,NC] i32, count [T] i32)."""
    return _sorted_candidates(
        _tile_scores(ot, _safe_inv(dt), lo_c, hi_c, chunk_valid, t_min))


def _check_tiling(Np, T):
    if T <= 0 or Np % T:
        raise ValueError(f"{Np} rays do not split into {T} tiles")
    ray_tile = Np // T
    if not 32 <= ray_tile <= MAX_RAY_TILE or ray_tile % 32:
        raise ValueError(f"ray tile {ray_tile}: must be a multiple of 32 "
                         f"in [32, {MAX_RAY_TILE}]")
    return ray_tile


def _check_prepass_inputs(org, inv, lo, hi, chunk_valid, n_tiles):
    dev = org.device
    Np = org.shape[-1]
    NC = lo.shape[0]
    for name, x, shape, dtype in (
            ("org", org, (3, Np), torch.float32),
            ("inv", inv, (3, Np), torch.float32),
            ("lo", lo, (NC, 3), torch.float32),
            ("hi", hi, (NC, 3), torch.float32),
            ("chunk_valid", chunk_valid, (NC,), torch.bool)):
        kernels.expect(name, x, shape, dtype, dev)
    return Np, NC, _check_tiling(Np, n_tiles)


@torch.no_grad()
def candidate_scores_plain(org, inv, lo, hi, chunk_valid, n_tiles,
                           t_min=0.0):
    """Scores of the per-ray prepass (csrc/candidates.cu's ray mode): for
    every (tile, chunk) the nearest slab entry max(t_entry, 0) over the
    tile's rays that overlap the chunk's AABB (t_entry <= t_exit, t_exit >
    t_min), inf where none does or the
    chunk is padding. Groups of tiles bound the [tiles, RT, NC]
    temporaries (the JAX package maps over groups the same way). org/inv:
    [3,Np] shifted origins and guarded inverse directions, Np = n_tiles *
    RT. Returns score [n_tiles,NC] f32."""
    _, NC, RT = _check_prepass_inputs(org, inv, lo, hi, chunk_valid, n_tiles)
    o3, i3 = org.reshape(3, n_tiles, RT), inv.reshape(3, n_tiles, RT)
    g = max(1, _GROUP_ELEMS // (RT * NC))
    scores = []
    for s in range(0, n_tiles, g):
        t_entry = t_exit = None
        for ax in range(3):
            oa, ia = o3[ax, s:s + g, :, None], i3[ax, s:s + g, :, None]
            t1 = (lo[:, ax] - oa) * ia                       # [G,RT,NC]
            t2 = (hi[:, ax] - oa) * ia
            e, x = torch.minimum(t1, t2), torch.maximum(t1, t2)
            t_entry = e if t_entry is None else torch.maximum(t_entry, e)
            t_exit = x if t_exit is None else torch.minimum(t_exit, x)
        overlap = (t_entry <= t_exit) & (t_exit > t_min) & chunk_valid
        scores.append(_score(overlap, t_entry).amin(dim=1))  # [G,NC]
    return torch.cat(scores)


@torch.no_grad()
def candidates_plain(org, inv, lo, hi, chunk_valid, n_tiles, *, tile: bool,
                     t_min: float = 0.0):
    """Plain version of csrc/candidates.cu: the per-ray prepass
    (`candidate_scores_plain`) or, with tile=True, the tile-frustum prepass
    (`_tile_scores`), then the stable sort and the counts. Inputs as in
    `candidate_scores_plain`. Returns (cand [n_tiles,NC] i32, count
    [n_tiles] i32)."""
    _, _, RT = _check_prepass_inputs(org, inv, lo, hi, chunk_valid, n_tiles)
    if tile:
        score = _tile_scores(org.reshape(3, n_tiles, RT).permute(1, 0, 2),
                             inv.reshape(3, n_tiles, RT).permute(1, 0, 2),
                             lo, hi, chunk_valid, t_min)
    else:
        score = candidate_scores_plain(org, inv, lo, hi, chunk_valid,
                                       n_tiles, t_min)
    return _sorted_candidates(score)


def tile_straddles(inv, n_tiles):
    """[n_tiles] bool: the tiles whose inverse directions inv [3,Np] take
    both signs on all three axes, where csrc/candidates.cu's ray mode keeps
    every valid box without testing it."""
    it = inv.reshape(3, n_tiles, -1)
    return ((it.amin(dim=2) < 0) & (it.amax(dim=2) > 0)).all(dim=0)


@torch.no_grad()
def frustum_kept_plain(org, inv, lo, hi, chunk_valid, n_tiles,
                       t_min: float = 0.0):
    """[n_tiles, NC] bool: the boxes that csrc/candidates.cu's ray mode
    scores ray by ray, its cull by each tile's frustum: the valid boxes with
    a finite `_tile_scores` score, or every valid box of a tile that
    `tile_straddles` (the kernel skips the test there). A box some ray of
    the tile enters is always among them (rounding is monotone:
    tests/test_torch_prepass_cull.py), so the cull leaves the lists as they
    are. The kernel's `kept` is the row sums.
    Inputs as in `candidate_scores_plain`."""
    _, _, RT = _check_prepass_inputs(org, inv, lo, hi, chunk_valid, n_tiles)
    enters = torch.isfinite(_tile_scores(
        org.reshape(3, n_tiles, RT).permute(1, 0, 2),
        inv.reshape(3, n_tiles, RT).permute(1, 0, 2), lo, hi, chunk_valid,
        t_min))
    return enters | (tile_straddles(inv, n_tiles)[:, None]
                     & chunk_valid[None])


def candidates_cuda(org, inv, lo, hi, chunk_valid, n_tiles, *, tile: bool,
                    t_min: float = 0.0, kept=None):
    """Launch csrc/candidates.cu on the current stream; inputs and result
    as in `candidates_plain`. Takes at most MAX_CHUNKS boxes (chunks, or
    groups of them). kept ([n_tiles] int32, or None): where given, the
    kernel writes each tile's boxes it scored there, in ray mode the row
    sums of `frustum_kept_plain`, in tile mode the valid boxes."""
    _, NC, ray_tile = _check_prepass_inputs(org, inv, lo, hi, chunk_valid,
                                            n_tiles)
    if NC > MAX_CHUNKS:
        raise ValueError(f"{NC} boxes: the prepass kernel takes at most "
                         f"MAX_CHUNKS = {MAX_CHUNKS} (group the chunks)")
    kernels.expect("kept", kept, (n_tiles,), torch.int32, org.device)
    kernels.need_cuda("candidates_cuda", org)
    cand = torch.empty(n_tiles, NC, dtype=torch.int32, device=org.device)
    count = torch.empty(n_tiles, dtype=torch.int32, device=org.device)
    counts = ("candidates_launches",) if tile else (
        "candidates_launches", "prepass_cull_launches")
    kernels.launch("candidates", org, counts, org=org, inv=inv, lo=lo,
                   hi=hi, valid=chunk_valid, n_tiles=n_tiles,
                   ray_tile=ray_tile, nc=NC, tile_mode=bool(tile),
                   t_min=float(t_min), cand=cand, count=count, kept=kept)
    return cand, count


def candidates(org, inv, lo, hi, chunk_valid, n_tiles, *, tile: bool,
               t_min: float = 0.0):
    """The prepass kernel on CUDA tensors, its plain version on CPU
    tensors."""
    return kernels.on_device(org, candidates_cuda, candidates_plain)(
        org, inv, lo, hi, chunk_valid, n_tiles, tile=tile, t_min=t_min)


def _candidates(ot, dt, lo_c, hi_c, chunk_valid, t_min=0.0):
    """Exact per-ray prepass in plain torch: a chunk is a tile's candidate
    if some ray of the tile overlaps its AABB; ordered by the nearest entry
    over those rays. ot/dt: [T,3,RT]. Returns (cand [T,NC] i32,
    count [T] i32)."""
    T = ot.shape[0]
    org = ot.permute(1, 0, 2).reshape(3, -1).contiguous()
    inv = _safe_inv(dt).permute(1, 0, 2).reshape(3, -1).contiguous()
    return _sorted_candidates(
        candidate_scores_plain(org, inv, lo_c, hi_c, chunk_valid, T, t_min))


class KernelInputs(NamedTuple):
    """Everything the closest-hit kernel (and its plain version) reads.
    Np = T * RT; NC a multiple of `group`, NG = NC / group."""
    phi: torch.Tensor     # [9,Np] f32: d, o x d, o (shifted origins)
    inv: torch.Tensor     # [3,Np] f32: guarded 1/d
    coef: torch.Tensor    # [NC,19,C] f32
    lo: torch.Tensor      # [NC,3] f32
    hi: torch.Tensor      # [NC,3] f32
    cand: torch.Tensor    # [T,NG] i32 group ids, nearest first
    count: torch.Tensor   # [T] i32 groups listed
    group: int = 1        # chunks a listed group stands for
    t_min: float = 0.0
    order: torch.Tensor | None = None  # [Np] i32: lane -> ray (one-origin)


def chunk_lists(inp: KernelInputs):
    """The chunks a tile visits, in order: listed group k stands for chunks
    k * group .. k * group + group - 1. Returns (cand [T,NC] i32, count [T]
    i32), the lists themselves at group 1."""
    if inp.group == 1:
        return inp.cand, inp.count
    step = torch.arange(inp.group, dtype=torch.int32, device=inp.cand.device)
    cand = (inp.cand[:, :, None] * inp.group + step).reshape(
        inp.cand.shape[0], -1)
    return cand, inp.count * inp.group


@torch.no_grad()
def prepare_inputs(origins, dirs, vertices, faces, face_valid=None, *,
                   coherent: bool, shift=None, t_min: float = 0.0,
                   group: int | None = None) -> KernelInputs:
    """Stages 1-3: on CUDA tensors a torch mean (where no `shift` is
    given), one launch of the packing kernel and one of the prepass kernel.
    Coherent queries take the tile prepass; incoherent ones the exact
    per-ray prepass, since their tile frustums straddle direction signs and
    blow up to near-full lists. Makes no host synchronisation. `shift` [3]
    f32 replaces the mean ray origin: the resorted route passes the
    unsorted query's, since a mean summed in another order differs in its
    last bits and t would follow.

    An incoherent query of one origin (`api.one_origin`) takes the
    one-origin route (the module's docstring): `ray_order` sorts its rays,
    the packing stage reads its one origin row and its directions through
    the order, and `order` in the result sends the hits back. Its shift is
    the mean of the unsorted origins, as on the other routes; its ray tile
    is RAY_TILE_ONE_ORIGIN and its group at least GROUP_ONE_ORIGIN.

    group: chunks a candidate group, the prepass's boxes. None takes the
    least power of two that brings the mesh to MAX_CHUNKS groups (1 below
    that), and for an incoherent query that is not one-origin at least
    GROUP_INCOHERENT. The chunk axis is padded
    to a multiple of it with zero coefficients and the boxes of
    `_grouped_boxes`."""
    F, N = faces.shape[0], origins.shape[0]
    routed = not coherent and one_origin(origins)
    if shift is None:
        shift = origins.float().mean(dim=0)
    if group is None:
        g = _auto_group(-(-F // TRI_CHUNK), MAX_CHUNKS)
        if routed:
            g = max(g, GROUP_ONE_ORIGIN)
        elif not coherent:
            g = max(g, GROUP_INCOHERENT)
    else:
        g = int(group)
    if g < 1:
        raise ValueError(f"group {group}: must be at least 1")
    if coherent:
        ray_tile = RAY_TILE_COHERENT
    else:
        ray_tile = RAY_TILE_ONE_ORIGIN if routed else RAY_TILE_INCOHERENT
    if face_valid is not None:
        face_valid = face_valid.contiguous()
    dirs = dirs.contiguous()
    order = None
    if routed:
        # one contiguous row that every ray reads, and the sorted lanes
        origins = origins[:1].contiguous().expand(N, 3)
        order = ray_order(dirs, -(-N // ray_tile) * ray_tile)
    else:
        origins = origins.contiguous()
    pk = pack(vertices.contiguous(), faces.contiguous(), face_valid, shift,
              origins, dirs, group=g, ray_tile=ray_tile, order=order)
    T = pk.phi.shape[1] // ray_tile
    cand, count = candidates(pk.phi[6:9], pk.inv, pk.box_lo, pk.box_hi,
                             pk.box_valid, T, tile=coherent, t_min=t_min)
    return KernelInputs(pk.phi, pk.inv, pk.coef, pk.lo, pk.hi, cand, count,
                        g, float(t_min), order)


# --- the closest-hit kernel and its plain version ---------------------------

def _check_inputs(inp: KernelInputs):
    dev = inp.phi.device
    Np = inp.phi.shape[1]
    NC = inp.coef.shape[0]
    T = inp.count.shape[0]
    if inp.group < 1 or NC % inp.group:
        raise ValueError(f"group {inp.group}: must be at least 1 and divide "
                         f"the {NC} chunks")
    expect = {
        "phi": ((9, Np), torch.float32), "inv": ((3, Np), torch.float32),
        "coef": ((NC, N_COEF, TRI_CHUNK), torch.float32),
        "lo": ((NC, 3), torch.float32), "hi": ((NC, 3), torch.float32),
        "cand": ((T, NC // inp.group), torch.int32),
        "count": ((T,), torch.int32), "order": ((Np,), torch.int32),
    }
    for name, (shape, dtype) in expect.items():
        kernels.expect(name, getattr(inp, name), shape, dtype, dev)
    return Np, NC, T, _check_tiling(Np, T)


def closest_hit_cuda(inp: KernelInputs):
    """Launch csrc/closest_hit.cu on the current stream. Returns
    (t [Np] f32, tri_id [Np] i32), lane i's hit at inp.order[i] where there
    is an order. A block takes BLOCK_RAYS rays (at most the tile), 32 a
    warp; on the one-origin route (an order) BLOCK_RAYS_ONE_ORIGIN,
    RAY_LANES_ONE_ORIGIN a warp."""
    Np, NC, T, ray_tile = _check_inputs(inp)
    kernels.need_cuda("closest_hit_cuda", inp.phi)
    if inp.order is None:
        block, lanes = math.gcd(ray_tile, BLOCK_RAYS), 32
    else:
        block = math.gcd(ray_tile, BLOCK_RAYS_ONE_ORIGIN)
        lanes = math.gcd(block, RAY_LANES_ONE_ORIGIN)
    t_out = torch.empty(Np, dtype=torch.float32, device=inp.phi.device)
    id_out = torch.empty(Np, dtype=torch.int32, device=inp.phi.device)
    kernels.launch(
        "closest_hit", inp.phi, ("launches",), what="closest_hit",
        phi=inp.phi, inv=inp.inv, coef=inp.coef, lo=inp.lo, hi=inp.hi,
        cand=inp.cand, count=inp.count, order=inp.order, n_tiles=T,
        ray_tile=ray_tile, block_rays=block, ray_lanes=lanes,
        n_groups=NC // inp.group, group=inp.group, t_min=inp.t_min,
        t_out=t_out, id_out=id_out)
    return t_out, id_out


def _products(feat, coef):
    """det, u*det, v*det, t*det [G,RT,C] of ray features feat [G,RT,10]
    against chunk coefficients coef [G,19,C]: each product and each sum
    rounded on its own, left to right, as the kernel does, so the two agree
    bit for bit."""
    out = []
    for k0, k1 in _SUMS:
        acc = None
        for k in range(k0, k1):
            p = feat[:, :, COEF_ROWS[k], None] * coef[:, None, k, :]
            acc = p if acc is None else acc + p
        out.append(acc)
    return out


@torch.no_grad()
def closest_hit_plain(inp: KernelInputs):
    """The kernel's algorithm in plain torch: the same visit order
    (`chunk_lists`), the same per-ray slab gate (a chunk updates a ray only
    if the ray's own slab test enters its AABB, leaving it beyond t_min,
    before the ray's running best), the same f32 Plücker products rounded
    in the same order, hit test (t*det beyond t_min*|det|, that product
    rounded on its own) and tie rule (lowest row on equal t within a
    chunk, strict `<` across chunks), and lane i's hit written to
    inp.order[i] where there is an order. Runs on any device; the wrapper
    takes it for CPU tensors."""
    Np, NC, T, RT = _check_inputs(inp)
    C = TRI_CHUNK
    t_min = inp.t_min
    lists, counts = chunk_lists(inp)
    dev = inp.phi.device
    ones = torch.ones(1, Np, device=dev)
    feat = torch.cat([inp.phi, ones]).reshape(10, T, RT).permute(1, 2, 0)
    o3 = inp.phi[6:9].reshape(3, T, RT).permute(1, 0, 2)       # [T,3,RT]
    inv3 = inp.inv.reshape(3, T, RT).permute(1, 0, 2)
    best_t = torch.full((T, RT), float("inf"), device=dev)
    best_id = torch.full((T, RT), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(C, device=dev, dtype=torch.int32)
    g = max(1, _GROUP_ELEMS // (RT * 4 * C))
    for s in range(0, T, g):
        cnt = counts[s:s + g]
        n_iter = int(cnt.max()) if cnt.numel() else 0
        bt, bi = best_t[s:s + g], best_id[s:s + g]
        for i in range(n_iter):
            active = cnt > i                                   # [G]
            c = lists[s:s + g, i].long().clamp(0, NC - 1)
            t1 = (inp.lo[c][:, :, None] - o3[s:s + g]) * inv3[s:s + g]
            t2 = (inp.hi[c][:, :, None] - o3[s:s + g]) * inv3[s:s + g]
            t_entry = torch.minimum(t1, t2).amax(dim=1)        # [G,RT]
            t_exit = torch.maximum(t1, t2).amin(dim=1)
            enters = ((t_entry <= t_exit) & (t_exit > t_min)
                      & (t_entry < bt) & active[:, None])      # [G,RT]
            det, ud, vd, td = _products(feat[s:s + g], inp.coef[c])
            sgn = torch.sign(det)
            absdet = torch.abs(det)
            eps = _UV_EPS * absdet
            ok = ((absdet > 1e-16) & (ud * sgn >= -eps) & (vd * sgn >= -eps)
                  & ((ud + vd) * sgn <= absdet + eps)
                  & (td * sgn > t_min * absdet))
            t_all = torch.where(
                ok, td / torch.where(absdet > 1e-16, det,
                                     torch.ones_like(det)),
                torch.full_like(det, float("inf")))
            cmin = t_all.amin(dim=-1)
            amin = torch.where(t_all <= cmin[..., None], rows, C).amin(-1)
            better = enters & (cmin < bt)
            bi.copy_(torch.where(better, c[:, None].int() * C + amin, bi))
            bt.copy_(torch.where(better, cmin, bt))
    if inp.order is None:
        return best_t.reshape(-1), best_id.reshape(-1)
    slot = inp.order.long()
    t_out, id_out = torch.empty_like(best_t).reshape(-1), torch.empty_like(
        best_id).reshape(-1)
    t_out[slot] = best_t.reshape(-1)
    id_out[slot] = best_id.reshape(-1)
    return t_out, id_out


def closest_hit(inp: KernelInputs):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    return kernels.on_device(inp.phi, closest_hit_cuda,
                             closest_hit_plain)(inp)


def intersect_cuda(origins, dirs, vertices, faces, face_valid=None, *,
                   coherent: bool, shift=None, t_min: float = 0.0,
                   group: int | None = None) -> Hits:
    """Closest hit beyond t_min for each ray, on a mesh of any size
    (`prepare_inputs` says how `group` is taken, and which queries take the
    one-origin route). Misses: t=inf, tri_id=-1."""
    counters.calls += 1
    N = origins.shape[0]
    inp = prepare_inputs(origins, dirs, vertices, faces, face_valid,
                         coherent=coherent, shift=shift, t_min=t_min,
                         group=group)
    if inp.order is not None:
        counters.one_origin_queries += 1
    t, ids = closest_hit(inp)
    return Hits(t[:N], ids[:N])

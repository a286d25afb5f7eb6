"""Chunk-culled closest-hit oracle in plain torch (port of
drt_tpu/intersect/culled.py): the algorithm of the CUDA kernel with tile-wide
gating, as a backend of its own.

1.  Faces are Morton-ordered at topology build time (mesh/topology.py), so
    fixed chunks of `tri_chunk` consecutive triangles are spatially tight.
    Chunk AABBs are recomputed from the current vertices on every query.
2.  Rays are processed in tiles of `ray_tile`. Each tile slab-tests every
    chunk AABB and orders the chunks by the nearest entry distance over
    its rays.
3.  Möller–Trumbore for a wave of `max_chunks` chunks is one float32 matrix
    product of the per-ray Plücker feature phi = [d, o x d, o, 1] with the
    chunks' [10, 4] coefficients (`_triangle_coefficients`). Sign-aware
    comparisons classify hits without a division; the one division happens
    for the winning t.

Exactness: candidate chunks are processed in nearest-first waves of
`max_chunks` until no unprocessed chunk could still beat any ray's current
best hit. Coherent tiles exit after one wave; incoherent tiles degrade
toward brute force but remain exact. Misses return t=inf, tri_id=-1.

The JAX package maps a vmapped while_loop over groups of tiles; here a group
of `tile_group` tiles is one batched loop with a mask of the tiles still
improvable, which reads one flag back to the host per wave. The products
must be full float32: TF32 would round the coefficients to ~10 mantissa
bits and classify small triangles as misses, so it is switched off around
them whatever the global setting.
"""

from __future__ import annotations

import contextlib

import torch

from drt_tpu_torch.intersect.api import Hits
from drt_tpu_torch.intersect.cuda_kernel import (
    _chunk_aabbs, _pad_axis0, _safe_inv, _triangle_coefficients,
)

_UV_EPS = 1e-5


@contextlib.contextmanager
def _full_float32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _first_argmin(x):
    """(min, index of its first occurrence) along the last axis."""
    xmin = x.amin(dim=-1)
    idx = torch.arange(x.shape[-1], device=x.device)
    return xmin, torch.where(x <= xmin[..., None], idx,
                             x.shape[-1]).amin(dim=-1)


def _group_hits(ot, dt, coef_c, lo_c, hi_c, chunk_valid, t_min, K):
    """Closest hits of a group of tiles. ot/dt: [G,R,3] shifted origins and
    directions. Returns (t [G,R] f32, tri_id [G,R] i32)."""
    G, R, _ = ot.shape
    NC, C = coef_c.shape[:2]
    dev = ot.device
    inv = _safe_inv(dt)
    t_entry = t_exit = None
    for ax in range(3):
        oa, ia = ot[:, :, ax, None], inv[:, :, ax, None]
        t1 = (lo_c[:, ax] - oa) * ia                         # [G,R,NC]
        t2 = (hi_c[:, ax] - oa) * ia
        e, x = torch.minimum(t1, t2), torch.maximum(t1, t2)
        t_entry = e if t_entry is None else torch.maximum(t_entry, e)
        t_exit = x if t_exit is None else torch.minimum(t_exit, x)
    overlap = (t_entry <= t_exit) & (t_exit > t_min) & chunk_valid
    # Tile-level candidate score: nearest entry over rays that overlap.
    inf = torch.full_like(t_entry, float("inf"))
    score = torch.where(overlap, t_entry.clamp_min(0.0), inf).amin(dim=1)
    order = torch.argsort(score, dim=-1, stable=True)        # [G,NC]
    rank = torch.argsort(order, dim=-1, stable=True)         # chunk -> pos
    reachable = overlap & torch.isfinite(score)[:, None, :]

    phi = torch.cat([dt, torch.linalg.cross(ot, dt, dim=-1), ot,
                     torch.ones(G, R, 1, device=dev)], dim=2)  # [G,R,10]
    best = torch.full((G, R), float("inf"), device=dev)
    best_id = torch.full((G, R), -1, dtype=torch.int32, device=dev)
    n_waves = -(-NC // K)
    for wave in range(n_waves):
        # Can any unprocessed chunk still beat any ray's best? [G]
        unproc = rank[:, None, :] >= wave * K
        go = (reachable & unproc
              & (t_entry < best[:, :, None])).any(dim=2).any(dim=1)
        if not bool(go.any()):
            break
        start = min(wave * K, NC - K)        # a slice that always fits
        idx = order[:, start:start + K]                      # [G,K]
        cand_ok = torch.isfinite(torch.gather(score, 1, idx))
        M = coef_c[idx].reshape(G, K * C, 10, 4)
        with _full_float32_matmul():
            vals = torch.einsum("grp,gtpc->grtc", phi, M)    # [G,R,KC,4]
        det, ud, vd, td = vals.unbind(dim=-1)                # [G,R,KC]
        s = torch.sign(det)
        absdet = torch.abs(det)
        eps = _UV_EPS * absdet
        ok = ((absdet > 1e-16)
              & (ud * s >= -eps) & (vd * s >= -eps)
              & ((ud + vd) * s <= absdet + eps)
              & (td * s > t_min * absdet))
        ok = ok & cand_ok.repeat_interleave(C, dim=1)[:, None, :]
        t_all = torch.where(
            ok, td / torch.where(absdet > 1e-16, det, torch.ones_like(det)),
            torch.full_like(det, float("inf")))
        wave_best, arg = _first_argmin(t_all)                # [G,R]
        tri = (torch.gather(idx, 1, arg // C) * C + arg % C).to(torch.int32)
        better = (wave_best < best) & go[:, None]
        best = torch.where(better, wave_best, best)
        best_id = torch.where(better, tri, best_id)
    return best, best_id


@torch.no_grad()
def intersect_culled(origins, dirs, vertices, faces, face_valid=None, *,
                     t_min: float = 0.0, ray_tile: int = 256,
                     tri_chunk: int = 256, max_chunks: int = 8,
                     tile_group: int = 32, coherent: bool = True) -> Hits:
    """Closest hit for each ray. Misses: t=inf, tri_id=-1. `coherent` is
    accepted for the common oracle signature and ignored."""
    del coherent
    N = origins.shape[0]
    F = faces.shape[0]
    if face_valid is None:
        face_valid = torch.ones(F, dtype=torch.bool, device=faces.device)

    # Shift the scene so coordinates are small (better f32 products in the
    # Plücker features, which multiply positions together).
    shift = origins.float().mean(dim=0)
    o = origins.float() - shift
    d = dirs.float()

    coef = _pad_axis0(_triangle_coefficients(vertices, faces, face_valid,
                                             shift), tri_chunk)
    NC = coef.shape[0] // tri_chunk
    coef_c = coef.reshape(NC, tri_chunk, 10, 4)
    lo_c, hi_c, chunk_valid = _chunk_aabbs(vertices, faces, face_valid,
                                           shift, tri_chunk)
    K = min(max_chunks, NC)

    o = _pad_axis0(o, ray_tile)
    d = _pad_axis0(d, ray_tile)
    n_tiles = o.shape[0] // ray_tile
    ot = o.reshape(n_tiles, ray_tile, 3)
    dt = d.reshape(n_tiles, ray_tile, 3)
    group = max(1, min(tile_group, n_tiles))
    ts, ids = [], []
    for g0 in range(0, n_tiles, group):
        t, i = _group_hits(ot[g0:g0 + group], dt[g0:g0 + group], coef_c,
                           lo_c, hi_c, chunk_valid, t_min, K)
        ts.append(t)
        ids.append(i)
    return Hits(torch.cat(ts).reshape(-1)[:N], torch.cat(ids).reshape(-1)[:N])

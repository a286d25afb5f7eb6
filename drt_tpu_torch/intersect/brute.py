"""Brute-force closest-hit oracle: blocked all-pairs Möller–Trumbore (port
of drt_tpu/intersect/brute.py). Exact by construction and independent of
the chunked kernel, so it is the ground truth the kernel is checked
against. Runs in float32 whatever the autograd dtype, like OptiX Prime."""

from __future__ import annotations

import torch

from drt_tpu_torch.intersect.api import Hits

_UV_EPS = 1e-5       # barycentric tolerance: don't miss hits on shared edges
_DET_EPS = 1e-12     # parallel-ray determinant cutoff


def _mt_block(o, d, v0, e1, e2, tri_valid, t_min):
    """MT of a ray block [R,3] against a triangle tile [T,3]; t [R,T], inf
    on miss or invalid triangle."""
    d_ = d[:, None, :]
    pvec = torch.linalg.cross(d_.expand(-1, e2.shape[0], -1),
                              e2[None].expand(d.shape[0], -1, -1), dim=-1)
    det = torch.sum(e1[None] * pvec, dim=-1)
    inv_det = 1.0 / torch.where(torch.abs(det) > _DET_EPS, det,
                                torch.full_like(det, float("inf")))
    tvec = o[:, None, :] - v0[None]
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1[None].expand_as(tvec), dim=-1)
    v = torch.sum(d_ * qvec, dim=-1) * inv_det
    t = torch.sum(e2[None] * qvec, dim=-1) * inv_det
    ok = (tri_valid[None] & (u >= -_UV_EPS) & (v >= -_UV_EPS)
          & (u + v <= 1.0 + _UV_EPS) & (t > t_min))
    return torch.where(ok, t, torch.full_like(t, float("inf")))


@torch.no_grad()
def intersect_brute(origins, dirs, vertices, faces, face_valid=None, *,
                    t_min: float = 0.0, ray_chunk: int = 8192,
                    tri_chunk: int = 512, coherent: bool = True) -> Hits:
    """Closest hit beyond t_min for each ray. Misses: t=inf, tri_id=-1.
    Blocks of ray_chunk rays x tri_chunk triangles bound the temporaries;
    the hits do not depend on them (the lowest index wins a tie, as JAX's
    argmin gives it). `coherent` is accepted for the common oracle
    signature and ignored."""
    del coherent
    o = origins.float()
    d = dirs.float()
    tri = vertices[faces].float()                    # [F,3,3]
    v0 = tri[:, 0]
    e1 = tri[:, 1] - v0
    e2 = tri[:, 2] - v0
    F = tri.shape[0]
    valid = (torch.ones(F, dtype=torch.bool, device=o.device)
             if face_valid is None else face_valid)

    N = o.shape[0]
    best_t = torch.full((N,), float("inf"), device=o.device)
    best_id = torch.full((N,), -1, dtype=torch.int32, device=o.device)
    for r0 in range(0, N, ray_chunk):
        oc, dc = o[r0:r0 + ray_chunk], d[r0:r0 + ray_chunk]
        bt, bi = best_t[r0:r0 + ray_chunk], best_id[r0:r0 + ray_chunk]
        for f0 in range(0, F, tri_chunk):
            f1 = min(F, f0 + tri_chunk)
            t = _mt_block(oc, dc, v0[f0:f1], e1[f0:f1], e2[f0:f1],
                          valid[f0:f1], t_min)
            tile_min = t.amin(dim=1)
            cols = torch.arange(f1 - f0, device=o.device)
            tile_arg = torch.where(t <= tile_min[:, None], cols,
                                   f1 - f0).amin(dim=1)     # lowest column
            better = tile_min < bt
            bt.copy_(torch.where(better, tile_min, bt))
            bi.copy_(torch.where(better, (tile_arg + f0).to(torch.int32), bi))
    return Hits(best_t, best_id)

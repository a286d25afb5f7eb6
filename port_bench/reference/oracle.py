"""Closest ray-triangle hit in plain PyTorch, the yardstick's own oracle.

Every (ray, triangle) pair is decided by the all-pairs Moller-Trumbore test
of a brute-force oracle: the hit lies beyond t_min, its barycentrics within
UV_EPS of the triangle, |det| above DET_EPS, and the closest hit wins, the
lowest face index on a tie. Only pairs that cannot hit are skipped: the
faces are taken in chunks of CHUNK, and a ray is tested against a chunk's
faces only where it enters the chunk's bounding box, grown by a margin
that covers rounding and UV_EPS. So the answer is the brute force's, at a
fraction of its tests.
"""

from __future__ import annotations

import torch

UV_EPS = 1e-5
DET_EPS = 1e-12
CHUNK = 64
RAY_BLOCK = 32768       # rays a slab-test block ([rays, chunks] booleans)
PAIR_BLOCK = 32768      # (ray, chunk) pairs a Moller-Trumbore block


class Scene:
    """The faces of a mesh, packed into chunks for `closest_hit`.

    vertices [V,3] float32, faces [F,3] int64 (in the order whose indices
    the hits report)."""

    def __init__(self, vertices: torch.Tensor, faces: torch.Tensor):
        tri = vertices.detach().float()[faces]                  # [F,3,3]
        f = tri.shape[0]
        c = -(-f // CHUNK)
        pad = c * CHUNK - f
        v0 = tri[:, 0]
        e1 = tri[:, 1] - v0
        e2 = tri[:, 2] - v0
        dev = tri.device

        def chunked(x, fill):
            x = torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])
            return x.reshape((c, CHUNK) + x.shape[1:])
        self.v0, self.e1, self.e2 = (chunked(v0, 0.0), chunked(e1, 0.0),
                                     chunked(e2, 0.0))
        self.valid = chunked(torch.ones(f, dtype=torch.bool, device=dev),
                             False)
        lo = chunked(tri.amin(dim=1), float("inf")).amin(dim=1)   # [C,3]
        hi = chunked(tri.amax(dim=1), float("-inf")).amax(dim=1)
        span = float((tri.amax(dim=(0, 1)) - tri.amin(dim=(0, 1))).max())
        scale = float(tri.abs().max())
        margin = 1e-4 * span + 1e-5 * scale
        self.lo, self.hi = lo - margin, hi + margin
        self.num_chunks = c
        self.num_faces = f


def _pairs(o, d, scene: Scene, t_min: float):
    """(ray, chunk) pairs whose chunk box the ray enters beyond t_min,
    ordered by ray and then by chunk."""
    tiny = torch.full_like(d, 1e-30)
    dd = torch.where(d.abs() < 1e-30, torch.copysign(tiny, d), d)
    inv = 1.0 / dd
    rays, chunks = [], []
    for r0 in range(0, o.shape[0], RAY_BLOCK):
        ob, ib = o[r0:r0 + RAY_BLOCK], inv[r0:r0 + RAY_BLOCK]
        near = torch.full((ob.shape[0], scene.num_chunks), float(t_min),
                          device=o.device)
        far = torch.full_like(near, float("inf"))
        for a in range(3):
            t1 = (scene.lo[None, :, a] - ob[:, a:a + 1]) * ib[:, a:a + 1]
            t2 = (scene.hi[None, :, a] - ob[:, a:a + 1]) * ib[:, a:a + 1]
            near = torch.maximum(near, torch.minimum(t1, t2))
            far = torch.minimum(far, torch.maximum(t1, t2))
        r, c = torch.nonzero(far >= near, as_tuple=True)
        rays.append(r + r0)
        chunks.append(c)
    return torch.cat(rays), torch.cat(chunks)


def closest_hit(origins: torch.Tensor, dirs: torch.Tensor, scene: Scene,
                t_min: float = 0.0):
    """(t [N] float32, tri_id [N] int64) of each ray's closest hit beyond
    t_min; inf and -1 on a miss. Directions need not be unit."""
    o = origins.detach().float()
    d = dirs.detach().float()
    n = o.shape[0]
    dev = o.device
    best_t = torch.full((n,), float("inf"), device=dev)
    best_id = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if n == 0:
        return best_t, best_id
    ray, chunk = _pairs(o, d, scene, t_min)
    pair_t, pair_id = [], []
    cols = torch.arange(CHUNK, device=dev)
    for p0 in range(0, ray.shape[0], PAIR_BLOCK):
        r = ray[p0:p0 + PAIR_BLOCK]
        c = chunk[p0:p0 + PAIR_BLOCK]
        oo = o[r][:, None, :]
        dd = d[r][:, None, :].expand(-1, CHUNK, -1)
        v0, e1, e2 = scene.v0[c], scene.e1[c], scene.e2[c]
        pvec = torch.linalg.cross(dd, e2, dim=-1)
        det = torch.sum(e1 * pvec, dim=-1)
        inv_det = 1.0 / torch.where(torch.abs(det) > DET_EPS, det,
                                    torch.full_like(det, float("inf")))
        tvec = oo - v0
        u = torch.sum(tvec * pvec, dim=-1) * inv_det
        qvec = torch.linalg.cross(tvec, e1, dim=-1)
        v = torch.sum(dd * qvec, dim=-1) * inv_det
        t = torch.sum(e2 * qvec, dim=-1) * inv_det
        ok = (scene.valid[c] & (u >= -UV_EPS) & (v >= -UV_EPS)
              & (u + v <= 1.0 + UV_EPS) & (t > t_min))
        t = torch.where(ok, t, torch.full_like(t, float("inf")))
        tm = t.amin(dim=1)
        arg = torch.where(t <= tm[:, None], cols, CHUNK).amin(dim=1)
        pair_t.append(tm)
        pair_id.append(c * CHUNK + arg)
    if not pair_t:
        return best_t, best_id
    pt, pid = torch.cat(pair_t), torch.cat(pair_id)
    best_t.scatter_reduce_(0, ray, pt, reduce="amin")
    hit = torch.isfinite(pt) & (pt == best_t[ray])
    big = torch.iinfo(torch.int64).max
    ids = torch.full((n,), big, dtype=torch.int64, device=dev)
    ids.scatter_reduce_(0, ray, torch.where(hit, pid, big), reduce="amin")
    best_id = torch.where(ids == big, best_id, ids)
    return best_t, best_id

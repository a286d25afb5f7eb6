"""Active-ray Morton re-sort for incoherent oracle queries (port of
drt_tpu/intersect/resort.py).

The cheap tile-frustum prepass (the tile mode of `csrc/candidates.cu`,
plain version `cuda_kernel._candidates_tile`) needs the rays of a tile to
be spatially coherent: true for camera pixels (bounce 1), false for
post-refraction interior and exit rays, whose tile frustums straddle
direction octants and blow up to near-full candidate lists. The default
answer is the exact per-ray prepass (the kernel's ray mode). This module is
the other one: permute the rays by a (direction-octant, origin-Morton) key
so each tile is octant-pure and spatially local, run the oracle with the
tile prepass, and scatter the hits back. The sort is
oracle-internal: inputs are detached, outputs are per-ray, and the oracle
gates work per ray, so the hits are those of the unsorted query, bit for
bit when the oracle is also given the unsorted query's shift (as
`get_intersect_fn` gives it). Parked dead lanes (render/trace._park_rays) share one far bin and
cluster into all-parked tiles whose frustums miss every chunk.
"""

from __future__ import annotations

import torch

from drt_tpu_torch.intersect.api import Hits


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each int32 so consecutive bits land 3
    apart (the standard Morton bit-twiddle)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_keys(origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """[N] int32 sort keys: direction octant (3 bits) then a 27-bit Morton
    code of the origin quantized against the batch's own origin AABB.
    Octant-major ordering makes sorted tiles sign-pure in every direction
    component, which keeps the tile prepass's inverse-direction intervals
    bounded."""
    o = origins.float()
    lo = o.amin(dim=0)
    span = (o.amax(dim=0) - lo).clamp_min(1e-20)
    q = ((o - lo) / span * 511.0).clamp(0.0, 511.0).to(torch.int32)
    m = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
         | (_spread3(q[:, 2]) << 2))                       # 27 bits
    neg = (dirs < 0).to(torch.int32)
    octant = neg[:, 0] | (neg[:, 1] << 1) | (neg[:, 2] << 2)  # 3 bits
    return (octant << 27) | m


@torch.no_grad()
def resorted_intersect(fn, origins, dirs, vertices, faces, face_valid,
                       **kw) -> Hits:
    """Run `fn` on Morton-sorted rays and scatter the hits back to the
    original lane order (a stable sort, so the order is the JAX
    package's)."""
    order = torch.argsort(morton_keys(origins, dirs), stable=True)
    hits = fn(origins[order], dirs[order], vertices, faces, face_valid, **kw)
    t = torch.empty_like(hits.t)
    tri_id = torch.empty_like(hits.tri_id)
    t[order] = hits.t
    tri_id[order] = hits.tri_id
    return Hits(t, tri_id)

"""Space carving: build a visual-hull mesh from silhouette masks (port of
drt_tpu/data/carve.py).

The reference never builds its hulls in-repo: the bundled `*_vh.ply` meshes
were carved upstream from the same masks that ship in the .h5 captures
(captured_data.py:12-20). Carving the hull from the capture's own masks
gives a first mesh consistent with the silhouettes, with no ground truth.

Pipeline: voxel occupancy = min over views of the soft mask sampled at each
voxel's projection (torch, on the capture's device) -> morphological
cleanup -> surface-nets isosurface extraction (watertight by construction
on well-composed fields) -> isotropic remesh to the LOD start edge length
(host numpy and scipy, copied from the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from drt_tpu_torch.data.views import CaptureData


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fma32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 a, c and b (a tensor or a float32 value): the
    product exact in float64, the sum rounded to float64 and then to
    float32 (see carve_occupancy)."""
    return (a.double() * b + c.double()).float()


@torch.no_grad()
def carve_occupancy(masks, R, K, lo: np.ndarray, hi: np.ndarray,
                    resolution: int = 128, device="cuda"
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Min-over-views soft occupancy on a regular grid, computed on
    `device`.

    masks: [Vw, resy, resx] soft masks in [0,1]; R: [Vw,4,4] world->cam;
    K: [Vw,3,3]; numpy arrays or tensors. Returns (field [n,n,n] float32,
    in_frame [n,n,n] bool, origin [3], spacing [3]) as numpy arrays.

    A voxel projecting outside a view's frame is unconstrained by that view
    (its mask says nothing there), so it does not carve, but `in_frame`
    records whether the voxel is inside EVERY view's frame. The rig keeps
    the object in frame in all views, so callers should reject
    never-observed voxels: at wide aspect ratios (Redmi 16:9) the volume
    corners above/below every frustum form solid slabs bigger than the
    object, and the largest-connected-component cleanup would otherwise keep
    a slab instead of the object.

    The views go one at a time, with the field and `seen` kept on the device
    and one read to the host at the end. Memory: resolution^3 points, 4.1M
    at 160 (49 MB as float32 [P,3]); one view's projection (float64 in its
    fused steps), gather and blend hold about 100 bytes a point at their
    peak, so about 0.4 GB at 160^3 and 1.7 GB at 256^3.

    The projection rounds as XLA rounds the JAX package's two float32
    matmuls on the CPU: the extrinsic's four terms as products rounded on
    their own and summed pairwise, (p0 + p1) + (p2 + p3); the intrinsic's
    three as a chain of fused multiply-adds, fma(c2, k2, fma(c1, k1,
    c0 * k0)); the bilinear blend with the fused multiply-adds it gets
    there too (the orders XLA's CPU code takes, found by comparing bits).
    Each fused multiply-add is taken in float64 (the product is
    exact there) and rounded to float32, which differs from a true one only
    where the float64 sum lands on a float32 halfway point. As separate
    elementwise ops this rounds alike on the CPU and the card, where a matmul
    would not (CPU BLAS and cuBLAS pick their own orders), and no TF32
    setting reaches it. A voxel near the 0.5 level or a frame edge then
    falls on the same side in both packages and on both devices.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("carve_occupancy(device='cuda'): torch sees no "
                           "CUDA device; pass device='cpu' to run on the CPU")
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    n = resolution
    spacing = (hi - lo) / (n - 1)
    axes = [np.linspace(lo[a], hi[a], n) for a in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = torch.as_tensor(np.stack([gx, gy, gz], axis=-1).reshape(-1, 3),
                          dtype=torch.float32, device=device)     # [P,3]
    del gx, gy, gz
    px, py, pz = pts.unbind(1)

    resy, resx = masks.shape[1], masks.shape[2]
    one = torch.ones((), dtype=torch.float32, device=device)
    guard = torch.full((), 1e-9, dtype=torch.float32, device=device)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    R32, K32 = _host(R).astype(np.float32), _host(K).astype(np.float32)
    field = torch.ones((pts.shape[0],), dtype=torch.float32, device=device)
    seen = torch.ones((pts.shape[0],), dtype=torch.bool, device=device)
    for v in range(masks.shape[0]):
        mask = f32(masks[v])
        Rv, Kv = R32[v], K32[v]
        # cam = [pts, 1] @ Rv.T, pix = cam[:, :3] @ Kv.T (see the docstring)
        cam = [(px * float(Rv[j, 0]) + py * float(Rv[j, 1]))
               + (pz * float(Rv[j, 2]) + float(Rv[j, 3])) for j in range(3)]
        pix = [_fma32(cam[2], float(Kv[j, 2]),
                      _fma32(cam[1], float(Kv[j, 1]),
                             cam[0] * float(Kv[j, 0]))) for j in range(3)]
        del cam
        z = pix[2]
        zs = torch.where(torch.abs(z) > 1e-9, z, guard)
        x = pix[0] / zs
        y = pix[1] / zs
        del pix, zs
        inside = ((z > 0) & (x >= 0) & (x <= resx - 1) & (y >= 0)
                  & (y <= resy - 1))
        # Clip in float before the cast: a voxel behind the camera or far
        # off frame projects to a huge coordinate, whose cast to int is
        # undefined (and differs between CPU and CUDA). The JAX package casts
        # first and clips after; for every voxel `inside` keeps, both give
        # the same index, and the others' gathered values are discarded.
        x0 = torch.clamp(torch.floor(x), 0, resx - 2)
        y0 = torch.clamp(torch.floor(y), 0, resy - 2)
        wx = torch.clamp(x - x0, 0.0, 1.0)
        wy = torch.clamp(y - y0, 0.0, 1.0)
        del x, y
        flat = mask.reshape(-1)
        i00 = y0.long() * resx + x0.long()
        del x0, y0
        # (1-wy) * ((1-wx) m00 + wx m01) + wy * ((1-wx) m10 + wx m11), with
        # the fused multiply-adds XLA puts in it on the CPU
        ux, uy = 1 - wx, 1 - wy
        top = _fma32(wx, flat[i00 + 1], ux * flat[i00])
        bot = _fma32(wx, flat[i00 + resx + 1], ux * flat[i00 + resx])
        m = _fma32(uy, top, wy * bot)
        del i00, wx, wy, ux, uy, top, bot
        view_occ = torch.where(inside, m, one)    # out of frame: unconstrained
        field = torch.minimum(field, view_occ)
        seen = seen & inside
        del m, view_occ, inside
    return (field.reshape(n, n, n).cpu().numpy(),
            seen.reshape(n, n, n).cpu().numpy(), lo, spacing)


# Cell-corner offsets (x,y,z) indexed 0..7, and the 12 cell edges as corner
# index pairs — the standard dual-grid configuration for surface nets.
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]])
_CELL_EDGES = np.array([[0, 1], [2, 3], [4, 5], [6, 7],    # x-edges
                        [0, 2], [1, 3], [4, 6], [5, 7],    # y-edges
                        [0, 4], [1, 5], [2, 6], [3, 7]])   # z-edges


def surface_nets(field: np.ndarray, origin: np.ndarray, spacing: np.ndarray,
                 iso: float = 0.5):
    """Naive surface nets: one vertex per sign-changing cell (at the mean of
    its edge-crossing points), one quad per sign-changing grid edge,
    connecting the 4 cells around that edge. Returns (vertices [V,3] f64,
    faces [F,3] i64), consistently outward-oriented.
    """
    f = np.pad(field.astype(np.float64), 1, constant_values=iso - 1.0)
    occ = f > iso
    n = np.array(f.shape)

    # 8 corner samples per cell, shape [cx,cy,cz]
    corner_f = [f[dx:n[0] - 1 + dx, dy:n[1] - 1 + dy, dz:n[2] - 1 + dz]
                for dx, dy, dz in _CORNERS]
    corner_occ = [c > iso for c in corner_f]
    code = np.zeros(corner_f[0].shape, dtype=np.uint8)
    for i, c in enumerate(corner_occ):
        code |= (c.astype(np.uint8) << i)
    active = (code != 0) & (code != 255)
    if not active.any():
        raise ValueError("empty occupancy field — nothing to extract")

    cell_index = np.full(active.shape, -1, dtype=np.int64)
    ids = np.nonzero(active)
    cell_index[ids] = np.arange(len(ids[0]))

    # Vertex = mean of edge-crossing points over the cell's crossing edges.
    pos_sum = np.zeros((len(ids[0]), 3))
    cnt = np.zeros(len(ids[0]))
    cf = [c[ids] for c in corner_f]                     # per-active-cell
    for a, b in _CELL_EDGES:
        fa, fb = cf[a], cf[b]
        cross = (fa > iso) != (fb > iso)
        t = np.zeros_like(fa)
        denom = fb - fa
        t[cross] = (iso - fa[cross]) / denom[cross]
        p = _CORNERS[a] + t[:, None] * (_CORNERS[b] - _CORNERS[a])
        pos_sum += np.where(cross[:, None], p, 0.0)
        cnt += cross
    local = pos_sum / np.maximum(cnt, 1)[:, None]
    base = np.stack(ids, axis=1).astype(np.float64)     # cell lower corner
    # cells live on the padded grid: sample (i,j,k) = world origin + (i-1)*h
    verts = origin[None, :] + (base + local - 1.0) * spacing[None, :]

    # One quad per interior sign-changing sample edge along each axis.
    faces = []
    for axis in range(3):
        sl_lo = [slice(0, n[i] - (1 if i == axis else 0)) for i in range(3)]
        sl_hi = [slice(1 if i == axis else 0, n[i]) for i in range(3)]
        lo_occ = occ[tuple(sl_lo)]
        hi_occ = occ[tuple(sl_hi)]
        cross = lo_occ != hi_occ
        ei, ej, ek = np.nonzero(cross)
        e = np.stack([ei, ej, ek], axis=1)               # sample coords
        # 4 adjacent cells, counter-clockwise around the +axis direction
        u, w = (axis + 1) % 3, (axis + 2) % 3
        off = np.zeros((4, 3), dtype=np.int64)
        off[1][u] = -1
        off[2][u] = -1
        off[2][w] = -1
        off[3][w] = -1
        quad = np.stack([cell_index[tuple((e + o).T)] for o in off], axis=1)
        ok = (quad >= 0).all(axis=1)
        quad = quad[ok]
        # orientation: if the low sample is solid the normal points +axis
        flip = lo_occ[ei[ok], ej[ok], ek[ok]]
        quad[flip] = quad[flip][:, ::-1]
        faces.append(np.stack([quad[:, 0], quad[:, 1], quad[:, 2]], axis=1))
        faces.append(np.stack([quad[:, 0], quad[:, 2], quad[:, 3]], axis=1))
    faces = np.concatenate(faces).astype(np.int64)

    # Consistent global orientation -> make it outward via signed volume.
    tri = verts[faces]
    vol = np.einsum("ij,ij->", np.cross(tri[:, 0], tri[:, 1]), tri[:, 2]) / 6
    if vol < 0:
        faces = faces[:, ::-1]
    return verts, faces


def _cleanup_binary(occ: np.ndarray) -> np.ndarray:
    """Largest connected component + hole fill — removes speckle that would
    break manifoldness."""
    from scipy import ndimage
    occ = ndimage.binary_fill_holes(occ)
    labels, num = ndimage.label(occ)
    if num > 1:
        sizes = ndimage.sum(occ, labels, range(1, num + 1))
        occ = labels == (1 + int(np.argmax(sizes)))
    return occ


def _make_well_composed(occ: np.ndarray, max_rounds: int = 64) -> np.ndarray:
    """Repair the binary field until it is well-composed (no 2D checkerboard
    plaquettes, no solid voxel pairs touching only at a cube corner) — the
    condition under which surface nets yields a 2-manifold watertight
    surface. Repairs only ever ADD solid voxels, so the hull property
    (carved volume contains the object) is preserved.
    """
    occ = occ.copy()
    for _ in range(max_rounds):
        changed = False
        # 2D checkerboards in each axis-aligned plane: two solid voxels
        # sharing only an edge -> fill the two empty diagonal cells.
        for a, b in ((0, 1), (0, 2), (1, 2)):
            def sl(da, db):
                s = [slice(None)] * 3
                s[a] = slice(da, occ.shape[a] - 1 + da)
                s[b] = slice(db, occ.shape[b] - 1 + db)
                return tuple(s)
            s00, s01 = occ[sl(0, 0)], occ[sl(0, 1)]
            s10, s11 = occ[sl(1, 0)], occ[sl(1, 1)]
            cb1 = s00 & s11 & ~s01 & ~s10
            cb2 = ~s00 & ~s11 & s01 & s10
            if cb1.any():
                s01[cb1] = True
                s10[cb1] = True
                changed = True
            if cb2.any():
                s00[cb2] = True
                s11[cb2] = True
                changed = True
        # 3D corner contacts: exactly two solid voxels in a 2x2x2 block,
        # diagonally opposite -> fill a face-neighbor of one of them.
        n0, n1, n2 = occ.shape
        blk = [occ[dx:n0 - 1 + dx, dy:n1 - 1 + dy, dz:n2 - 1 + dz]
               for dx, dy, dz in _CORNERS]
        total = sum(x.astype(np.int8) for x in blk)
        for i, j in ((0, 7), (1, 6), (2, 5), (3, 4)):
            pair = blk[i] & blk[j] & (total == 2)
            if pair.any():
                # corner i offset (x,y,z); fill the voxel differing in x only
                fill = _CORNERS[i].copy()
                fill[0] ^= 1
                blk[int(fill[0]) + 2 * int(fill[1]) + 4 * int(fill[2])][pair] = True
                changed = True
        if not changed:
            return occ
    raise ValueError("well-composed repair did not converge")


def rig_working_volume(cap: CaptureData, frac: float = 0.45):
    """Carving volume (lo, hi) from the camera geometry alone — no ground
    truth needed (real .h5 captures have none). Center = least-squares
    intersection of the optical axes (the rig's turntable center); half
    extent = `frac` x mean camera distance. The ring rig frames the object
    at roughly cam_dist/3.5 radius (captured_data.py geometry), so 0.45
    over-covers safely: oversizing is harmless since carved_visual_hull
    rejects never-in-frame voxels and carves the rest.
    """
    R = _host(cap.views.R).astype(np.float64)          # [Vw,4,4] world->cam
    R_inv = np.linalg.inv(R)
    centers = R_inv[:, :3, 3]                          # camera positions
    axes = R[:, 2, :3]                                 # viewing directions
    axes = axes / np.linalg.norm(axes, axis=1, keepdims=True)
    # min_p sum ||(I - z z^T)(p - o)||^2  ->  A p = b
    eye = np.eye(3)
    proj = eye[None] - axes[:, :, None] * axes[:, None, :]
    A = proj.sum(0)
    b = np.einsum("vij,vj->i", proj, centers)
    p = np.linalg.solve(A, b)
    half = frac * float(np.linalg.norm(centers - p, axis=1).mean())
    return p - half, p + half


def carved_visual_hull(cap: CaptureData, lo, hi, resolution: int = 128,
                       target_len: float | None = None, device=None):
    """Carve a hull from the capture's own masks (self-consistent init).

    lo/hi: world-space bounds of the carving volume (the rig's calibrated
    working volume). The occupancy runs on `device`, by default the device
    the capture's views are on. Returns (vertices, faces), optionally
    remeshed to `target_len`. Raises if the extracted surface is not
    watertight even after morphological cleanup.
    """
    from drt_tpu_torch.mesh.topology import build_topology

    views = cap.views
    if device is None:
        device = views.mask.device
    field, seen, origin, spacing = carve_occupancy(
        views.mask, views.R, views.K, lo, hi, resolution, device=device)

    # Reject voxels not observed by every view: the object is in frame in
    # all views, so this only removes the never-carvable out-of-frustum
    # regions (which can exceed the object in volume at wide aspects).
    field = np.where(seen, field, 0.0)
    occ = _cleanup_binary(field > 0.5)
    occ = _make_well_composed(occ)
    # keep the soft field where it survived cleanup (smooth crossings),
    # hard 0/1 where repair changed the sign
    field = np.where(occ == (field > 0.5), field, occ.astype(field.dtype))
    v, f = surface_nets(field, origin, spacing)

    topo = build_topology(f, len(v))
    if not topo.is_watertight:
        from scipy import ndimage
        occ2 = ndimage.binary_closing(occ, iterations=1)
        occ2 = _make_well_composed(_cleanup_binary(occ2))
        v, f = surface_nets(occ2.astype(np.float64), origin, spacing)
        topo = build_topology(f, len(v))
        if not topo.is_watertight:
            raise ValueError("carved surface is not watertight")

    if target_len is not None:
        from drt_tpu_torch.remesh import isotropic_remesh
        v, f = isotropic_remesh(v, f, target_len)
    return v, f

"""In-process isotropic explicit remeshing (host, numpy; the port's own
copy of drt_tpu/remesh/isotropic.py).

Replaces the reference's meshlabserver subprocess (optim.py:12-56): the MLX
script there runs MeshLab's "Isotropic Explicit Remeshing" — the
Botsch-Kobbelt local-operator algorithm — with 3 iterations, non-adaptive
TargetLen, and split/collapse/swap/smooth/reproject all enabled
(optim.py:18-31). This module implements the same operator sequence:

  per iteration:
    1. split every edge longer than 4/3 * L at its midpoint
    2. collapse every edge shorter than 4/5 * L into its midpoint
       (guarded: link condition for manifoldness, no new edge > 4/3 * L)
    3. flip edges that reduce total squared valence deviation from 6
    4. tangential uniform-Laplacian smoothing
    5. reproject vertices onto the original surface

Watertightness is preserved by construction (the reference asserts it after
every remesh, DiffRender.py:305; build_mesh_state re-asserts here).
Collapse/flip batches are chosen as vertex-disjoint independent sets so all
ops in a batch commute.
"""

from __future__ import annotations

import numpy as np

from drt_tpu_torch.remesh.surface import SurfaceIndex


def _unique_edges(faces: np.ndarray, num_v: int):
    """Unique undirected edges [E,2] plus per-face edge ids [F,3] for the
    edges (v0,v1),(v1,v2),(v2,v0)."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    key = np.minimum(e[:, 0], e[:, 1]).astype(np.int64) * num_v \
        + np.maximum(e[:, 0], e[:, 1])
    uniq, inv = np.unique(key, return_inverse=True)
    edges = np.stack([uniq // num_v, uniq % num_v], axis=1).astype(np.int64)
    face_edge = inv.reshape(3, -1).T                   # [F,3]
    return edges, face_edge


def _edge_lengths(v, edges):
    return np.linalg.norm(v[edges[:, 0]] - v[edges[:, 1]], axis=1)


# --- 1. split ---------------------------------------------------------------

_SPLIT_PATTERNS = {
    # mask over (e01, e12, e20) -> list of new faces in tokens:
    # 0,1,2 = original corners; 'a','b','c' = midpoints of e01,e12,e20
    (0, 0, 0): [(0, 1, 2)],
    (1, 0, 0): [(0, "a", 2), ("a", 1, 2)],
    (0, 1, 0): [(1, "b", 0), ("b", 2, 0)],
    (0, 0, 1): [(2, "c", 1), ("c", 0, 1)],
    (1, 1, 0): [(0, "a", 2), ("a", "b", 2), ("a", 1, "b")],
    (0, 1, 1): [(1, "b", 0), ("b", "c", 0), ("b", 2, "c")],
    (1, 0, 1): [(0, "a", "c"), ("a", 1, "c"), ("c", 1, 2)],
    (1, 1, 1): [(0, "a", "c"), ("a", 1, "b"), ("b", 2, "c"), ("a", "b", "c")],
}


def split_long_edges(v: np.ndarray, f: np.ndarray, lmax: float):
    num_v = len(v)
    edges, face_edge = _unique_edges(f, num_v)
    long = _edge_lengths(v, edges) > lmax
    if not long.any():
        return v, f
    # midpoint vertex id for each long edge
    mid_id = np.full(len(edges), -1, dtype=np.int64)
    mid_id[long] = num_v + np.arange(long.sum())
    midpoints = 0.5 * (v[edges[long, 0]] + v[edges[long, 1]])
    v = np.concatenate([v, midpoints])

    fe_long = long[face_edge]                          # [F,3] bool
    fe_mid = mid_id[face_edge]                         # [F,3]

    out_faces = []
    for mask, patterns in _SPLIT_PATTERNS.items():
        sel = np.all(fe_long == np.array(mask, dtype=bool), axis=1)
        if not sel.any():
            continue
        fsel = f[sel]
        mids = {"a": fe_mid[sel, 0], "b": fe_mid[sel, 1], "c": fe_mid[sel, 2]}
        for pat in patterns:
            cols = [fsel[:, t] if isinstance(t, int) else mids[t]
                    for t in pat]
            out_faces.append(np.stack(cols, axis=1))
    return v, np.concatenate(out_faces).astype(np.int64)


# --- 2. collapse ------------------------------------------------------------

def _vertex_neighbors(f: np.ndarray, num_v: int):
    """List of neighbor sets per vertex."""
    edges, _ = _unique_edges(f, num_v)
    nbr = [set() for _ in range(num_v)]
    for a, b in edges:
        nbr[a].add(int(b))
        nbr[b].add(int(a))
    return nbr, edges


def collapse_short_edges(v: np.ndarray, f: np.ndarray, lmin: float,
                         lmax: float, max_rounds: int = 50,
                         surface: SurfaceIndex | None = None,
                         max_surf_dist: float = 0.0):
    """Collapse short edges until none remain (or guards block the rest).
    Each round applies a vertex-disjoint batch (1-ring claimed so collapses
    commute), so multiple rounds emulate the sequential halfedge sweep.
    With `surface`/`max_surf_dist`, collapses whose midpoint deviates more
    than max_surf_dist from the original surface are rejected
    (meshlabserver CheckSurfDist/MaxSurfDist semantics)."""
    for _ in range(max_rounds):
        v2, f2 = _collapse_round(v, f, lmin, lmax, surface, max_surf_dist)
        if len(v2) == len(v):
            break
        v, f = v2, f2
    return v, f


def _collapse_round(v: np.ndarray, f: np.ndarray, lmin: float,
                    lmax: float, surface: SurfaceIndex | None = None,
                    max_surf_dist: float = 0.0):
    num_v = len(v)
    nbr, edges = _vertex_neighbors(f, num_v)
    ln = _edge_lengths(v, edges)
    short = np.nonzero(ln < lmin)[0]
    if len(short) == 0:
        return v, f
    short = short[np.argsort(ln[short])]               # shortest first
    surf_ok = None
    if surface is not None and max_surf_dist > 0:
        mids = 0.5 * (v[edges[short, 0]] + v[edges[short, 1]])
        _, d = surface.closest_points(mids)
        surf_ok = dict(zip(short.tolist(), (d <= max_surf_dist).tolist()))

    # opposite vertices of each edge (for the link condition) via face scan
    edge_key = {}
    for (a, b) in map(tuple, edges):
        edge_key[(min(a, b), max(a, b))] = []
    for tri in f:
        for i in range(3):
            a, b, c = int(tri[i]), int(tri[(i + 1) % 3]), int(tri[(i + 2) % 3])
            edge_key[(min(a, b), max(a, b))].append(c)

    face_set = set(map(tuple, np.sort(f, axis=1)))
    claimed = np.zeros(num_v, dtype=bool)
    target = np.arange(num_v, dtype=np.int64)          # collapse mapping
    new_pos = v.copy()
    for ei in short:
        a, b = int(edges[ei, 0]), int(edges[ei, 1])
        if claimed[a] or claimed[b]:
            continue
        if surf_ok is not None and not surf_ok[int(ei)]:
            continue
        opp = edge_key[(min(a, b), max(a, b))]
        if len(opp) != 2:
            continue                                   # non-manifold edge
        # link condition: N(a)∩N(b) must be exactly the two opposite verts
        inter = nbr[a] & nbr[b]
        if inter != set(opp):
            continue
        # duplicate-face guard (tetrahedron endgame — see native/remesh.cpp):
        # if faces {a,c1,c2} and {b,c1,c2} both exist, the collapse would
        # produce a duplicated face (degenerate pillow)
        c1, c2 = opp
        if (tuple(sorted((a, c1, c2))) in face_set
                and tuple(sorted((b, c1, c2))) in face_set):
            continue
        mid = 0.5 * (v[a] + v[b])
        # no new over-long edges (Botsch-Kobbelt guard)
        ring = (nbr[a] | nbr[b]) - {a, b}
        if ring and np.max(np.linalg.norm(v[list(ring)] - mid, axis=1)) > lmax:
            continue
        # claim the whole 1-ring so batch ops commute
        claimed[a] = claimed[b] = True
        for x in ring:
            claimed[x] = True
        target[b] = a
        new_pos[a] = mid

    if (target == np.arange(num_v)).all():
        return v, f
    f2 = target[f]
    # drop degenerate faces (two corners merged)
    keep = ((f2[:, 0] != f2[:, 1]) & (f2[:, 1] != f2[:, 2])
            & (f2[:, 2] != f2[:, 0]))
    f2 = f2[keep]
    # compact vertex ids
    used = np.zeros(num_v, dtype=bool)
    used[f2.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    return new_pos[used], remap[f2]


# --- 3. flip ----------------------------------------------------------------

def flip_edges(v: np.ndarray, f: np.ndarray,
               surface: SurfaceIndex | None = None,
               max_surf_dist: float = 0.0):
    num_v = len(v)
    edges, _ = _unique_edges(f, num_v)
    # adjacency: edge -> (two faces, opposite vertices)
    edge_faces = {}
    for fi, tri in enumerate(f):
        for i in range(3):
            a, b = int(tri[i]), int(tri[(i + 1) % 3])
            c = int(tri[(i + 2) % 3])
            edge_faces.setdefault((min(a, b), max(a, b)), []).append((fi, c))

    valence = np.zeros(num_v, dtype=np.int64)
    for (a, b) in map(tuple, edges):
        valence[a] += 1
        valence[b] += 1

    existing = set((min(a, b), max(a, b)) for a, b in map(tuple, edges))
    face_alive = np.ones(len(f), dtype=bool)
    face_dirty = np.zeros(len(f), dtype=bool)
    new_faces = []

    def dev(x):
        return (x - 6) ** 2

    for (a, b), adj in edge_faces.items():
        if len(adj) != 2:
            continue
        (f1, c), (f2, d) = adj
        if not (face_alive[f1] and face_alive[f2]) or face_dirty[f1] \
                or face_dirty[f2]:
            continue
        if c == d or (min(c, d), max(c, d)) in existing:
            continue
        before = dev(valence[a]) + dev(valence[b]) + dev(valence[c]) \
            + dev(valence[d])
        after = dev(valence[a] - 1) + dev(valence[b] - 1) \
            + dev(valence[c] + 1) + dev(valence[d] + 1)
        if after >= before:
            continue
        # geometric guard: don't create a flipped/degenerate pair — require
        # the new edge's two triangles to keep consistent orientation with
        # the old normals
        n_old = np.cross(v[b] - v[a], v[c] - v[a]) \
            + np.cross(v[a] - v[b], v[d] - v[b])
        n1 = np.cross(v[d] - v[c], v[a] - v[c])
        n2 = np.cross(v[c] - v[d], v[b] - v[d])
        if np.dot(n1, n_old) <= 0 or np.dot(n2, n_old) <= 0:
            continue
        # CheckSurfDist: the new edge midpoint must stay near the original
        # surface (meshlabserver MaxSurfDist)
        if surface is not None and max_surf_dist > 0:
            _, dcd = surface.closest_points(0.5 * (v[c] + v[d])[None])
            if dcd[0] > max_surf_dist:
                continue
        # orientation: f1 contains (a,b,c) in some rotation with edge a->b.
        # Determine directed order of (a,b) in f1 to keep winding.
        tri1 = f[f1]
        ia = np.where(tri1 == a)[0][0]
        a_then_b = tri1[(ia + 1) % 3] == b
        if a_then_b:
            nf1 = (a, d, c)
            nf2 = (b, c, d)
        else:
            nf1 = (a, c, d)
            nf2 = (b, d, c)
        face_alive[f1] = face_alive[f2] = False
        new_faces += [nf1, nf2]
        valence[a] -= 1
        valence[b] -= 1
        valence[c] += 1
        valence[d] += 1
        existing.discard((min(a, b), max(a, b)))
        existing.add((min(c, d), max(c, d)))
        # mark neighbors dirty-ish: faces sharing these vertices unaffected
        # topologically; it's enough that f1,f2 are gone.

    if not new_faces:
        return f
    return np.concatenate([f[face_alive],
                           np.asarray(new_faces, dtype=np.int64)])


# --- 4. smooth --------------------------------------------------------------

def tangential_smooth(v: np.ndarray, f: np.ndarray, lam: float = 0.5):
    num_v = len(v)
    edges, _ = _unique_edges(f, num_v)
    s = np.zeros_like(v)
    cnt = np.zeros(num_v)
    np.add.at(s, edges[:, 0], v[edges[:, 1]])
    np.add.at(s, edges[:, 1], v[edges[:, 0]])
    np.add.at(cnt, edges[:, 0], 1)
    np.add.at(cnt, edges[:, 1], 1)
    avg = s / np.maximum(cnt, 1)[:, None]

    # area-weighted vertex normals
    tri = v[f]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = np.zeros_like(v)
    for i in range(3):
        np.add.at(vn, f[:, i], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-20)

    d = avg - v
    d_tan = d - vn * np.sum(d * vn, axis=1, keepdims=True)
    return v + lam * d_tan


# --- repair -----------------------------------------------------------------

def remove_duplicate_face_pairs(v: np.ndarray, f: np.ndarray):
    """Remove degenerate "pillow" artifacts: pairs of faces over the same
    vertex triple (opposite winding). Each pair contributes 2 to its three
    edge counts, so edge-based watertight checks pass while a later edge
    split explodes the pillow into 4-face edges. Produced by the collapse
    tetra-endgame bug since fixed in native/remesh.cpp; this repairs
    meshes corrupted before the fix (e.g. resumed checkpoints). Unreferenced
    vertices are dropped. Returns (v, f) unchanged if no duplicates exist."""
    f = np.asarray(f)
    tri_sorted = np.sort(f, axis=1)
    _, inv, counts = np.unique(tri_sorted, axis=0, return_inverse=True,
                               return_counts=True)
    if (counts <= 1).all():
        return v, f
    # drop floor(count/2)*2 faces of each duplicated triple
    keep = np.ones(len(f), dtype=bool)
    for g in np.nonzero(counts > 1)[0]:
        idx = np.nonzero(inv == g)[0]
        drop = (len(idx) // 2) * 2
        keep[idx[:drop]] = False
    f2 = f[keep]
    used = np.zeros(len(v), dtype=bool)
    used[f2.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    return np.asarray(v)[used], remap[f2]


# --- top level --------------------------------------------------------------

def isotropic_remesh(vertices: np.ndarray, faces: np.ndarray,
                     target_len: float, iterations: int = 3,
                     project: bool = True, use_native: bool = True,
                     max_surf_dist: float = 1.0):
    """Returns (vertices, faces) remeshed toward uniform edge length
    `target_len` (MLX TargetLen, optim.py:22; 3 iterations, optim.py:19).

    `max_surf_dist` mirrors meshlabserver's CheckSurfDist/MaxSurfDist=1
    (absolute units, the reference MLX script): collapses/flips that would
    deviate more than this from the input surface are rejected, which is
    what preserves thin features (tails, fingers) across coarse LOD passes.
    Pass <= 0 to disable.

    The split/collapse/flip/smooth sweep runs in the native C++ core
    (native/remesh.cpp) when available — exact sequential Botsch-Kobbelt,
    ~100x faster on large meshes — with this module's batched numpy
    implementation as the fallback. Reprojection onto the original surface
    happens here either way (the Python side owns the spatial index)."""
    v = np.asarray(vertices, dtype=np.float64).copy()
    f = np.asarray(faces, dtype=np.int64).copy()
    v, f = remove_duplicate_face_pairs(v, f)   # repair pre-fix corruption
    v0, f0 = v.copy(), f.copy()
    surface = SurfaceIndex(v, f) if (project or max_surf_dist > 0) else None

    native = None
    if use_native:
        from drt_tpu_torch.remesh.native import load_native, native_remesh_iteration
        if load_native() is not None:
            native = native_remesh_iteration

    lmax = 4.0 / 3.0 * target_len
    lmin = 4.0 / 5.0 * target_len

    for _ in range(iterations):
        if native is not None:
            v, f = native(v, f, target_len,
                          orig_vertices=v0, orig_faces=f0,
                          max_surf_dist=max_surf_dist)
        else:
            v, f = split_long_edges(v, f, lmax)
            v, f = collapse_short_edges(v, f, lmin, lmax,
                                        surface=surface,
                                        max_surf_dist=max_surf_dist)
            f = flip_edges(v, f, surface=surface,
                           max_surf_dist=max_surf_dist)
            v = tangential_smooth(v, f)
        if project and surface is not None:
            v, _ = surface.closest_points(v)
    return v, f

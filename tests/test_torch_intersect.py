"""The port's oracle against the JAX package's: the closest-hit kernel's
plain twin (what the "cuda" backend runs on CPU tensors) against JAX
`intersect_pallas` in interpret mode and JAX brute, on coherent camera rays
and on incoherent rays (a ray soup from outside and rays from inside the
mesh, like bounce 2). tri_id must be equal except for at most 2 shared-edge
ties per 1,024 rays; t uses rtol 1e-5 / atol 1e-4 (tests/test_pallas.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drt_tpu.mesh as JMESH
import drt_tpu_torch.intersect.cuda_kernel as CK
from drt_tpu.intersect.brute import intersect_brute as j_brute
from drt_tpu.intersect.culled import _chunk_aabbs as j_chunk_aabbs
from drt_tpu.intersect.pallas_kernel import _candidates as j_candidates
from drt_tpu.intersect.pallas_kernel import \
    _candidates_tile as j_candidates_tile
from drt_tpu.intersect.pallas_kernel import _coef_packed as j_coef_packed
from drt_tpu.intersect.pallas_kernel import intersect_pallas
from drt_tpu_torch.convert import mesh_state_from_arrays
from drt_tpu_torch.intersect import get_intersect_fn, intersect_brute
from tests.meshes import make_cube, make_icosphere
from tests.test_culled import scene_rays

# The test workers run side by side on few cores: torch's intra-op pool at
# its default size oversubscribes them and slows every worker down.
torch.set_num_threads(min(2, torch.get_num_threads()))

RADIUS = 50.0


@pytest.fixture(scope="module")
def meshes():
    v, f = make_icosphere(subdivisions=3, radius=RADIUS)
    jms = JMESH.build_mesh_state(v, f)
    d = {k: np.asarray(getattr(jms, k)) for k in (
        "vertices", "faces", "face_valid", "vert_valid", "edges",
        "edge_valid", "edge_faces", "neighbors", "neighbor_valid",
        "normals", "mean_len")}
    d.update(num_vertices=jms.num_vertices, num_faces=jms.num_faces,
             num_edges=jms.num_edges)
    return jms, mesh_state_from_arrays(d, "cpu")


def camera_rays(n_side=32):
    """Coherent pinhole rays toward the sphere, row-major pixel order."""
    cam = np.array([170.0, 20.0, 30.0])
    u = np.linspace(-0.4, 0.4, n_side)
    fwd = -cam / np.linalg.norm(cam)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    d = (fwd[None, None] + u[None, :, None] * right
         + u[:, None, None] * up).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (np.broadcast_to(cam, d.shape).astype(np.float32),
            d.astype(np.float32))


def inside_rays(n=512, seed=5):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-20, 20, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def soup_rays(n=1024, seed=3):
    o, d = scene_rays(n, seed=seed)
    return np.asarray(o), np.asarray(d)


RAYS = {"camera": (camera_rays, True), "soup": (soup_rays, False),
        "inside": (inside_rays, False)}


def assert_hits_close(ref_t, ref_id, t, ids):
    n = len(ref_id)
    assert (ref_id != ids).sum() <= max(1, 2 * n // 1024), \
        (ref_id != ids).sum()
    np.testing.assert_array_equal(ref_id >= 0, ids >= 0)
    both = (ref_id >= 0) & (ids >= 0)
    assert both.sum() > n // 10
    np.testing.assert_allclose(t[both], ref_t[both], rtol=1e-5, atol=1e-4)


def _port(ms, o, d, coherent):
    h = CK.intersect_cuda(torch.from_numpy(o), torch.from_numpy(d),
                          ms.vertices, ms.faces, ms.face_valid,
                          coherent=coherent)
    return h.t.numpy(), h.tri_id.numpy()


def _other_prepass(ms, o, d, coherent):
    """The plain twin's hits with the prepass the query does not pick, over
    the boxes (chunks, or groups of them) the query's own prepass scored."""
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    inp = CK.prepare_inputs(to, td, ms.vertices, ms.faces, ms.face_valid,
                            coherent=coherent)
    T = inp.count.shape[0]
    ot = inp.phi[6:9].reshape(3, T, -1).permute(1, 0, 2)
    dt = inp.phi[0:3].reshape(3, T, -1).permute(1, 0, 2)
    lo, hi, cv = CK._chunk_aabbs(ms.vertices, ms.faces, ms.face_valid,
                                 to.mean(dim=0), CK.TRI_CHUNK)
    _, _, boxes = CK._grouped_boxes(lo, hi, cv, inp.group)
    other = CK._candidates if coherent else CK._candidates_tile
    cand, count = other(ot, dt, *boxes)
    t, ids = CK.closest_hit_plain(inp._replace(cand=cand, count=count))
    return t[:len(o)].numpy(), ids[:len(o)].numpy()


@pytest.mark.parametrize("rays", sorted(RAYS))
def test_plain_oracle_matches_jax_pallas_and_brute(meshes, rays):
    jms, tms = meshes
    make, coherent = RAYS[rays]
    o, d = make()
    hb = j_brute(jnp.asarray(o), jnp.asarray(d), jms.vertices, jms.faces,
                 jms.face_valid)
    hp = intersect_pallas(jnp.asarray(o), jnp.asarray(d), jms.vertices,
                          jms.faces, jms.face_valid, ray_tile=128,
                          tri_chunk=128, prepass="ray", group=1,
                          interpret=True)
    t, ids = _port(tms, o, d, coherent)
    assert_hits_close(np.asarray(hp.t), np.asarray(hp.tri_id), t, ids)
    assert_hits_close(np.asarray(hb.t), np.asarray(hb.tri_id), t, ids)
    # both prepasses give the same hits: the kernel re-tests every ray
    t2, ids2 = _other_prepass(tms, o, d, coherent)
    np.testing.assert_array_equal(ids2, ids)
    # the torch brute oracle is the JAX brute oracle
    tb = intersect_brute(torch.from_numpy(o), torch.from_numpy(d),
                         tms.vertices, tms.faces, tms.face_valid)
    assert_hits_close(np.asarray(hb.t), np.asarray(hb.tri_id),
                      tb.t.numpy(), tb.tri_id.numpy())


def test_prepass_matches_jax(meshes):
    """Per-ray candidate lists and counts equal the JAX prepass, in order;
    the tile prepass lists a superset of them."""
    jms, tms = meshes
    o, d = soup_rays(512, seed=13)
    shift = o.mean(0)
    RT = 256
    ot = (o - shift).reshape(2, RT, 3).transpose(0, 2, 1)
    dt = d.reshape(2, RT, 3).transpose(0, 2, 1)
    jlo, jhi, jcv = j_chunk_aabbs(jms.vertices, jms.faces, jms.face_valid,
                                  jnp.asarray(shift), 128)
    jc, jn = j_candidates(jnp.asarray(ot), jnp.asarray(dt), jlo, jhi, jcv,
                          0.0)             # the port's prepass fixes t_min 0
    sh = torch.from_numpy(shift)
    lo, hi, cv = CK._chunk_aabbs(tms.vertices, tms.faces, tms.face_valid,
                                 sh, 128)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(cv.numpy(), np.asarray(jcv))
    tc, tn = CK._candidates(torch.from_numpy(ot), torch.from_numpy(dt),
                            lo, hi, cv)
    tc2, tn2 = CK._candidates_tile(torch.from_numpy(ot),
                                   torch.from_numpy(dt), lo, hi, cv)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn)[:, 0])
    np.testing.assert_array_equal(tc.numpy(),
                                  np.asarray(jc)[:, 0, :lo.shape[0]])
    for t in range(2):
        n = int(tn[t])
        assert n > 0
        assert set(tc[t, :n].tolist()) <= set(tc2[t, :int(tn2[t])].tolist())


def _tiles(o, d, rt):
    """[T,3,RT] shifted origins and directions, padded as prepare_inputs
    pads (origin 0, direction 1), and the shift."""
    shift = o.mean(0)
    pad = (-len(o)) % rt
    o = np.concatenate([o - shift, np.zeros((pad, 3), np.float32)])
    d = np.concatenate([d, np.ones((pad, 3), np.float32)])
    T = len(o) // rt
    return (np.ascontiguousarray(o.reshape(T, rt, 3).transpose(0, 2, 1)),
            np.ascontiguousarray(d.reshape(T, rt, 3).transpose(0, 2, 1)),
            shift)


@pytest.mark.parametrize("mode", ["ray", "tile"])
@pytest.mark.parametrize("rt", [64, 128, 256])
def test_prepass_lists_equal_jax(mesh_pair, rt, mode):
    """The port's plain prepasses give JAX's whole lists, in order, and its
    counts: `_candidates` on incoherent rays from inside the mesh and
    `_candidates_tile` (t_min 0) on a camera fan. JAX's argsort is stable
    and takes -0 as +0, so its ties fall in chunk-index order, the order
    csrc/candidates.cu must reproduce. The entry point `candidates` on CPU
    tensors gives the same."""
    name, v, jms, tms = mesh_pair
    o, d = _mesh_rays(v, "inside" if mode == "ray" else "camera")
    ot, dt, shift = _tiles(o, d, rt)
    jlo, jhi, jcv = j_chunk_aabbs(jms.vertices, jms.faces, jms.face_valid,
                                  jnp.asarray(shift), 128)
    lo, hi, cv = CK._chunk_aabbs(tms.vertices, tms.faces, tms.face_valid,
                                 torch.from_numpy(shift), 128)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    j_fn, t_fn = ((j_candidates, CK._candidates) if mode == "ray"
                  else (j_candidates_tile, CK._candidates_tile))
    jc, jn = j_fn(jnp.asarray(ot), jnp.asarray(dt), jlo, jhi, jcv, 0.0)
    NC = lo.shape[0]
    jc, jn = np.asarray(jc)[:, 0, :NC], np.asarray(jn)[:, 0]
    tc, tn = t_fn(torch.from_numpy(ot), torch.from_numpy(dt), lo, hi, cv)
    assert int(tn.max()) > 0
    np.testing.assert_array_equal(tn.numpy(), jn)
    np.testing.assert_array_equal(tc.numpy(), jc)
    T = ot.shape[0]
    org = torch.from_numpy(ot).permute(1, 0, 2).reshape(3, -1).contiguous()
    inv = CK._safe_inv(torch.from_numpy(dt)).permute(1, 0, 2).reshape(
        3, -1).contiguous()
    ec, en = CK.candidates(org, inv, lo, hi, cv, T, tile=mode == "tile")
    assert torch.equal(ec, tc) and torch.equal(en, tn)


def _reference_lists(org, inv, lo, hi, cv, T, tile):
    """numpy float32 reference of both prepasses: each subtraction and
    product rounded on its own, then the chunks ordered by (score, index)
    with np.lexsort."""
    o3 = org.numpy().reshape(3, T, -1).transpose(1, 0, 2)[..., None]
    i3 = inv.numpy().reshape(3, T, -1).transpose(1, 0, 2)[..., None]
    lo_t, hi_t = lo.numpy().T[None, :, None, :], hi.numpy().T[None, :, None, :]
    if tile:                                   # [T,3,1,1] intervals
        olo, ohi = o3.min(2, keepdims=True), o3.max(2, keepdims=True)
        ilo, ihi = i3.min(2, keepdims=True), i3.max(2, keepdims=True)

        def bounds(planes):
            alo, ahi = planes - ohi, planes - olo
            p = np.stack([alo * ilo, alo * ihi, ahi * ilo, ahi * ihi])
            return p.min(0), p.max(0)
        (t1lo, t1hi), (t2lo, t2hi) = bounds(lo_t), bounds(hi_t)
        entry = np.minimum(t1lo, t2lo).max(1)[:, 0]          # [T,NC]
        exit_ = np.maximum(t1hi, t2hi).min(1)[:, 0]
        ok = (entry <= exit_) & (exit_ > 0) & cv.numpy()
        score = np.where(ok, np.maximum(entry, 0), np.inf)
    else:                                      # [T,3,RT,NC]
        t1, t2 = (lo_t - o3) * i3, (hi_t - o3) * i3
        entry = np.minimum(t1, t2).max(1)
        exit_ = np.maximum(t1, t2).min(1)
        ok = (entry <= exit_) & (exit_ > 0) & cv.numpy()
        score = np.where(ok, np.maximum(entry, 0), np.inf).min(1)
    score = score + np.float32(0)              # -0 -> +0
    idx = np.arange(score.shape[1])
    cand = np.stack([np.lexsort((idx, s)) for s in score]).astype(np.int32)
    return cand, np.isfinite(score).sum(1).astype(np.int32), score


def _box_case(nc, seed, n_rays=64):
    """`nc` random boxes around the origin, a quarter of them invalid, and
    incoherent rays from inside the cloud."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10, 10, (nc, 3)).astype(np.float32)
    h = rng.uniform(0.5, 3, (nc, 3)).astype(np.float32)
    cv = rng.uniform(size=nc) > 0.25
    o = rng.uniform(-6, 6, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    org = torch.from_numpy(np.ascontiguousarray(o.T))
    inv = CK._safe_inv(torch.from_numpy(np.ascontiguousarray(d.T)))
    return (org, inv.contiguous(), torch.from_numpy(c - h),
            torch.from_numpy(c + h), torch.from_numpy(cv))


@pytest.mark.parametrize("mode", ["ray", "tile"])
@pytest.mark.parametrize("nc", [1, 37, 64])
def test_prepass_order_against_numpy(nc, mode):
    """NC = 1, an NC that is not a power of two and one that is: the plain
    prepass (what the kernel is held to) against an independent numpy
    reference, lists and counts equal."""
    org, inv, lo, hi, cv = _box_case(nc, seed=nc)
    if nc == 1:
        cv[:] = True
    T = 2
    cand, count = CK.candidates_plain(org, inv, lo, hi, cv, T,
                                      tile=mode == "tile")
    rc, rn, _ = _reference_lists(org, inv, lo, hi, cv, T, mode == "tile")
    assert int(count.max()) > 0
    np.testing.assert_array_equal(count.numpy(), rn)
    np.testing.assert_array_equal(cand.numpy(), rc)


@pytest.mark.parametrize("mode", ["ray", "tile"])
def test_prepass_ties_in_index_order(mode):
    """Equal scores keep chunk-index order: chunks 1, 3 and 5 share one box
    (equal scores to the bit), and chunks 2 and 4 contain every origin
    (score 0, as does a box whose entry rounds to -0: chunk 6 has its
    corner on ray 0's origin). Invalid chunks are never listed. One tile of
    32 rays, 8 copies of 4 that share a direction, so the tile's frustum
    stays narrow."""
    o = np.tile(np.array([[0, 0, 0], [0.1, 0, 0], [0, 0.1, 0], [0, 0, 0.1]],
                         np.float32), (8, 1))
    d = np.full((32, 3), -0.57735027, np.float32)
    lo = np.array([[-9, -9, -9], [-5, -5, -5], [-1, -1, -1], [-5, -5, -5],
                   [-1, -1, -1], [-5, -5, -5], [-1, -1, -1], [-5, -5, -5]],
                  np.float32)
    hi = np.array([[-8, -8, -8], [-4, -4, -4], [1, 1, 1], [-4, -4, -4],
                   [1, 1, 1], [-4, -4, -4], [0, 0, 0], [-4, -4, -4]],
                  np.float32)
    cv = torch.tensor([True] * 7 + [False])   # chunk 7 = chunks 1, 3, 5
    org = torch.from_numpy(np.ascontiguousarray(o.T))
    inv = CK._safe_inv(torch.from_numpy(np.ascontiguousarray(d.T)))
    cand, count = CK.candidates_plain(org, inv.contiguous(),
                                      torch.from_numpy(lo),
                                      torch.from_numpy(hi), cv, 1,
                                      tile=mode == "tile")
    if mode == "ray":
        # ray 0's entry into chunk 6 is (0 - 0) * (-1.73) = -0 on each axis
        score = CK.candidate_scores_plain(org, inv.contiguous(),
                                          torch.from_numpy(lo),
                                          torch.from_numpy(hi), cv, 1)
        assert score[0, 6] == 0 and not torch.signbit(score[0, 6])
    assert cand[0].tolist() == [2, 4, 6, 1, 3, 5, 0, 7]
    assert count.tolist() == [7]
    # the same with every chunk invalid: nothing listed, index order
    none = torch.zeros(8, dtype=torch.bool)
    cand, count = CK.candidates_plain(org, inv.contiguous(),
                                      torch.from_numpy(lo),
                                      torch.from_numpy(hi), none, 1,
                                      tile=mode == "tile")
    assert count.tolist() == [0] and cand[0].tolist() == list(range(8))


def test_sorted_candidates_takes_minus_zero_as_zero():
    score = torch.tensor([[0.0, -0.0, 1.0, -0.0, float("inf"), 0.5]])
    cand, count = CK._sorted_candidates(CK._score(torch.isfinite(score),
                                                  score))
    assert cand.tolist() == [[0, 1, 3, 5, 2, 4]] and count.tolist() == [5]


def test_api_wrapper_detaches_and_counts(meshes):
    _, tms = meshes
    o, d = camera_rays(16)
    v = tms.vertices.clone().requires_grad_(True)
    fn = get_intersect_fn("auto")
    CK.counters.reset()
    h = fn(torch.from_numpy(o), torch.from_numpy(d), v, tms.faces,
           tms.face_valid, coherent=True)
    assert not h.t.requires_grad and h.tri_id.dtype == torch.int32
    assert h.hit.any()
    # CPU tensors run the plain twin: a query, no kernel launch
    assert (CK.counters.calls, CK.counters.launches) == (1, 0)
    with pytest.raises(TypeError):
        fn(torch.from_numpy(o), torch.from_numpy(d), v, tms.faces,
           tms.face_valid)                       # coherent= is required
    with pytest.raises(ValueError):
        get_intersect_fn("pallas")


def test_kernel_wrapper_checks_inputs(meshes):
    _, tms = meshes
    o, d = camera_rays(16)
    inp = CK.prepare_inputs(torch.from_numpy(o), torch.from_numpy(d),
                            tms.vertices, tms.faces, tms.face_valid,
                            coherent=True)
    with pytest.raises(ValueError, match="CUDA"):
        CK.closest_hit_cuda(inp)               # CPU tensors never launch
    with pytest.raises(ValueError, match="cand"):
        CK.closest_hit(inp._replace(cand=inp.cand.long()))
    with pytest.raises(ValueError, match="contiguous"):
        CK.closest_hit(inp._replace(phi=inp.phi.t().contiguous().t()))
    t, ids = CK.closest_hit(inp)
    assert t.shape == (inp.phi.shape[1],) and ids.dtype == torch.int32


# --- the per-ray gate, the tie rule, the packed layout, the dispatch -------

MESH_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "reports", "tuning_meshes")


def _both_states(v, f):
    jms = JMESH.build_mesh_state(v, f)
    d = {k: np.asarray(getattr(jms, k)) for k in (
        "vertices", "faces", "face_valid", "vert_valid", "edges",
        "edge_valid", "edge_faces", "neighbors", "neighbor_valid",
        "normals", "mean_len")}
    d.update(num_vertices=jms.num_vertices, num_faces=jms.num_faces,
             num_edges=jms.num_edges)
    return jms, mesh_state_from_arrays(d, "cpu")


MESHES = {
    "icosphere": lambda: make_icosphere(subdivisions=3, radius=RADIUS),
    "cube": lambda: make_cube(size=80.0),
    "dog_mid20k": lambda: JMESH.load_ply(
        os.path.join(MESH_DIR, "dog_mid20k.ply")),
}


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh_pair(request):
    v, f = MESHES[request.param]()
    return (request.param, np.asarray(v, np.float64)) + _both_states(v, f)


def _mesh_rays(v, kind, n=512, seed=7):
    """Rays sized to the mesh's box. "camera": a coherent pinhole fan from
    outside. "inside": incoherent rays from around the centre with
    unnormalised directions (lengths 0.1..30), every 7th lane parked
    outside the box pointing away, as `_park_rays` parks dead lanes."""
    rng = np.random.default_rng(seed)
    vmin, vmax = v.min(0), v.max(0)
    c, ext = (vmin + vmax) / 2, (vmax - vmin).max()
    if kind == "camera":
        side = int(np.sqrt(n))
        cam = c + ext * np.array([0.6, 0.4, 2.9])
        fwd = (c - cam) / np.linalg.norm(c - cam)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        u = np.linspace(-0.12, 0.12, side)
        d = (fwd + u[None, :, None] * right
             + u[:, None, None] * up).reshape(-1, 3)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o = np.broadcast_to(cam, d.shape)
    else:
        o = c + rng.uniform(-0.2, 0.2, (n, 3)) * ext
        d = rng.normal(size=(n, 3))
        d *= rng.uniform(0.1, 30, (n, 1)) / np.linalg.norm(d, axis=1,
                                                           keepdims=True)
        o[::7] = vmin - (vmax - vmin) - 1.0
        d[::7] = -0.57735027
    return (np.ascontiguousarray(o, np.float32),
            np.ascontiguousarray(d, np.float32))


def _count_differences(name, ref_t, ref_id, t, ids):
    """At most 2 tri_id differences per 1,024 rays that either side hits
    (shared-edge ties and grazing hits in float32); t at rtol 1e-5 / atol
    1e-4 where the ids agree. Prints the counts."""
    n_hit = int(((ref_id >= 0) | (ids >= 0)).sum())
    bad = int((ref_id != ids).sum())
    same = (ref_id == ids) & (ids >= 0)
    print(f"{name}: {len(ids)} rays, {n_hit} hit, {bad} tri_id differ")
    assert n_hit > len(ids) // 10
    assert bad <= max(1, 2 * n_hit // 1024), (name, bad, n_hit)
    np.testing.assert_allclose(t[same], ref_t[same], rtol=1e-5, atol=1e-4)
    return bad


@pytest.mark.parametrize("kind", ["camera", "inside"])
def test_per_ray_gate_matches_brute_and_jax(mesh_pair, kind):
    """The per-ray-gated plain version against the torch brute oracle and
    against the JAX package's oracle (tile-gated `_kernel`, interpret
    mode) on the same rays."""
    name, v, jms, tms = mesh_pair
    o, d = _mesh_rays(v, kind)
    coherent = kind == "camera"
    t, ids = _port(tms, o, d, coherent)
    hb = intersect_brute(torch.from_numpy(o), torch.from_numpy(d),
                         tms.vertices, tms.faces, tms.face_valid)
    _count_differences(f"{name} {kind} vs brute", hb.t.numpy(),
                       hb.tri_id.numpy(), t, ids)
    hp = intersect_pallas(jnp.asarray(o), jnp.asarray(d), jms.vertices,
                          jms.faces, jms.face_valid, ray_tile=128,
                          tri_chunk=128, prepass="ray", group=1,
                          interpret=True)
    _count_differences(f"{name} {kind} vs drt_tpu", np.asarray(hp.t),
                       np.asarray(hp.tri_id), t, ids)
    if kind == "inside":                      # parked lanes hit nothing
        assert (ids[::7] == -1).all() and np.isinf(t[::7]).all()


def tie_case():
    """Two chunks of mostly invalid faces. Rows 38, 69 and 102 of chunk 0
    and row 1 of chunk 1 hold the same triangle (equal t to the bit); rows
    33 and 64 hold the two halves of a farther coplanar quad, whose shared
    diagonal the ray crosses. Lowest row on equal t within a chunk and strict `<`
    across chunks must answer row 38."""
    near = [[-1.0, -1, 2], [3, -1, 2], [-1, 3, 2]]
    quad = [[-1.0, -1, 4], [1, -1, 4], [1, 1, 4], [-1, 1, 4]]
    # off to the side, hit by no ray: they pull both chunks' boxes toward the
    # rays, chunk 0's nearer, so chunk 1 is entered, and entered second
    side = [[2.0, 2, z] for z in (0.5, 1.0)]
    side = [[[x, y, z], [x + 1, y, z], [x, y + 1, z]] for x, y, z in side]
    verts = torch.tensor(near + quad + side[0] + side[1],
                         dtype=torch.float32)
    faces = torch.zeros(256, 3, dtype=torch.long)
    valid = torch.zeros(256, dtype=torch.bool)
    for row, tri in ((38, [0, 1, 2]), (69, [0, 1, 2]), (102, [0, 1, 2]),
                     (128 + 1, [0, 1, 2]), (33, [3, 4, 5]),
                     (64, [3, 5, 6]), (10, [7, 8, 9]),
                     (128 + 7, [10, 11, 12])):
        faces[row] = torch.tensor(tri)
        valid[row] = True
    o = torch.zeros(64, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(64, 1)
    d[1] = torch.tensor([0.0, 0.0, 2.5])            # unnormalised: t = 0.8
    o[2] = torch.tensor([-0.5, -0.5, 3.0])          # past the near triangle
    return o, d, verts, faces, valid


def test_tie_rule_lowest_row_then_first_chunk():
    o, d, verts, faces, valid = tie_case()
    inp = CK.prepare_inputs(o, d, verts, faces, valid, coherent=False,
                            group=1)
    assert inp.count.tolist() == [2]
    t, ids = CK.closest_hit(inp)
    assert ids[0] == 38 and t[0] == 2.0
    assert ids[1] == 38 and t[1] == pytest.approx(0.8)
    # the quad's diagonal: both halves hit at one t, the lower row answers
    assert ids[2] == 33 and t[2] == 1.0
    hb = intersect_brute(o, d, verts, faces, valid)
    assert hb.tri_id[:3].tolist() == [38, 38, 33]
    # the same triangles in the other row order give the other row
    flipped = faces.clone()
    flipped[[33, 64]] = faces[[64, 33]]
    t2, ids2 = CK.closest_hit(CK.prepare_inputs(o, d, verts, flipped, valid,
                                                coherent=False, group=1))
    assert ids2[2] == 33 and torch.equal(t2, t)
    # one group of both chunks (and two of padding) walks them in the same
    # order: the same answers
    for group in (2, 4):
        g_inp = CK.prepare_inputs(o, d, verts, faces, valid, coherent=False,
                                  group=group)
        assert g_inp.count.tolist() == [1]
        t3, ids3 = CK.closest_hit(g_inp)
        assert torch.equal(ids3, ids) and torch.equal(t3, t)


def test_coef_layout_matches_jax_through_row_map(meshes):
    """The port packs the 19 nonzero coefficients as [NC,19,C]; row k is
    the JAX package's dense [NC,16,4C] at [COEF_ROWS[k], COEF_COLS[k]*C:]."""
    jms, tms = meshes
    shift = np.array([3.0, -2.0, 5.0], np.float32)
    jc, jnc = j_coef_packed(jms.vertices, jms.faces, jms.face_valid,
                            jnp.asarray(shift), 128)
    tc, tnc = CK._coef_packed(tms.vertices, tms.faces, tms.face_valid,
                              torch.from_numpy(shift), 128)
    jc = np.asarray(jc)
    assert tnc == jnc and tuple(tc.shape) == (jnc, 19, 128)
    assert tc.is_contiguous()
    C = 128
    used = np.zeros(jc.shape, bool)
    for k, (row, col) in enumerate(zip(CK.COEF_ROWS, CK.COEF_COLS)):
        np.testing.assert_allclose(tc[:, k].numpy(),
                                   jc[:, row, col * C:(col + 1) * C],
                                   rtol=1e-6, atol=1e-6)
        used[:, row, col * C:(col + 1) * C] = True
    assert not jc[~used].any()          # everything left out is a zero


def test_wrappers_dispatch_on_device_and_check_inputs(meshes):
    _, tms = meshes
    o, d = inside_rays(256)
    inp = CK.prepare_inputs(torch.from_numpy(o), torch.from_numpy(d),
                            tms.vertices, tms.faces, tms.face_valid,
                            coherent=False)
    T = inp.count.shape[0]
    assert inp.phi.shape[1] // T == CK.RAY_TILE_INCOHERENT
    cv = torch.ones(inp.lo.shape[0], dtype=torch.bool)
    args = (inp.phi[6:9], inp.inv, inp.lo, inp.hi, cv, T)
    CK.counters.reset()
    # CPU tensors take the plain versions: no launch is counted
    for tile in (False, True):
        got = CK.candidates(*args, tile=tile)
        want = CK.candidates_plain(*args, tile=tile)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    t, ids = CK.closest_hit(inp)
    tp, idp = CK.closest_hit_plain(inp)
    assert torch.equal(t, tp) and torch.equal(ids, idp)
    assert (CK.counters.launches, CK.counters.candidates_launches) == (0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        CK.candidates_cuda(*args, tile=False)
    # any other device is refused, never computed somewhere else
    with pytest.raises(ValueError, match="unsupported device"):
        CK.closest_hit(_inputs_to(inp, "meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        CK.candidates(*[x.to("meta") if torch.is_tensor(x) else x
                        for x in args], tile=False)
    with pytest.raises(ValueError, match="inv"):
        CK.candidates(args[0], inp.inv.double(), *args[2:], tile=True)
    with pytest.raises(ValueError, match="chunk_valid"):
        CK.candidates(*args[:4], cv.int(), T, tile=False)
    with pytest.raises(ValueError, match="contiguous"):
        CK.candidates(args[0].t().contiguous().t(), *args[1:], tile=True)
    with pytest.raises(ValueError, match="tiles"):
        CK.candidates(*args[:5], T + 1, tile=False)
    with pytest.raises(TypeError):
        CK.candidates(*args)                  # tile= is required
    with pytest.raises(ValueError, match="coef"):
        CK.closest_hit(inp._replace(coef=inp.coef.double()))


def _inputs_to(inp, device):
    return inp._replace(**{k: v.to(device) for k, v in inp._asdict().items()
                           if torch.is_tensor(v)})

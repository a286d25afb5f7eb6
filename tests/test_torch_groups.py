"""The oracle's last options in the port against the JAX package, on numpy
inputs from a seed: two-level candidate groups (`group`), `t_min`, meshes
above the prepass kernel's box limit (`_auto_group`), the keywords
`get_intersect_fn` passes through, `intersect_brute`'s `t_min`,
`ray_chunk` and `tri_chunk`, `primary_visibility(detach_depth=False)` and
`sobolev_solve(x0=)`.

Hits: the port's plain path (what the "cuda" backend runs on CPU tensors)
against `intersect_pallas` in interpret mode and against the brute oracle
with the same t_min. tri_id may differ on at most 2 rays per 1,024 (ties
at a shared edge: the visit order changes with the group, and the tie rule
is strict `<` across chunks); t to rtol 1e-5 / atol 1e-4
(tests/test_pallas.py). Candidate lists: equal to JAX's, in order."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drt_tpu.mesh as JMESH
import drt_tpu.optimize.precondition as JP
import drt_tpu.render.camera as JCAM
import drt_tpu.render.silhouette as JSIL
import drt_tpu_torch.intersect.cuda_kernel as CK
import drt_tpu_torch.optimize.precondition as TP
import drt_tpu_torch.render.camera as TCAM
import drt_tpu_torch.render.silhouette as TSIL
from drt_tpu.intersect import get_intersect_fn as j_get_fn
from drt_tpu.intersect.brute import intersect_brute as j_brute
from drt_tpu.intersect.culled import _chunk_aabbs as j_chunk_aabbs
from drt_tpu.intersect.pallas_kernel import _candidates as j_candidates
from drt_tpu.intersect.pallas_kernel import \
    _candidates_tile as j_candidates_tile
from drt_tpu.intersect.pallas_kernel import intersect_pallas
from drt_tpu_torch.convert import mesh_state_from_arrays
from drt_tpu_torch.data.synthetic import intrinsics, look_at_extrinsic
from drt_tpu_torch.intersect import get_intersect_fn, intersect_brute
from tests.meshes import make_cube, make_icosphere
from tests.test_culled import scene_rays
from tests.test_torch_precondition import _both, _close

# The test workers run side by side on few cores: torch's intra-op pool at
# its default size oversubscribes them and slows every worker down.
torch.set_num_threads(min(2, torch.get_num_threads()))

FIELDS = ("vertices", "faces", "face_valid", "vert_valid", "edges",
          "edge_valid", "edge_faces", "neighbors", "neighbor_valid",
          "normals", "mean_len")
# The icosphere has 16 chunks of 128 faces, the cube 2 (of 256 padded
# faces): groups 4 and 16 do not divide the cube's chunks. A t_min of 150
# lies between the near and the far side for rays from scene_rays' orbit of
# 170, so it moves most hits to the far side.
MESHES = {"icosphere": lambda: make_icosphere(subdivisions=3, radius=50.0),
          "cube": lambda: make_cube(size=80.0)}
GROUPS = (1, 2, 4, 16)
T_MIN = (0.0, 150.0)


@functools.lru_cache(maxsize=None)
def _meshes(name):
    v, f = MESHES[name]()
    jms = JMESH.build_mesh_state(v, f)
    d = {k: np.asarray(getattr(jms, k)) for k in FIELDS}
    d.update(num_vertices=jms.num_vertices, num_faces=jms.num_faces,
             num_edges=jms.num_edges)
    return jms, mesh_state_from_arrays(d, "cpu")


@functools.lru_cache(maxsize=None)
def _rays(n=1024, seed=21):
    o, d = scene_rays(n, seed=seed)
    return np.array(o), np.array(d)


@functools.lru_cache(maxsize=None)
def _jax_brute(name, t_min):
    jms, _ = _meshes(name)
    o, d = _rays()
    h = j_brute(jnp.asarray(o), jnp.asarray(d), jms.vertices, jms.faces,
                jms.face_valid, t_min=t_min)
    return np.asarray(h.t), np.asarray(h.tri_id)


def assert_hits_close(ref_t, ref_id, t, ids):
    n = len(ref_id)
    assert (ref_id != ids).sum() <= max(1, 2 * n // 1024), \
        (ref_id != ids).sum()
    both = (ref_id >= 0) & (ids >= 0)
    assert both.sum() > n // 10
    np.testing.assert_allclose(t[both], ref_t[both], rtol=1e-5, atol=1e-4)


def _port(tms, o, d, **kw):
    h = CK.intersect_cuda(torch.from_numpy(o), torch.from_numpy(d),
                          tms.vertices, tms.faces, tms.face_valid, **kw)
    return h.t.numpy(), h.tri_id.numpy()


@pytest.mark.parametrize("t_min", T_MIN)
@pytest.mark.parametrize("mode", ["ray", "tile"])
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_grouped_oracle_matches_jax_pallas_and_brute(mesh, group, mode,
                                                     t_min):
    """intersect_cuda(group=, t_min=) on CPU tensors against intersect_pallas
    with the same group, t_min and prepass (the port's prepass follows
    `coherent`: tile for coherent queries), against the brute oracle with
    the same t_min, and against its own group-1 hits."""
    jms, tms = _meshes(mesh)
    o, d = _rays()
    hp = intersect_pallas(jnp.asarray(o), jnp.asarray(d), jms.vertices,
                          jms.faces, jms.face_valid, t_min=t_min,
                          ray_tile=128, tri_chunk=128, prepass=mode,
                          group=group, interpret=True)
    kw = dict(coherent=mode == "tile", t_min=t_min)
    t, ids = _port(tms, o, d, group=group, **kw)
    assert_hits_close(np.asarray(hp.t), np.asarray(hp.tri_id), t, ids)
    assert_hits_close(*_jax_brute(mesh, t_min), t, ids)
    assert (t[ids >= 0] > t_min).all()
    t1, ids1 = _port(tms, o, d, group=1, **kw)
    assert_hits_close(t1, ids1, t, ids)
    if t_min:            # the far side: t_min changed the answer
        t0, _ = _port(tms, o, d, group=group, coherent=mode == "tile")
        hit = (ids >= 0) & np.isfinite(t0)
        assert (t[hit] > t0[hit]).mean() > 0.5


def _jax_group_boxes(lo_c, hi_c, chunk_valid, group):
    """intersect_pallas's group boxes (pallas_kernel.py:455-469), its own
    code on its own chunk boxes."""
    NC = lo_c.shape[0]
    NCg = -(-NC // group) * group
    padc = NCg - NC
    if padc:
        lo_c = jnp.pad(lo_c, ((0, padc), (0, 0)), constant_values=jnp.inf)
        hi_c = jnp.pad(hi_c, ((0, padc), (0, 0)), constant_values=jnp.inf)
        chunk_valid = jnp.pad(chunk_valid, (0, padc))
    lo_m = jnp.where(chunk_valid[:, None], lo_c, jnp.inf)
    hi_m = jnp.where(chunk_valid[:, None], hi_c, -jnp.inf)
    return (lo_m.reshape(NCg // group, group, 3).min(axis=1),
            hi_m.reshape(NCg // group, group, 3).max(axis=1),
            chunk_valid.reshape(NCg // group, group).any(axis=1))


@pytest.mark.parametrize("t_min", T_MIN)
@pytest.mark.parametrize("mode", ["ray", "tile"])
@pytest.mark.parametrize("group", GROUPS)
def test_grouped_prepass_lists_equal_jax(group, mode, t_min):
    """The lists and counts `prepare_inputs` builds over the group boxes
    equal JAX's `_candidates` / `_candidates_tile` on JAX's own group boxes,
    in order; the port's group boxes are JAX's."""
    jms, tms = _meshes("icosphere")
    o, d = _rays(512, seed=13)
    coherent = mode == "tile"
    inp = CK.prepare_inputs(torch.from_numpy(o), torch.from_numpy(d),
                            tms.vertices, tms.faces, tms.face_valid,
                            coherent=coherent, group=group, t_min=t_min)
    assert inp.group == group and inp.t_min == t_min
    T = inp.count.shape[0]
    RT = inp.phi.shape[1] // T
    assert RT == (CK.RAY_TILE_COHERENT if coherent
                  else CK.RAY_TILE_INCOHERENT)
    shift = o.mean(0)
    ot = (o - shift).reshape(T, RT, 3).transpose(0, 2, 1)
    dt = d.reshape(T, RT, 3).transpose(0, 2, 1)
    jlo, jhi, jcv = j_chunk_aabbs(jms.vertices, jms.faces, jms.face_valid,
                                  jnp.asarray(shift), 128)
    jlo_p, jhi_p, jcv_p = _jax_group_boxes(jlo, jhi, jcv, group)
    lo, hi, cv = CK._chunk_aabbs(tms.vertices, tms.faces, tms.face_valid,
                                 torch.from_numpy(shift), 128)
    if group > 1:
        _, _, (lo_p, hi_p, cv_p) = CK._grouped_boxes(lo, hi, cv, group)
        np.testing.assert_array_equal(lo_p.numpy(), np.asarray(jlo_p))
        np.testing.assert_array_equal(hi_p.numpy(), np.asarray(jhi_p))
        np.testing.assert_array_equal(cv_p.numpy(), np.asarray(jcv_p))
    j_fn = j_candidates_tile if coherent else j_candidates
    jc, jn = j_fn(jnp.asarray(ot), jnp.asarray(dt), jlo_p, jhi_p, jcv_p,
                  t_min)
    NG = jlo_p.shape[0]
    assert inp.cand.shape == (T, NG)
    np.testing.assert_array_equal(inp.count.numpy(), np.asarray(jn)[:, 0])
    np.testing.assert_array_equal(inp.cand.numpy(),
                                  np.asarray(jc)[:, 0, :NG])
    assert int(inp.count.max()) > 0


@pytest.mark.parametrize("nc,want", [
    (1, 1), (CK.MAX_CHUNKS - 1, 1), (CK.MAX_CHUNKS, 1),
    (CK.MAX_CHUNKS + 1, 2), (2 * CK.MAX_CHUNKS, 2),
    (2 * CK.MAX_CHUNKS + 1, 4), (19_481, 2), (41_284, 4),
    (16 * CK.MAX_CHUNKS, 16)])
def test_auto_group_at_and_around_the_cap(nc, want):
    """The least power of two that brings ceil(nc / g) to MAX_CHUNKS;
    19,481 and 41,284 chunks are dog_mid45k and dog_mid90k subdivided."""
    g = CK._auto_group(nc)
    assert g == want
    assert -(-nc // g) <= CK.MAX_CHUNKS
    assert g == 1 or -(-nc // (g // 2)) > CK.MAX_CHUNKS
    g3 = CK._auto_group(nc, limit=3)
    assert -(-nc // g3) <= 3 and (g3 == 1 or -(-nc // (g3 // 2)) > 3)


def test_group_none_groups_meshes_above_the_cap(monkeypatch):
    """With GROUP_INCOHERENT at 1 group=None is 1 below the cap and the
    auto group above it: with the cap lowered to 3 boxes the icosphere's 16
    chunks take groups of 8, and the hits are the group-1 hits."""
    monkeypatch.setattr(CK, "GROUP_INCOHERENT", 1)
    jms, tms = _meshes("icosphere")
    o, d = _rays()
    args = (torch.from_numpy(o), torch.from_numpy(d), tms.vertices,
            tms.faces, tms.face_valid)
    assert CK.prepare_inputs(*args, coherent=False).group == 1
    t1, ids1 = _port(tms, o, d, coherent=False, group=1)
    monkeypatch.setattr(CK, "MAX_CHUNKS", 3)
    inp = CK.prepare_inputs(*args, coherent=False)
    assert inp.group == 8 and inp.cand.shape[1] == 2
    t, ids = _port(tms, o, d, coherent=False)
    assert_hits_close(t1, ids1, t, ids)
    with pytest.raises(ValueError, match="at most MAX_CHUNKS"):
        CK.candidates_cuda(inp.phi[6:9], inp.inv, inp.lo, inp.hi,
                           torch.ones(16, dtype=torch.bool),
                           inp.count.shape[0], tile=False)


def test_group_none_takes_the_incoherent_constant(monkeypatch):
    """group=None: GROUP_INCOHERENT (4) for an incoherent query, 1 for a
    coherent one, GROUP_ONE_ORIGIN (1) for a one-origin one, and the auto
    group wherever that is larger; no file is read for it."""
    _, tms = _meshes("icosphere")
    o, d = (torch.from_numpy(x) for x in _rays(256))
    geom = (tms.vertices, tms.faces, tms.face_valid)
    assert CK.GROUP_INCOHERENT == 4 and CK.GROUP_ONE_ORIGIN == 1

    def group(coherent, cap=CK.MAX_CHUNKS, origins=o):
        with monkeypatch.context() as m:
            m.setattr(CK, "MAX_CHUNKS", cap)
            return CK.prepare_inputs(origins, d, *geom,
                                     coherent=coherent).group

    assert group(False) == 4 and group(True) == 1
    assert group(False, origins=o[:1].expand(o.shape)) == 1
    assert tms.faces.shape[0] == 2048              # 16 chunks
    assert group(False, cap=2) == 8                # the cap needs more
    assert group(True, cap=2) == 8
    assert group(False, cap=8) == 4                # the cap needs 2
    assert group(False, cap=2, origins=o[:1].expand(o.shape)) == 8


def test_group_padding_boxes_are_never_entered():
    """Every chunk without a valid face (the cube's second chunk, and the
    chunks that pad it to a group of 16) gets the box +inf and zero
    coefficients; its list entries visit nothing."""
    _, tms = _meshes("cube")
    o, d = _rays()
    inp = CK.prepare_inputs(torch.from_numpy(o), torch.from_numpy(d),
                            tms.vertices, tms.faces, tms.face_valid,
                            coherent=False, group=16)
    assert inp.coef.shape[0] == 16 and inp.lo.shape == (16, 3)
    assert torch.isinf(inp.lo[1:]).all() and torch.isinf(inp.hi[1:]).all()
    assert not inp.coef[1:].any()
    cand, count = CK.chunk_lists(inp)
    assert torch.equal(count, inp.count * 16)
    assert torch.equal(cand[:, :16], torch.arange(16).expand(len(cand), 16)
                       .int())
    o3 = inp.phi[6:9]
    for c in range(1, 16):
        t1 = (inp.lo[c][:, None] - o3) * inp.inv
        t2 = (inp.hi[c][:, None] - o3) * inp.inv
        entry = torch.minimum(t1, t2).amax(0)
        exit_ = torch.maximum(t1, t2).amin(0)
        assert not ((entry <= exit_) & (exit_ > 0) & (entry < np.inf)).any()


def test_zero_t_min_product_is_the_old_test():
    """At t_min = 0 the hit test td*s > t_min*|det| is td*s > 0 for every
    finite |det|: 0*|det| is +0, and -0 > +0 is as false as -0 > 0."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=1000) * 10.0 ** rng.integers(
        -40, 38, 1000), [0.0, -0.0, 1e-45, -1e-45, 3e38, -3e38]])
    td = torch.tensor(x, dtype=torch.float32)
    absdet = torch.tensor(np.abs(x[::-1]).copy(), dtype=torch.float32)
    prod = 0.0 * absdet
    assert torch.equal(prod, torch.zeros_like(prod))
    assert not torch.signbit(prod).any()
    assert torch.equal(td > prod, td > 0.0)


@pytest.mark.parametrize("t_min", T_MIN)
def test_get_intersect_fn_passes_keywords_through(monkeypatch, t_min):
    """Keywords of get_intersect_fn reach the backend on every query, on
    both incoherent routes (which stay equal bit for bit), and the brute
    backend takes t_min too."""
    _, tms = _meshes("icosphere")
    o, d = (torch.from_numpy(x) for x in _rays())
    geom = (tms.vertices, tms.faces, tms.face_valid)
    seen = []
    real = CK.prepare_inputs

    def spy(*a, **kw):
        seen.append((kw["group"], kw["t_min"]))
        return real(*a, **kw)

    monkeypatch.setattr(CK, "prepare_inputs", spy)
    want = {}
    for coherent in (True, False):
        want[coherent] = CK.intersect_cuda(o, d, *geom, coherent=coherent,
                                           group=4, t_min=t_min)
    for incoherent in ("ray", "resort"):
        fn = get_intersect_fn("cuda", incoherent=incoherent, group=4,
                              t_min=t_min)
        for coherent in (True, False):
            h = fn(o, d, *geom, coherent=coherent)
            assert torch.equal(h.t, want[coherent].t)
            assert torch.equal(h.tri_id, want[coherent].tri_id)
    assert seen == [(4, t_min)] * 6
    hb = get_intersect_fn("brute", t_min=t_min)(o, d, *geom, coherent=False)
    jt, jid = _jax_brute("icosphere", t_min)
    assert_hits_close(jt, jid, hb.t.numpy(), hb.tri_id.numpy())
    with pytest.raises(TypeError):
        get_intersect_fn("brute", group=4)(o, d, *geom, coherent=False)


@pytest.mark.parametrize("t_min", T_MIN)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_intersect_brute_keywords_match_jax(mesh, t_min):
    """intersect_brute(t_min=, ray_chunk=, tri_chunk=) against JAX's with
    the same keywords; the blocks do not change the hits."""
    jms, tms = _meshes(mesh)
    o, d = _rays()
    kw = dict(t_min=t_min, ray_chunk=200, tri_chunk=64)
    jh = j_brute(jnp.asarray(o), jnp.asarray(d), jms.vertices, jms.faces,
                 jms.face_valid, **kw)
    th = intersect_brute(torch.from_numpy(o), torch.from_numpy(d),
                         tms.vertices, tms.faces, tms.face_valid, **kw)
    assert_hits_close(np.asarray(jh.t), np.asarray(jh.tri_id),
                      th.t.numpy(), th.tri_id.numpy())
    whole = intersect_brute(torch.from_numpy(o), torch.from_numpy(d),
                            tms.vertices, tms.faces, tms.face_valid,
                            t_min=t_min)
    assert torch.equal(whole.tri_id, th.tri_id)
    assert torch.equal(whole.t, th.t)


def _vis_setup():
    """A rotated float64 icosphere (its edges off the pixel columns) and a
    camera on a ring, in both packages."""
    v, f = make_icosphere(subdivisions=3, radius=50.0)
    q, _ = np.linalg.qr(np.random.default_rng(4).standard_normal((3, 3)))
    v = v @ q.T
    pos = 175.0 * np.array([np.cos(0.7), np.sin(0.7), 0.2])
    R = look_at_extrinsic(pos, np.zeros(3))
    K = intrinsics(24, 32)
    cam_np = [R, K, np.linalg.inv(R), np.linalg.inv(K)]
    with jax.enable_x64(True):
        jms = JMESH.build_mesh_state(v, f, dtype=jnp.float64)
        d = {k: np.asarray(getattr(jms, k)) for k in FIELDS}
    d.update(num_vertices=jms.num_vertices, num_faces=jms.num_faces,
             num_edges=jms.num_edges)
    return d, cam_np


@pytest.mark.parametrize("detach_depth", [False, True])
def test_primary_visibility_detach_depth_matches_jax(detach_depth):
    """The samples' output and its gradient in the vertices (float64,
    rtol 1e-9) with and without the camera depth detached; the two
    gradients differ, so the keyword reaches the projection."""
    mesh, cam_np = _vis_setup()
    budget = 512
    w = np.random.default_rng(5).normal(size=budget)
    with jax.enable_x64(True):
        jms = JMESH.build_mesh_state(
            mesh["vertices"][:mesh["num_vertices"]],
            mesh["faces"][:mesh["num_faces"]], dtype=jnp.float64)
        jcam = JCAM.CameraM(*[jnp.asarray(c) for c in cam_np])
        origin = jnp.asarray(cam_np[2][:3, 3])

        def jf(v, detach):
            s = JSIL.primary_visibility(
                jms.with_vertices(v), jcam, origin, j_get_fn("brute"),
                budget, 24, 32, detach_depth=detach)
            return jnp.sum(jnp.where(s.valid, s.output * w, 0.0)), s

        (_, js), jg = jax.value_and_grad(jf, has_aux=True)(
            jms.vertices, detach_depth)
        jg_other = jax.grad(lambda v: jf(v, not detach_depth)[0])(
            jms.vertices)
    tms = mesh_state_from_arrays(mesh, "cpu")
    tcam = TCAM.CameraM(*[torch.tensor(c) for c in cam_np])
    v = tms.vertices.clone().requires_grad_(True)
    ts = TSIL.primary_visibility(
        tms.with_vertices(v), tcam, torch.tensor(cam_np[2][:3, 3]),
        get_intersect_fn("auto"), budget, 24, 32, detach_depth=detach_depth)
    assert int(ts.valid.sum()) > 20
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_allclose(ts.output.detach().numpy(),
                               np.asarray(js.output), rtol=1e-9, atol=1e-12)
    loss = torch.where(ts.valid, ts.output * torch.tensor(w), 0.0).sum()
    (tg,) = torch.autograd.grad(loss, v)
    scale = float(np.abs(np.asarray(jg)).max())
    assert scale > 0
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-9,
                               atol=1e-9 * scale)
    assert float(np.abs(np.asarray(jg) - np.asarray(jg_other)).max()) \
        > 1e-6 * scale


@pytest.mark.parametrize("maxiter,tol", [(5, 1e-10), (200, 1e-6)])
def test_sobolev_solve_warm_start_matches_jax(maxiter, tol):
    """sobolev_solve(x0=) against JAX's cg warm start, value and gradient
    (float64, rtol 1e-9, atol 1e-9 of the largest entry, as
    tests/test_torch_precondition.py holds the cold start): JAX hands x0 to the transpose solve too, so the
    cotangent's solve starts there as well, and x0 takes no gradient."""
    jms, tms = _both("icosphere")
    rng = np.random.default_rng(6)
    shape = tuple(tms.vertices.shape)
    u, w = rng.normal(size=shape), rng.normal(size=shape)
    x0 = u / 40.0 + 0.1 * rng.normal(size=shape)
    lam = 29.0
    with jax.enable_x64(True):
        def jf(u_):
            v = JP.sobolev_solve(u_, jms.neighbors, jms.neighbor_valid, lam,
                                 maxiter=maxiter, tol=tol,
                                 x0=jnp.asarray(x0))
            return jnp.sum(v * jnp.asarray(w)), v
        (_, jv), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(u))
    tu = torch.tensor(u, requires_grad=True)
    tx0 = torch.tensor(x0, requires_grad=True)
    tv = TP.sobolev_solve(tu, tms.neighbors, tms.neighbor_valid, lam,
                          maxiter=maxiter, tol=tol, x0=tx0)
    tg, gx0 = torch.autograd.grad((tv * torch.tensor(w)).sum(), (tu, tx0),
                                  allow_unused=True)
    _close(tv, jv, 1e-9)
    _close(tg, jg, 1e-9)
    assert gx0 is None
    cold = TP.sobolev_solve(tu.detach(), tms.neighbors, tms.neighbor_valid,
                            lam, maxiter=maxiter, tol=tol)
    assert not torch.equal(cold, tv.detach())

"""The oracle's other routes against the JAX package, on the CPU: the
`culled` backend against drt_tpu's `intersect_culled` and both brute oracles
(tri_id equal but for at most 2 ties per 1,024 rays that either side hits, t
at rtol 1e-5 / atol 1e-4) on the icosphere, the cube and dog_mid20k, with
coherent rays and with parked and unnormalised incoherent rays; `morton_keys`
equal as integers; the resorted route equal to the direct call bit for bit;
and the `incoherent=` selection of `get_intersect_fn`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drt_tpu_torch.intersect.cuda_kernel as CK
from drt_tpu.intersect.brute import intersect_brute as j_brute
from drt_tpu.intersect.culled import intersect_culled as j_culled
from drt_tpu.intersect.resort import morton_keys as j_morton_keys
from drt_tpu.intersect.resort import resorted_intersect as j_resorted
from drt_tpu_torch.intersect import (get_intersect_fn, intersect_brute,
                                     intersect_culled)
from drt_tpu_torch.intersect.resort import (_spread3, morton_keys,
                                            resorted_intersect)
from tests.test_torch_intersect import (_count_differences, _mesh_rays,
                                        mesh_pair)  # noqa: F401

# The test workers run side by side on few cores: torch's intra-op pool at
# its default size oversubscribes them and slows every worker down.
torch.set_num_threads(min(2, torch.get_num_threads()))

# small tiles and groups keep the [G,R,K*C,4] products of a wave small
KW = dict(ray_tile=64, tri_chunk=128, max_chunks=4, tile_group=4)


@pytest.mark.parametrize("kind", ["camera", "inside"])
def test_culled_matches_jax_culled_and_brute(mesh_pair, kind):  # noqa: F811
    name, v, jms, tms = mesh_pair
    o, d = _mesh_rays(v, kind)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    h = intersect_culled(to, td, tms.vertices, tms.faces, tms.face_valid,
                         **KW)
    assert h.t.dtype == torch.float32 and h.tri_id.dtype == torch.int32
    t, ids = h.t.numpy(), h.tri_id.numpy()
    hj = j_culled(jnp.asarray(o), jnp.asarray(d), jms.vertices, jms.faces,
                  jms.face_valid, **KW)
    _count_differences(f"{name} {kind} vs drt_tpu culled", np.asarray(hj.t),
                       np.asarray(hj.tri_id), t, ids)
    hb = intersect_brute(to, td, tms.vertices, tms.faces, tms.face_valid)
    _count_differences(f"{name} {kind} vs brute", hb.t.numpy(),
                       hb.tri_id.numpy(), t, ids)
    hjb = j_brute(jnp.asarray(o), jnp.asarray(d), jms.vertices, jms.faces,
                  jms.face_valid)
    _count_differences(f"{name} {kind} vs drt_tpu brute", np.asarray(hjb.t),
                       np.asarray(hjb.tri_id), t, ids)
    if kind == "inside":                      # parked lanes hit nothing
        assert (ids[::7] == -1).all() and np.isinf(t[::7]).all()
    # default keywords (tiles of 256, chunks of 256, waves of 8) agree too
    h2 = intersect_culled(to, td, tms.vertices, tms.faces, tms.face_valid)
    _count_differences(f"{name} {kind} default vs small tiles", t, ids,
                       h2.t.numpy(), h2.tri_id.numpy())


def test_culled_t_min_and_backend_selection(mesh_pair):  # noqa: F811
    name, v, jms, tms = mesh_pair
    o, d = _mesh_rays(v, "camera", n=64)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    h0 = intersect_culled(to, td, tms.vertices, tms.faces, tms.face_valid)
    hit = h0.hit
    assert bool(hit.any())
    # t_min just past the first hit: every such ray now reports a farther
    # hit (the mesh is closed), as the JAX package's does
    t_min = float(h0.t[hit].max()) * 1.0001
    h1 = intersect_culled(to, td, tms.vertices, tms.faces, tms.face_valid,
                          t_min=t_min)
    hj = j_culled(jnp.asarray(o), jnp.asarray(d), jms.vertices, jms.faces,
                  jms.face_valid, t_min=t_min)
    assert bool((h1.t[h1.hit] > t_min).all())
    np.testing.assert_array_equal(h1.tri_id.numpy(), np.asarray(hj.tri_id))
    fn = get_intersect_fn("culled")
    v_req = tms.vertices.clone().requires_grad_(True)
    for coherent in (True, False):            # accepted and ignored
        h = fn(to, td, v_req, tms.faces, tms.face_valid, coherent=coherent)
        assert torch.equal(h.tri_id, h0.tri_id) and torch.equal(h.t, h0.t)
        assert not h.t.requires_grad
    with pytest.raises(ValueError):
        get_intersect_fn("pallas")
    with pytest.raises(ValueError):
        get_intersect_fn("cuda", incoherent="sometimes")


def test_morton_keys_equal_as_integers(mesh_pair):  # noqa: F811
    name, v, _jms, _tms = mesh_pair
    x = np.arange(0, 1 << 12, 37, dtype=np.int32)
    np.testing.assert_array_equal(
        _spread3(torch.from_numpy(x)).numpy(),
        np.asarray(__import__("drt_tpu.intersect.resort", fromlist=["x"])
                   ._spread3(jnp.asarray(x))))
    for kind in ("camera", "inside"):
        o, d = _mesh_rays(v, kind, n=1024)
        k = morton_keys(torch.from_numpy(o), torch.from_numpy(d))
        assert k.dtype == torch.int32
        kj = np.asarray(j_morton_keys(jnp.asarray(o), jnp.asarray(d)))
        np.testing.assert_array_equal(k.numpy(), kj)
        assert int(k.min()) >= 0 and len(np.unique(kj >> 27)) > (
            1 if kind == "inside" else 0)


def test_resorted_route_equals_direct_call(mesh_pair):  # noqa: F811
    """Hits are per ray and the oracle gates work per ray, so sorting the
    rays, taking the tile prepass and scattering back changes no bit; the
    permutation is the JAX package's (a stable sort of equal keys)."""
    name, v, jms, tms = mesh_pair
    # not a multiple of a tile; fewer rays on the dog, where the plain
    # oracle walks 256 chunks
    n = 300 if name == "dog_mid20k" else 1000
    o, d = _mesh_rays(v, "inside", n=n)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    geom = (tms.vertices, tms.faces, tms.face_valid)
    ray = get_intersect_fn("cuda", incoherent="ray")
    res = get_intersect_fn("cuda", incoherent="resort")
    CK.counters.reset()
    h_ray = ray(to, td, *geom, coherent=False)
    h_res = res(to, td, *geom, coherent=False)
    assert CK.counters.calls == 2
    assert int(h_ray.hit.sum()) > 0.3 * n
    assert torch.equal(h_ray.tri_id, h_res.tri_id)
    assert torch.equal(h_ray.t, h_res.t)
    # coherent queries never take the sort
    assert torch.equal(res(to, td, *geom, coherent=True).tri_id,
                       ray(to, td, *geom, coherent=True).tri_id)

    seen = {}

    def probe(oo, dd, vv, ff, fv, **kw):
        seen["o"], seen["kw"] = oo, kw
        return CK.intersect_cuda(oo, dd, vv, ff, fv, **kw)
    h = resorted_intersect(probe, to, td, *geom, coherent=True)
    assert seen["kw"] == {"coherent": True}
    # without the unsorted query's shift the ids still agree; t may differ
    # in its last bits (the mean origin summed in the sorted order)
    assert torch.equal(h.tri_id, h_ray.tri_id)
    np.testing.assert_allclose(h.t.numpy(), h_ray.t.numpy(), rtol=1e-5)

    def j_probe(oo, dd, vv, ff, fv):
        seen["jo"] = np.asarray(oo)
        return j_brute(oo, dd, vv, ff, fv)
    j_resorted(j_probe, jnp.asarray(o), jnp.asarray(d), jms.vertices,
               jms.faces, jms.face_valid)
    np.testing.assert_array_equal(seen["o"].numpy(), seen["jo"])


def test_auto_route_is_the_ray_route(monkeypatch):
    """`incoherent="auto"` takes the exact per-ray route at every mesh size
    (icospheres of 80 to 5,120 faces), reading no file: with every open of
    a path under reports/ refused and the resorted route unreachable, its
    hits are the "ray" route's, bit for bit."""
    import builtins

    from drt_tpu_torch.intersect import resort
    from drt_tpu_torch.mesh import build_mesh_state
    from tests.meshes import make_icosphere
    real_open = builtins.open

    def no_reports(path, *a, **k):
        if "reports" in str(path).replace("\\", "/").split("/"):
            raise OSError(f"reports/ is unreadable: {path}")
        return real_open(path, *a, **k)
    monkeypatch.setattr(builtins, "open", no_reports)
    fn_auto = get_intersect_fn("cuda")
    fn_ray = get_intersect_fn("cuda", incoherent="ray")

    def no_resort(*a, **k):
        raise AssertionError("the auto route took the resorted route")
    monkeypatch.setattr(resort, "resorted_intersect", no_resort)
    for subdivisions in (1, 2, 3, 4):
        v, f = make_icosphere(subdivisions)
        ms = build_mesh_state(v, f, device="cpu")
        o, d = (torch.from_numpy(x) for x in _mesh_rays(np.asarray(v),
                                                        "inside"))
        geom = (ms.vertices, ms.faces, ms.face_valid)
        h = fn_auto(o, d, *geom, coherent=False)
        h_ray = fn_ray(o, d, *geom, coherent=False)
        assert torch.equal(h.tri_id, h_ray.tri_id)
        assert torch.equal(h.t, h_ray.t)
        assert int(h.hit.sum()) > 0

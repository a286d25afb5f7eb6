"""drt_tpu_torch.render against drt_tpu.render on the same numpy rays:
render_transparent's valid mask, every stats counter and the hit face ids
equal, exit rays allclose (float32: atol 2e-5, a few ulps of ~100-unit
coordinates); the ray-loss vertex gradient allclose in float64 with
compat=True (rtol 1e-7); zero ray loss at the ground truth of a capture the
port synthesized; and the port's synthetic capture against the JAX one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drt_tpu.mesh as JMESH
from drt_tpu.data.synthetic import synthesize_capture as j_synth
from drt_tpu.intersect import get_intersect_fn as j_get_fn
from drt_tpu.optimize.losses import ray_loss as j_ray_loss
from drt_tpu.render.camera import CameraM as JCam
from drt_tpu.render.trace import render_transparent as j_render
from drt_tpu_torch.convert import mesh_state_from_arrays
from drt_tpu_torch.data.synthetic import synthesize_capture as t_synth
from drt_tpu_torch.intersect import get_intersect_fn as t_get_fn
from drt_tpu_torch.optimize.losses import ray_loss as t_ray_loss
from drt_tpu_torch.render.camera import CameraM as TCam
from drt_tpu_torch.render.trace import render_transparent as t_render
from tests.meshes import make_icosphere

# The test workers run side by side on few cores: torch's intra-op pool at
# its default size oversubscribes them and slows every worker down.
torch.set_num_threads(min(2, torch.get_num_threads()))

IOR, EXT = 1.4723, 1.00029
FIELDS = ("vertices", "faces", "face_valid", "vert_valid", "edges",
          "edge_valid", "edge_faces", "neighbors", "neighbor_valid",
          "normals", "mean_len")


def to_port(jms):
    d = {k: np.asarray(getattr(jms, k)) for k in FIELDS}
    d.update(num_vertices=jms.num_vertices, num_faces=jms.num_faces,
             num_edges=jms.num_edges)
    return mesh_state_from_arrays(d, "cpu")


def bundle(n_side=24, seed=7, scale=1.0, center=(37.0, -12.0, 55.0)):
    """Camera rays through a sphere's bulk (most refract twice)."""
    rng = np.random.default_rng(seed)
    cam = np.array([400.0, 150.0, 300.0]) * scale
    tgt = np.asarray(center) + rng.normal(
        scale=45.0 * scale, size=(n_side * n_side, 3))
    d = tgt - cam
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(cam, d.shape).copy()
    sp = tgt + 3.0 * (tgt - cam) + rng.normal(scale=5.0, size=tgt.shape)
    return o, d, sp


def sphere(dtype, radius=100.0, center=(37.0, -12.0, 55.0)):
    v, f = make_icosphere(subdivisions=3, radius=radius, center=center)
    return JMESH.build_mesh_state(v, f, dtype=dtype)


def test_render_transparent_matches_jax():
    jms = sphere(jnp.float32)
    tms = to_port(jms)
    o, d, _ = bundle()
    o, d = o.astype(np.float32), d.astype(np.float32)
    jr = jax.jit(lambda o, d, ms: j_render(o, d, ms, j_get_fn("brute"),
                                           IOR, EXT))(
        jnp.asarray(o), jnp.asarray(d), jms)
    tr = t_render(torch.from_numpy(o), torch.from_numpy(d), tms,
                  t_get_fn("auto"), IOR, EXT)
    np.testing.assert_array_equal(tr.valid.numpy(), np.asarray(jr.valid))
    assert tr.valid.sum() > 100
    assert set(tr.stats) == set(jr.stats)
    for k in jr.stats:
        assert int(tr.stats[k]) == int(jr.stats[k]), k
    for jt, tt in zip(jr.tris, tr.tris):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tr.direction.numpy(), np.asarray(jr.direction),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(tr.origin.numpy(), np.asarray(jr.origin),
                               rtol=0, atol=2e-4)


def _view(o, d, sp, cam_np, lib, dtype):
    """(screen_pixel, valid, mask, origin, ray_dir, cam) for ray_loss."""
    n = o.shape[0]
    if lib == "jax":
        a = lambda x: jnp.asarray(x, dtype)  # noqa: E731
        cam = JCam(*[a(c) for c in cam_np])
        return (a(sp), jnp.ones(n, bool), a(np.zeros((2, 2))), a(o), a(d),
                cam)
    t = lambda x: torch.tensor(x, dtype=dtype)  # noqa: E731
    cam = TCam(*[t(c) for c in cam_np])
    return (t(sp), torch.ones(n, dtype=torch.bool), t(np.zeros((2, 2))),
            t(o), t(d), cam)


@pytest.mark.parametrize("huber", [0.0, 0.05])
def test_ray_loss_grad_f64_compat_matches_jax(huber):
    # compat's absolute 1e-5 exit nudge must stay above float32 resolution
    # in the (float32) oracle, so this sphere lives at ~20-unit coordinates
    o, d, sp = bundle(n_side=20, seed=3, scale=0.2, center=(3.0, -2.0, 1.0))
    cam_np = [np.eye(4), np.eye(3), np.eye(4), np.eye(3)]
    with jax.enable_x64(True):
        jms = sphere(jnp.float64, radius=20.0, center=(3.0, -2.0, 1.0))
        tms = to_port(jms)
        assert tms.vertices.dtype == torch.float64
        jview = _view(o, d, sp, cam_np, "jax", jnp.float64)
        fn = j_get_fn("brute")

        def jl(v):
            return j_ray_loss(jms.with_vertices(v), jview, fn, IOR, EXT,
                              huber=huber, compat=True, ray_chunk=0,
                              collect_evidence=True)

        (jloss, jst), jg = jax.jit(jax.value_and_grad(jl, has_aux=True))(
            jms.vertices)
        jloss, jg = float(jloss), np.asarray(jg)
        jev = np.asarray(jst["vertex_evidence"])

    v = tms.vertices.clone().requires_grad_(True)
    tview = _view(o, d, sp, cam_np, "torch", torch.float64)
    tloss, tst = t_ray_loss(tms.with_vertices(v), tview, t_get_fn("auto"),
                            IOR, EXT, huber=huber, compat=True,
                            collect_evidence=True)
    (tg,) = torch.autograd.grad(tloss, v)
    assert int(tst["valid_rays"]) == int(jst["valid_rays"]) > 100
    np.testing.assert_array_equal(tst["vertex_evidence"].numpy(), jev)
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-7)
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-7,
                               atol=1e-7 * np.abs(jg).max())


@pytest.fixture(scope="module")
def captures():
    v, f = make_icosphere(subdivisions=3, radius=50.0)
    kw = dict(name="sphere", num_views=3, resy=24, resx=32, ior=1.5)
    return (v, f, t_synth(v, f, device="cpu", **kw),
            j_synth(v, f, backend="brute", **kw))


def test_synthetic_capture_matches_jax(captures):
    _, _, tc, jc = captures
    tv, jv = tc.views, jc.views
    n = tv.valid.numel()
    # the same pixels see through the glass (rare ties may flip one)
    assert (tv.valid.numpy() != np.asarray(jv.valid)).sum() <= 2 * n // 1024
    both = tv.valid.numpy() & np.asarray(jv.valid)
    # a ray whose tie flipped leaves through another face: count those
    sp_t, sp_j = tv.screen_pixel.numpy()[both], np.asarray(jv.screen_pixel)[both]
    far = ~np.isclose(sp_t, sp_j, rtol=1e-4, atol=1e-2).all(axis=1)
    assert far.sum() <= max(1, 2 * n // 1024), far.sum()
    assert (np.abs(tv.mask.numpy() - np.asarray(jv.mask)) > 1e-6).sum() \
        <= 2 * n // 1024
    for k in ("origin", "ray_dir", "R", "K", "R_inv", "K_inv"):
        np.testing.assert_allclose(getattr(tv, k).numpy(),
                                   np.asarray(getattr(jv, k)),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_ray_loss_zero_at_ground_truth(captures):
    v, f, tc, _ = captures
    from drt_tpu_torch.mesh import build_mesh_state
    ms = build_mesh_state(v, f, device="cpu")
    fn = t_get_fn("auto")
    for i in range(tc.num_views):
        sp, valid, _m, o, d, _c = view = tc.views.take(i)
        loss, st = t_ray_loss(ms, view, fn, 1.5, EXT)
        n = int(st["valid_rays"])
        assert n > 50
        # Per-ray residuals are at float32 resolution, except where a ray
        # crossing a shared edge picks the other face (the oracle's shift
        # depends on every lane's origin): at most 1% of the rays.
        res = t_render(o, d, ms, fn, 1.5, EXT, lane_mask=valid)
        from drt_tpu_torch.geometry.vec import safe_normalize
        r = ((res.direction - safe_normalize(sp - res.origin)) ** 2).sum(1)
        assert (r[res.valid] > 1e-8).sum() <= max(2, n // 100)
        assert float(loss) < 0.05 * n

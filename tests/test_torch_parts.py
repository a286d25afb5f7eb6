"""Smaller pieces of the port against the JAX package on the same inputs:
camera rays and projection (float64: rtol 1e-12), the silhouette-edge mask
and the edge sampler's forward (exact), limit_grad and the silhouette
budget (exact), the view generators and stack_views (exact), and the
copied soft-mask preprocessing (exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drt_tpu.data.masks as JMASK
import drt_tpu.data.views as JVIEWS
import drt_tpu.mesh as JMESH
import drt_tpu.optimize.loop as JLOOP
import drt_tpu.render.camera as JCAM
import drt_tpu.render.silhouette as JSIL
import drt_tpu_torch.data.masks as TMASK
import drt_tpu_torch.data.views as TVIEWS
import drt_tpu_torch.optimize.loop as TLOOP
import drt_tpu_torch.render.camera as TCAM
import drt_tpu_torch.render.silhouette as TSIL
from drt_tpu.data.synthetic import intrinsics as j_intrinsics
from drt_tpu.data.synthetic import look_at_extrinsic as j_look_at
from drt_tpu_torch.data.synthetic import intrinsics, look_at_extrinsic
from drt_tpu_torch.intersect import get_intersect_fn
from drt_tpu_torch.mesh import build_mesh_state
from tests.meshes import make_icosphere

# The test workers run side by side on few cores: torch's intra-op pool at
# its default size oversubscribes them and slows every worker down.
torch.set_num_threads(min(2, torch.get_num_threads()))

RES = (24, 32)


def _cam_np(i=0):
    th = 0.7 + i
    pos = 175.0 * np.array([np.cos(th), np.sin(th), 0.2])
    R = look_at_extrinsic(pos, np.zeros(3))
    np.testing.assert_array_equal(R, j_look_at(pos, np.zeros(3)))
    K = intrinsics(*RES)
    np.testing.assert_array_equal(K, j_intrinsics(*RES))
    return [R, K, np.linalg.inv(R), np.linalg.inv(K)]


def test_generate_rays_and_project_match_jax():
    cam_np = _cam_np()
    V = np.random.default_rng(0).normal(scale=30.0, size=(50, 3))
    with jax.enable_x64(True):
        jc = JCAM.CameraM(*[jnp.asarray(c) for c in cam_np])
        jo, jd = JCAM.generate_rays(*RES, jc)
        jp = JCAM.project_vertices(jc, jnp.asarray(V))
    tc = TCAM.CameraM(*[torch.tensor(c) for c in cam_np])
    to, td = TCAM.generate_rays(*RES, tc)
    tp = TCAM.project_vertices(tc, torch.tensor(V), detach_depth=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-12)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-12)


@pytest.fixture(scope="module")
def meshes():
    v, f = make_icosphere(subdivisions=3, radius=50.0)
    return JMESH.build_mesh_state(v, f), build_mesh_state(v, f,
                                                          device="cpu")


@pytest.mark.parametrize("view", [0, 1, 2])
def test_silhouette_mask_and_samples_match_jax(meshes, view):
    jms, tms = meshes
    cam_np = [c.astype(np.float32) for c in _cam_np(view)]
    origin = cam_np[2][:3, 3]
    budget = 512
    jm = JSIL.silhouette_edge_mask(jms.vertices, jms.faces, jms.edge_faces,
                                   jms.edge_valid, jnp.asarray(origin))
    tm = TSIL.silhouette_edge_mask(tms.vertices, tms.faces, tms.edge_faces,
                                   tms.edge_valid, torch.tensor(origin))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    from drt_tpu.intersect import get_intersect_fn as j_get_fn
    js = JSIL.primary_visibility(
        jms, JCAM.CameraM(*[jnp.asarray(c) for c in cam_np]),
        jnp.asarray(origin), j_get_fn("brute"), budget, *RES)
    ts = TSIL.primary_visibility(
        tms, TCAM.CameraM(*[torch.tensor(c) for c in cam_np]),
        torch.tensor(origin), get_intersect_fn("auto"), budget, *RES)
    assert int(ts.count) == int(js.count) > 0
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_array_equal(ts.pixel.numpy(), np.asarray(js.pixel))
    np.testing.assert_array_equal(ts.output.detach().numpy(),
                                  np.asarray(js.output))


def test_limit_grad_and_budget_match_jax():
    g = np.array([np.nan, -3.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0, np.inf])
    for clamp in (1.0, 0.0):
        j = np.asarray(JLOOP.limit_grad(jnp.asarray(g), clamp))
        t = TLOOP.limit_grad(torch.tensor(g), clamp).numpy()
        np.testing.assert_array_equal(t, j)
    for e in (10, 2047, 2048, 2049, 58443, 10 ** 6):
        assert TLOOP.default_silhouette_budget(e) == \
            JLOOP.default_silhouette_budget(e)


def test_view_generators_and_stack_views_match_jax():
    rng = np.random.default_rng(3)
    views = [dict(screen_pixel=rng.normal(size=(12, 3)),
                  valid=rng.random(12) > 0.3,
                  mask=rng.random((3, 4)),
                  origin=np.broadcast_to(rng.normal(size=3), (12, 3)),
                  ray_dir=rng.normal(size=(12, 3)),
                  R=np.eye(4) + 0.1 * rng.normal(size=(4, 4)),
                  K=np.diag([30.0, 30.0, 1.0])) for _ in range(5)]
    jv = JVIEWS.stack_views(views)
    tv = TVIEWS.stack_views(views, device="cpu")
    for k in JVIEWS.ViewBatch._fields:
        np.testing.assert_allclose(getattr(tv, k).numpy(),
                                   np.asarray(getattr(jv, k)), rtol=1e-6,
                                   err_msg=k)
    assert tv.origin.shape == (5, 1, 3)
    for name in ("mouse", "dog"):
        jc = JVIEWS.CaptureData(name, 3, 4, 5, jv, num_view_used=5)
        tc = TVIEWS.CaptureData(name, 3, 4, 5, tv, num_view_used=5)
        for jg, tg in ((jc.ray_view_generator(4), tc.ray_view_generator(4)),
                       (jc.silh_view_generator(9),
                        tc.silh_view_generator(9))):
            assert [next(tg) for _ in range(40)] == \
                [next(jg) for _ in range(40)]
    o = tv.take(2)[3]
    assert o.shape == (12, 3)


def test_process_mask_copy_matches_jax():
    m = np.zeros((20, 30), np.uint8)
    m[5:15, 8:22] = 1
    m[9, 3] = 1
    np.testing.assert_array_equal(TMASK.process_mask(m),
                                  JMASK.process_mask(m))

"""The slice end to end against the JAX package, in float64 with the
reference-exact (compat) refraction chain: total_loss and its [V,3]
gradient at rtol 1e-7, then two make_train_step iterations (sgd, none)
ending with vertices at rtol 1e-7 of drt_tpu. Both packages start from
identical state (carried across with drt_tpu_torch.convert); the test first
asserts that the oracle hit ids agree on its inputs, since one flipped tie
would change a face normal and end the comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drt_tpu.mesh as JMESH
from drt_tpu.data.synthetic import synthesize_capture as j_synth
from drt_tpu.data.views import ViewBatch as JViews
from drt_tpu.intersect import get_intersect_fn as j_get_fn
from drt_tpu.optimize.losses import LossWeights as JW
from drt_tpu.optimize.losses import total_loss as j_total
from drt_tpu.optimize.loop import make_train_step as j_make_step
from drt_tpu.render.silhouette import primary_visibility as j_vis
from drt_tpu.render.trace import render_transparent as j_render
from drt_tpu_torch.config import HyperParams
from drt_tpu_torch.convert import mesh_state_from_arrays, view_batch_from_arrays
from drt_tpu_torch.intersect import cuda_kernel
from drt_tpu_torch.intersect import get_intersect_fn as t_get_fn
from drt_tpu_torch.optimize import (LossWeights, default_silhouette_budget,
                                    make_train_step, total_loss)
from drt_tpu_torch.render.silhouette import primary_visibility as t_vis
from drt_tpu_torch.render.trace import render_transparent as t_render
from tests.meshes import make_icosphere

# The test workers run side by side on few cores: torch's intra-op pool at
# its default size oversubscribes them and slows every worker down.
torch.set_num_threads(min(2, torch.get_num_threads()))

RES = (20, 24)                 # (resy, resx)
SILH = [0, 1, 2, 3]
RAY_VIEWS = [1, 2]             # one per iteration
HP = HyperParams()
FIELDS = ("vertices", "faces", "face_valid", "vert_valid", "edges",
          "edge_valid", "edge_faces", "neighbors", "neighbor_valid",
          "normals", "mean_len")


@pytest.fixture(scope="module")
def setup():
    """A 4-view capture of a 20-unit sphere (compat's absolute 1e-5 nudge
    must stay above float32 resolution in the oracle) and a bumpy initial
    mesh, both as float64 numpy arrays."""
    gt_v, gt_f = make_icosphere(subdivisions=3, radius=20.0)
    cap = j_synth(gt_v, gt_f, num_views=4, resy=RES[0], resx=RES[1],
                  backend="brute")
    views = {k: np.asarray(getattr(cap.views, k), np.float64)
             for k in JViews._fields}
    views["valid"] = np.asarray(cap.views.valid)
    v0, f0 = make_icosphere(subdivisions=2, radius=20.0)
    rng = np.random.default_rng(1)
    v0 = v0 * np.clip(1 + 0.06 * rng.standard_normal(len(v0))[:, None],
                      0.9, 1.1)
    # A random rotation: the icosphere's edges lie in the coordinate
    # planes, which hold whole pixel columns of the ring cameras, so
    # unrotated those rays run exactly along shared edges (true ties).
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    v0 = v0 @ q.T
    with jax.enable_x64(True):
        jms = JMESH.build_mesh_state(v0, f0, dtype=jnp.float64)
        mesh = {k: np.asarray(getattr(jms, k)) for k in FIELDS}
    mesh.update(num_vertices=jms.num_vertices, num_faces=jms.num_faces,
                num_edges=jms.num_edges)
    return views, mesh


def _jax_state(views, mesh):
    jv = JViews(**{k: jnp.asarray(views[k]) for k in JViews._fields})
    v, f = mesh["vertices"][:mesh["num_vertices"]], \
        mesh["faces"][:mesh["num_faces"]]
    jms = JMESH.build_mesh_state(v, f, dtype=jnp.float64,
                                 topology=JMESH.build_topology(
                                     f, mesh["num_vertices"]))
    return jv, jms


def _weights(cls):
    return cls(ray_w=HP.ray_w, vh_w=HP.vh_w, sm_w=HP.sm_w, ior=HP.ior,
               ext_ior=HP.ext_ior, compat=True)


def test_hit_ids_agree(setup):
    """Precondition of the float64 comparisons: both oracles pick the same
    triangles for every ray of the ray views and every silhouette sample."""
    views, mesh = setup
    tv = view_batch_from_arrays(views, "cpu")
    tms = mesh_state_from_arrays(mesh, "cpu")
    budget = default_silhouette_budget(mesh["num_edges"])
    with jax.enable_x64(True):
        jv, jms = _jax_state(views, mesh)
        np.testing.assert_array_equal(np.asarray(jms.faces), mesh["faces"])
        for i in RAY_VIEWS:
            sp, valid, _m, o, d, _c = jv.take(i)
            jr = jax.jit(lambda o, d, ms, valid: j_render(
                o, d, ms, j_get_fn("brute"), HP.ior, HP.ext_ior,
                compat=True, lane_mask=valid))(o, d, jms, valid)
            sp, valid, _m, o, d, _c = tv.take(i)
            tr = t_render(o, d, tms, t_get_fn("auto"), HP.ior, HP.ext_ior,
                          compat=True, lane_mask=valid)
            assert int(tr.stats["valid_rays"]) > 20
            valid = tr.valid.numpy()
            np.testing.assert_array_equal(valid, np.asarray(jr.valid))
            # Every ray that reaches the loss hit the same two faces. A lane
            # that dies either way may die differently: compat's absolute
            # 1e-5 exit nudge leaves grazing exits within a few float32 ulps
            # of their own surface (at most 2 such lanes per 1,024).
            for a, b in zip(tr.tris, jr.tris):
                a, b = a.numpy(), np.asarray(b)
                np.testing.assert_array_equal(a[valid], b[valid])
                assert (a != b).sum() <= max(1, 2 * len(a) // 1024)
        for i in SILH:
            _, _, _, o, _, cam = jv.take(i)
            js = jax.jit(lambda ms, cam, c: j_vis(
                ms, cam, c, j_get_fn("brute"), budget, *RES))(jms, cam, o[0])
            _, _, _, o, _, cam = tv.take(i)
            ts = t_vis(tms, cam, o[0], t_get_fn("auto"), budget, *RES)
            assert int(ts.valid.sum()) > 0
            np.testing.assert_array_equal(ts.valid.numpy(),
                                          np.asarray(js.valid))
            np.testing.assert_array_equal(ts.pixel.numpy(),
                                          np.asarray(js.pixel))


def test_total_loss_and_grad_match_jax(setup):
    views, mesh = setup
    budget = default_silhouette_budget(mesh["num_edges"])
    with jax.enable_x64(True):
        jv, jms = _jax_state(views, mesh)

        def jl(v):
            return j_total(jms.with_vertices(v), jv, RAY_VIEWS[0],
                           jnp.asarray(SILH), j_get_fn("brute"),
                           _weights(JW), *RES, budget, ray_chunk=0)

        (jloss, jaux), jg = jax.jit(jax.value_and_grad(jl, has_aux=True))(
            jms.vertices)
        jg = np.asarray(jg)
    tms = mesh_state_from_arrays(mesh, "cpu")
    tv = view_batch_from_arrays(views, "cpu")
    v = tms.vertices.clone().requires_grad_(True)
    tloss, taux = total_loss(tms.with_vertices(v), tv, RAY_VIEWS[0], SILH,
                             t_get_fn("auto"), _weights(LossWeights), *RES,
                             budget)
    (tg,) = torch.autograd.grad(tloss, v)
    for k in ("ray", "vh", "sm"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-7, err_msg=k)
    assert int(taux["silh_edge_max"]) == int(jaux["silh_edge_max"])
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-7)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-7,
                               atol=1e-7 * np.abs(jg).max())


def test_two_train_steps_match_jax(setup):
    views, mesh = setup
    budget = default_silhouette_budget(mesh["num_edges"])
    with jax.enable_x64(True):
        jv, jms = _jax_state(views, mesh)
        init, step, final = j_make_step(j_get_fn("brute"), _weights(JW),
                                        *RES, budget)
        st = init(jms)
        lr = jnp.asarray(HP.start_lr, jnp.float64)
        jlosses = []
        for i in RAY_VIEWS:
            st, loss, _ = step(st, lr, jms, jv, jnp.asarray([i]),
                               jnp.asarray(SILH))
            jlosses.append(float(loss))
        jverts = np.asarray(final(st, jms))

    tms = mesh_state_from_arrays(mesh, "cpu")
    tv = view_batch_from_arrays(views, "cpu")
    init, step, final = make_train_step(t_get_fn("auto"),
                                        _weights(LossWeights), *RES, budget)
    st = init(tms)
    cuda_kernel.counters.reset()
    tlosses = []
    for i in RAY_VIEWS:
        st, loss, aux = step(st, HP.start_lr, tms, tv, i, SILH)
        tlosses.append(float(loss))
        assert float(aux["max_grad"]) <= HP.grad_clamp
    # three ray queries + one per silhouette view, every step
    assert cuda_kernel.counters.calls == len(RAY_VIEWS) * (3 + len(SILH))
    tverts = final(st, tms).numpy()
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-7)
    moved = np.abs(tverts - mesh["vertices"]).max()
    assert moved > 1e-3
    np.testing.assert_allclose(tverts, jverts, rtol=1e-7,
                               atol=1e-7 * np.abs(jverts).max())

"""drt_tpu_torch.render.chunked and the chunked ray loss against the JAX
package and against the unchunked sum, on the CPU in float64 at rtol 1e-10
(atol 1e-10 of the largest entry: reassociation across chunk boundaries
only), with a ray count that no chunk size divides; and the bilinear-mask
silhouette loss and its gradient against the JAX package at rtol 1e-7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drt_tpu.mesh as JMESH
from drt_tpu.intersect import get_intersect_fn as j_get_fn
from drt_tpu.optimize.losses import ray_loss as j_ray_loss
from drt_tpu.optimize.losses import silhouette_loss as j_silh_loss
from drt_tpu.render import chunked as JC
from drt_tpu_torch.convert import mesh_state_from_arrays, view_batch_from_arrays
from drt_tpu_torch.intersect import cuda_kernel
from drt_tpu_torch.intersect import get_intersect_fn as t_get_fn
from drt_tpu_torch.mesh import build_mesh_state
from drt_tpu_torch.optimize.losses import ray_loss, silhouette_loss
from drt_tpu_torch.render import chunked as TC
from tests.meshes import make_icosphere
from tests.test_torch_train import RES, SILH, _jax_state, setup  # noqa: F401

# The test workers run side by side on few cores: torch's intra-op pool at
# its default size oversubscribes them and slows every worker down.
torch.set_num_threads(min(2, torch.get_num_threads()))

IOR, EXT = 1.4723, 1.00029
COUNTERS = ("valid_rays", "occluded_exit", "active_after_bounce1",
            "active_after_bounce2", "dropped_bounce1", "dropped_bounce2")


def _close(t, j, rtol=1e-10):
    j = np.asarray(j, np.float64)
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, j, rtol=rtol,
                               atol=rtol * max(np.abs(j).max(), 1e-300))


def test_auto_policy_equal():
    for n in (1280 * 960, 1920 * 1080, 2 ** 21, 2 ** 21 + 1,
              1920 * 1080 * 4):
        assert TC.auto_ray_chunk(n) == JC.auto_ray_chunk(n)
    assert TC.auto_ray_chunk(1920 * 1080 * 4) == 2 ** 20


@pytest.mark.parametrize("chunk", [64, 100, 333, 1000, 0])
def test_chunked_sum_value_and_gradient(chunk):
    """A nest of sums (scalar, mesh-sized accumulator in a dict) over 333
    rays; chunks of 64 and 100 pad the last chunk."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(333, 3))
    m = rng.random(333) < 0.8
    slot = rng.integers(0, 7, 333)
    w0 = 1.7

    with jax.enable_x64(True):
        def jbody_of(w):
            def body(x, m, slot):
                s = jnp.where(m[:, None], jnp.sin(w * x), 0.0)
                acc = jnp.zeros(7).at[slot].add(jnp.where(m, x[:, 0], 0.0))
                return jnp.sum(s), {"acc": acc}
            return body

        def jloss(w):
            return JC.chunked_sum(jbody_of(w), (jnp.asarray(x),
                                                jnp.asarray(m),
                                                jnp.asarray(slot)),
                                  chunk, pad_values=(0.0, False, 0))
        (jval, jst), jg = jax.value_and_grad(jloss, has_aux=True)(w0)

    w = torch.tensor(w0, dtype=torch.float64, requires_grad=True)
    calls = []

    def body(x, m, slot):
        calls.append(x.shape[0])
        s = torch.where(m[:, None], torch.sin(w * x), torch.zeros_like(x))
        acc = torch.zeros(7, dtype=x.dtype).index_add_(
            0, slot, torch.where(m, x[:, 0], torch.zeros_like(x[:, 0])))
        return s.sum(), {"acc": acc}

    args = (torch.tensor(x), torch.tensor(m), torch.tensor(slot))
    val, st = TC.chunked_sum(body, args, chunk, pad_values=(0.0, False, 0))
    n_fwd = len(calls)
    (g,) = torch.autograd.grad(val, w)
    n_bwd = len(calls) - n_fwd
    ref, ref_st = body(*args)
    (g_ref,) = torch.autograd.grad(ref, w)
    _close(val, jval)
    _close(g, jg)
    _close(st["acc"], jst["acc"])
    _close(val, ref.detach().numpy())
    _close(g, g_ref.numpy())
    _close(st["acc"], ref_st["acc"].numpy())
    if 0 < chunk < 333:
        # every chunk has the full size (the last one padded), and the
        # backward reruns each chunk's body once
        t = -(-333 // chunk)
        assert calls[:n_fwd] == [chunk] * t
        assert n_bwd == t
    else:
        assert calls[:n_fwd] == [333]


def _sphere_view(n=20):
    """A small synthetic view of a rotated, bumpy icosphere: rays from one
    camera point through an n x n grid (float64 numpy)."""
    v, f = make_icosphere(subdivisions=2, radius=10.0)
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    v = (v * (1 + 0.03 * rng.standard_normal(len(v))[:, None])) @ q.T
    cam = np.array([35.0, 0.0, 5.0])
    ys, zs = np.meshgrid(np.linspace(-11, 11, n), np.linspace(-11, 11, n))
    targets = np.stack([np.zeros_like(ys), ys, zs], -1).reshape(-1, 3)
    d = targets - cam
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    valid = np.ones(n * n, bool)
    valid[::17] = False                      # some matting-invalid pixels
    return v, f, dict(screen=targets * np.array([-3.0, 1, 1]), valid=valid,
                      origin=np.broadcast_to(cam, d.shape).copy(), ray_dir=d)


@pytest.mark.parametrize("huber", [0.0, 0.05])
def test_chunked_ray_loss_matches_jax_and_unchunked(huber):
    v, f, vw = _sphere_view()
    with jax.enable_x64(True):
        jms = JMESH.build_mesh_state(v, f, dtype=jnp.float64)
        jview = (jnp.asarray(vw["screen"]), jnp.asarray(vw["valid"]), None,
                 jnp.asarray(vw["origin"]), jnp.asarray(vw["ray_dir"]), None)

        def jl(vertices, chunk):
            return j_ray_loss(jms.with_vertices(vertices), jview,
                              j_get_fn("brute"), IOR, EXT,
                              collect_evidence=True, huber=huber,
                              ray_chunk=chunk)
        (j1, js1), jg1 = jax.value_and_grad(
            lambda x: jl(x, 96), has_aux=True)(jms.vertices)

    tms = build_mesh_state(v, f, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(tms.faces.numpy(), np.asarray(jms.faces))
    tview = (torch.tensor(vw["screen"]), torch.tensor(vw["valid"]), None,
             torch.tensor(vw["origin"]), torch.tensor(vw["ray_dir"]), None)

    def tl(chunk):
        x = tms.vertices.clone().requires_grad_(True)
        cuda_kernel.counters.reset()
        loss, st = ray_loss(tms.with_vertices(x), tview, t_get_fn("auto"),
                            IOR, EXT, collect_evidence=True, huber=huber,
                            ray_chunk=chunk)
        (g,) = torch.autograd.grad(loss, x)
        return loss, st, g, cuda_kernel.counters.calls

    l0, s0, g0, q0 = tl(0)
    l1, s1, g1, q1 = tl(96)                  # 400 rays: 5 chunks, 80 padded
    assert q0 == 3
    assert q1 == 2 * 3 * 5                   # the backward reruns the oracle
    assert int(s0["valid_rays"]) > 50
    for k in COUNTERS:
        assert int(s1[k]) == int(s0[k]) == int(js1[k]), k
    for a, b in ((l1, j1), (g1, jg1), (l1, l0.detach().numpy()),
                 (g1, g0.numpy())):
        _close(a, b)
    np.testing.assert_array_equal(s1["vertex_evidence"].numpy(),
                                  s0["vertex_evidence"].numpy())
    np.testing.assert_array_equal(s1["vertex_evidence"].numpy(),
                                  np.asarray(js1["vertex_evidence"]))


def test_bilinear_mask_loss_and_gradient_match_jax(setup):  # noqa: F811
    views, mesh = setup
    with jax.enable_x64(True):
        jv, jms = _jax_state(views, mesh)

        def jl(vertices, bilinear):
            m = jms.with_vertices(vertices)
            tot = 0.0
            for i in SILH:
                tot = tot + j_silh_loss(m, jv.take(i), j_get_fn("brute"),
                                        512, *RES, bilinear_mask=bilinear)[0]
            return tot
        jb, jgb = jax.value_and_grad(lambda x: jl(x, True))(jms.vertices)
        jt = jl(jms.vertices, False)
    tms = mesh_state_from_arrays(mesh, "cpu")
    tv = view_batch_from_arrays(views, "cpu")

    def tl(bilinear):
        x = tms.vertices.clone().requires_grad_(True)
        m = tms.with_vertices(x)
        tot = sum(silhouette_loss(m, tv.take(i), t_get_fn("auto"), 512,
                                  *RES, bilinear_mask=bilinear)[0]
                  for i in SILH)
        (g,) = torch.autograd.grad(tot, x)
        return tot, g
    tb, tgb = tl(True)
    tt, _ = tl(False)
    _close(tb, jb, 1e-7)
    _close(tgb, jgb, 1e-7)
    _close(tt, jt, 1e-7)
    # the two samplings differ
    assert abs(float(tb.detach()) - float(tt.detach())) > 1e-6

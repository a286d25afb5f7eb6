"""The pieces of the port's captured train step that run on the CPU, each
against the JAX package or against the path it replaced, on the same
inputs:

- `select_edges`, the silhouette's fixed-size selection, against
  `jnp.nonzero(silh, size=budget, fill_value=0)` (exact), with the budget
  below, at and above the number of silhouette edges;
- `primary_visibility` and `silhouette_loss`, values and vertex gradients,
  against the same functions with the parent's selection (`torch.nonzero`,
  then padding) swapped in: bit for bit;
- `geometry/vec.constant`: the bits of `torch.as_tensor`, kept once per
  (value, dtype, device); `clip`'s gradient at a tie against JAX's
  (exact, float32 and float64);
- `ViewBatch.take` by an index tensor against `take(i)` (bit for bit), and
  the step and `total_loss` with index tensors against ints (bit for bit);
- the scatter's deferred bounds scope and the launch counters' replay
  arithmetic;
- `GraphedTrainStep` refuses CPU tensors, DRT_TPU_DEBUG and a sharded
  step.

The graph itself runs only on the card: tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drt_tpu_torch.render.silhouette as TSIL
from drt_tpu_torch import kernels
from drt_tpu_torch.data.synthetic import intrinsics, look_at_extrinsic
from drt_tpu_torch.data.views import ViewBatch
from drt_tpu_torch.geometry import scatter as TSC
from drt_tpu_torch.geometry.vec import clip, constant
from drt_tpu_torch.intersect import get_intersect_fn
from drt_tpu_torch.mesh import build_mesh_state, load_ply
from drt_tpu_torch.optimize import LossWeights, make_train_step
from drt_tpu_torch.optimize.loop import GraphedTrainStep
from drt_tpu_torch.optimize.losses import silhouette_loss, total_loss
from drt_tpu_torch.render.camera import CameraM
from tests.meshes import make_icosphere

torch.set_num_threads(min(2, torch.get_num_threads()))

RES = (24, 32)
DOG20K = "reports/tuning_meshes/dog_mid20k.ply"


def _cam(i=0, dtype=torch.float64):
    th = 0.7 + i
    pos = 175.0 * np.array([np.cos(th), np.sin(th), 0.2])
    R = look_at_extrinsic(pos, np.zeros(3))
    K = intrinsics(*RES)
    cam = CameraM(*[torch.tensor(c, dtype=dtype) for c in
                    (R, K, np.linalg.inv(R), np.linalg.inv(K))])
    return cam, cam.R_inv[:3, 3].clone()


@pytest.fixture(scope="module")
def mesh_states():
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    v, f = make_icosphere(subdivisions=3, radius=50.0)
    dv, df = load_ply(os.path.join(root, DOG20K))
    dv = (dv - dv.mean(axis=0)) * (50.0 / np.abs(dv - dv.mean(axis=0)).max())
    return {"icosphere": build_mesh_state(v, f, dtype=torch.float64,
                                          device="cpu"),
            "dog20k": build_mesh_state(dv, df, dtype=torch.float64,
                                       device="cpu")}


def _silh(ms, view=0):
    _, origin = _cam(view)
    return TSIL.silhouette_edge_mask(ms.vertices, ms.faces, ms.edge_faces,
                                     ms.edge_valid, origin)


def _parent_select_edges(silh, budget):
    """The parent's selection: nonzero, cut to the budget, padded with 0."""
    silh_count = silh.sum()
    edge_idx = torch.nonzero(silh).squeeze(1)[:budget]
    edge_idx = torch.cat([edge_idx, edge_idx.new_zeros(
        budget - edge_idx.shape[0])])
    sel_valid = torch.arange(budget, device=silh.device) < silh_count
    return edge_idx, sel_valid, silh_count


@pytest.mark.parametrize("where", ["below", "at", "above"])
@pytest.mark.parametrize("name", ["icosphere", "dog20k"])
def test_select_edges_matches_jnp_nonzero(mesh_states, name, where):
    silh = _silh(mesh_states[name])
    count = int(silh.sum())
    assert count > 8
    budget = {"below": count // 3, "at": count, "above": 2 * count}[where]
    edge_idx, sel_valid, n = TSIL.select_edges(silh, budget)
    (want,) = jnp.nonzero(jnp.asarray(silh.numpy()), size=budget,
                          fill_value=0)
    np.testing.assert_array_equal(edge_idx.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sel_valid.numpy(),
                                  np.asarray(jnp.arange(budget) < count))
    assert int(n) == count and edge_idx.dtype == torch.int64


def _visibility_and_loss(ms, budget, view):
    """primary_visibility's outputs, silhouette_loss, and the vertex
    gradient of each, on a float64 copy of `ms`."""
    cam, origin = _cam(view)
    fn = get_intersect_fn("auto")
    x = ms.vertices.clone().requires_grad_(True)
    m = ms.with_vertices(x)
    s = TSIL.primary_visibility(m, cam, origin, fn, budget, *RES)
    (g_out,) = torch.autograd.grad(s.output.sum() + s.pixel_f.sum(), x)
    mask = torch.linspace(0.0, 1.0, RES[0] * RES[1],
                          dtype=torch.float64).reshape(RES)
    view_t = (None, None, mask, origin[None], None, cam)
    y = ms.vertices.clone().requires_grad_(True)
    loss, count = silhouette_loss(ms.with_vertices(y), view_t, fn, budget,
                                  *RES)
    (g_loss,) = torch.autograd.grad(loss, y)
    return (s.pixel, s.pixel_f, s.output.detach(), s.valid, s.count,
            g_out, loss.detach(), count, g_loss)


@pytest.mark.parametrize("budget", [64, 1024])
@pytest.mark.parametrize("name", ["icosphere", "dog20k"])
def test_visibility_and_silhouette_loss_unchanged(mesh_states, name, budget,
                                                  monkeypatch):
    ms = mesh_states[name]
    got = _visibility_and_loss(ms, budget, 1)
    monkeypatch.setattr(TSIL, "select_edges", _parent_select_edges)
    want = _visibility_and_loss(ms, budget, 1)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got[4]) > 0 and bool(got[3].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int32, torch.int64, torch.bool])
def test_constant_has_the_bits_of_as_tensor(dtype):
    for value in (1e-12, 1.00029, -0.57735027, 0.0, -0.0, 3, True):
        if dtype == torch.bool and not isinstance(value, bool):
            continue
        got = constant(value, dtype, "cpu")
        want = torch.as_tensor(value, dtype=dtype)
        assert got.shape == () and got.dtype == dtype
        assert torch.equal(got.view(-1)[:1].view(torch.uint8),
                           want.view(-1)[:1].view(torch.uint8))
        assert constant(value, dtype, "cpu") is got      # made once
    pair = constant((31, 23), torch.int32, "cpu")
    assert torch.equal(pair, torch.tensor([31, 23], dtype=torch.int32))


def test_constant_is_no_inference_tensor():
    with torch.inference_mode():
        c = constant(0.125, torch.float64, "cpu")
    x = torch.tensor([0.125, 1.0], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(torch.maximum(x, c).sum(), x)
    assert g.tolist() == [0.5, 1.0]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_clip_tie_gradients_match_jax(dtype):
    """At x == lo or x == hi JAX's clip gives half the gradient (the
    min/max tie rule), and so must the port's, in both precisions."""
    x = np.array([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0], dtype=dtype)
    w = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0], dtype=dtype)
    with jax.enable_x64(dtype == np.float64):
        jv, jg = jax.value_and_grad(
            lambda a: jnp.sum(jnp.clip(a, -1.0, 1.0) * w))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tv = (clip(tx, -1.0, 1.0) * torch.tensor(w)).sum()
    (tg,) = torch.autograd.grad(tv, tx)
    assert tg.dtype == tx.dtype
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tv.detach().numpy(), np.asarray(jv))


def _views(compact: bool, seed=0):
    rng = np.random.default_rng(seed)
    nv, n = 5, RES[0] * RES[1]

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32)
    return ViewBatch(
        screen_pixel=t(nv, n, 3),
        valid=torch.tensor(rng.random((nv, n)) < 0.7),
        mask=t(nv, *RES), origin=t(nv, 1 if compact else n, 3),
        ray_dir=t(nv, n, 3), R=t(nv, 4, 4), K=t(nv, 3, 3),
        R_inv=t(nv, 4, 4), K_inv=t(nv, 3, 3))


def _flat(view):
    sp, valid, mask, origin, rd, cam = view
    return [sp, valid, mask, origin, rd, *cam]


@pytest.mark.parametrize("compact", [False, True])
def test_take_by_index_tensor_matches_take(compact):
    views = _views(compact)
    for i in range(5):
        for rays in (True, False):
            got = views.take(torch.tensor([i]), rays=rays)
            want = views.take(i, rays=rays)
            for a, b in zip(_flat(got), _flat(want)):
                if b is None:
                    assert a is None
                else:
                    assert a.shape == b.shape and torch.equal(a, b)
        full = views.take(i)
        lean = views.take(i, rays=False)
        assert torch.equal(lean[3][0], full[3][0])
        assert torch.equal(lean[2], full[2])
        assert torch.equal(views.take(torch.tensor(i))[4], full[4])


@pytest.fixture(scope="module")
def sphere_capture():
    from drt_tpu_torch.data.synthetic import synthesize_capture
    gt_v, gt_f = make_icosphere(subdivisions=3, radius=50.0)
    cap = synthesize_capture(gt_v, gt_f, name="sphere", num_views=4,
                             resy=RES[0], resx=RES[1], ior=1.5,
                             num_view_used=4, device="cpu")
    v0, f0 = make_icosphere(subdivisions=2, radius=47.0)
    return cap, build_mesh_state(v0, f0, device="cpu")


@pytest.mark.parametrize("pair", [("sgd", "none"), ("uadam", "h1")])
def test_step_by_index_tensors_matches_ints(sphere_capture, pair):
    """What a graph of the step runs (views by index tensors, lr a 0-d
    tensor) against the eager step with ints and a float: the same bits,
    two steps."""
    cap, ms = sphere_capture
    w = LossWeights(ray_w=40.0, vh_w=2e-3, sm_w=0.08, ior=1.5)
    init, step, _ = make_train_step(get_intersect_fn("auto"), w, *RES, 256,
                                    optimizer=pair[0], precond=pair[1])
    a = b = init(ms)
    lr = 0.05
    for ray, silh in ((1, [0, 1, 2, 3]), (3, [2, 2, 0, 1])):
        a, la, aux_a = step(a, lr, ms, cap.views, ray, silh)
        b, lb, aux_b = step(b, torch.tensor(lr, dtype=torch.float32), ms,
                            cap.views, torch.tensor([ray]),
                            torch.tensor(silh))
        assert torch.equal(la, lb)
        for k in a:
            assert torch.equal(a[k], b[k]), k
        for k in aux_a:
            assert torch.equal(aux_a[k], aux_b[k]), k


def test_total_loss_several_ray_views_by_tensor(sphere_capture):
    cap, ms = sphere_capture
    w = LossWeights(ray_w=40.0, vh_w=2e-3, sm_w=0.08, ior=1.5)
    fn = get_intersect_fn("auto")
    la, aux_a = total_loss(ms, cap.views, [0, 2], [1, 3], fn, w, *RES, 256)
    lb, aux_b = total_loss(ms, cap.views, torch.tensor([0, 2]),
                           torch.tensor([1, 3]), fn, w, *RES, 256)
    assert torch.equal(la, lb)
    assert all(torch.equal(aux_a[k], aux_b[k]) for k in aux_a)


def test_deferred_bounds_scope():
    word = torch.zeros(1, dtype=torch.int32)
    with TSC.deferred_bounds_check(word) as w:
        assert w is word and TSC._deferred_word is word
        with pytest.raises(RuntimeError, match="already open"):
            with TSC.deferred_bounds_check(torch.zeros(1, dtype=torch.int32)):
                pass
    assert TSC._deferred_word is None
    for bad in (torch.zeros(1, dtype=torch.int64),
                torch.zeros(2, dtype=torch.int32)):
        with pytest.raises(ValueError):
            with TSC.deferred_bounds_check(bad):
                pass
    TSC.raise_if_out_of_bounds(0)
    with pytest.raises(RuntimeError, match="out of bounds"):
        TSC.raise_if_out_of_bounds(1)
    # on the CPU a scatter inside the scope still raises at its call
    rows = torch.ones(4, 3)
    with TSC.deferred_bounds_check(word):
        with pytest.raises(RuntimeError, match="out of bounds"):
            TSC.scatter_rows(rows, torch.tensor([0, 1, 9, 2]), 4)


def test_counters_snapshot_and_add():
    c = kernels.LaunchCounter()
    c.launches, c.scatter_launches = 3, 5
    snap = c.snapshot()
    assert snap["launches"] == 3 and snap["scatter_launches"] == 5
    c.add({"launches": 11, "scatter_launches": 14}, times=2)
    assert (c.launches, c.scatter_launches) == (25, 33)
    c.add({"launches": 11}, -1)
    assert c.launches == 14 and snap["launches"] == 3


def _graph_args(sphere_capture, **step_kw):
    cap, ms = sphere_capture
    w = LossWeights(ray_w=40.0, vh_w=2e-3, sm_w=0.08, ior=1.5)
    init, step, _ = make_train_step(get_intersect_fn("auto"), w, *RES, 256,
                                    **step_kw)
    return (step, init(ms), 0.05, ms, cap.views,
            torch.zeros(3, 1, dtype=torch.int64),
            torch.zeros(3, 8, dtype=torch.int64))


def test_graphed_step_refuses_cpu_debug_and_sharded(sphere_capture,
                                                    monkeypatch):
    args = _graph_args(sphere_capture)
    with pytest.raises(ValueError, match="CUDA graph needs the card"):
        GraphedTrainStep(*args)
    monkeypatch.setenv("DRT_TPU_DEBUG", "1")
    with pytest.raises(RuntimeError, match="DRT_TPU_DEBUG"):
        GraphedTrainStep(*args)
    monkeypatch.delenv("DRT_TPU_DEBUG")
    sharded = _graph_args(sphere_capture)[0]
    sharded.ray_mesh = object()
    with pytest.raises(ValueError, match="sharded step"):
        GraphedTrainStep(sharded, *args[1:])

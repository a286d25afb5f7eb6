"""A silhouette view's chain as csrc/silhouette.cu computes it, through its
plain versions on the CPU (`silhouette_pre_plain`, `silhouette_post_plain`,
`silhouette_backward_plain`, joined by `silhouette_view_loss`):

- the loss and its vertex gradient against drt_tpu's `silhouette_loss`
  and jax.grad of it, float64 at rtol 1e-12 and float32 at 1e-5, on an
  icosphere and on dog_mid20k from the port's ring camera, with a budget
  below the silhouette's edge count and above it, the mask read truncated
  and bilinear, padded edges, edges masked off by `edge_valid`, a view
  with no silhouette edge and samples whose residual is exactly zero;
- the pre kernel's selection, count, samples and rays against drt_tpu's
  `primary_visibility` and the rays it queries;
- the whole chain against the parent's torch chain
  (`primary_visibility`, the mask read and the sign-detached residual) at
  1e-5 in float32, value and gradient;
- the post kernel's sum in its fixed tree; a view read by index tensor,
  by int and from a view tuple, bit for bit; the kernels' wrappers refuse
  CPU tensors, and the CPU path counts no launch.

The kernels themselves run on the card: tests/test_torch_cuda.py."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drt_tpu.mesh as JMESH
import drt_tpu.render.camera as JCAM
import drt_tpu.render.silhouette as JSIL
from drt_tpu.intersect import get_intersect_fn as j_get_fn
from drt_tpu.optimize.losses import silhouette_loss as j_silhouette_loss
from drt_tpu_torch import kernels
from drt_tpu_torch.data.synthetic import (intrinsics, look_at_extrinsic,
                                          ring_cameras)
from drt_tpu_torch.data.views import ViewBatch
from drt_tpu_torch.intersect import get_intersect_fn
from drt_tpu_torch.mesh import build_mesh_state, load_ply
from drt_tpu_torch.optimize.losses import silhouette_loss
from drt_tpu_torch.render import silhouette_kernels as SK
from drt_tpu_torch.render.camera import CameraM
from drt_tpu_torch.render.silhouette import primary_visibility
from tests.meshes import make_icosphere

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOG20K = os.path.join(ROOT, "reports", "tuning_meshes", "dog_mid20k.ply")
RES = (48, 64)
DTYPES = {"float32": (torch.float32, np.float32, 1e-5),
          "float64": (torch.float64, np.float64, 1e-12)}
LEVELS = np.array([0.0, 0.25, 0.5, 0.75, 1.0])


@pytest.fixture(scope="module")
def meshes():
    v, f = make_icosphere(subdivisions=3, radius=50.0)
    dv, df = load_ply(DOG20K)
    return {"icosphere": (np.asarray(v, np.float64), np.asarray(f)),
            "dog20k": (np.asarray(dv, np.float64), np.asarray(df))}


def _camera(v, view):
    """(R, K) numpy of the port's ring camera `view` of 72 around v;
    "inside": a camera at v's centre, which sees every face from behind."""
    if view == "inside":
        c = v.mean(axis=0)
        R = look_at_extrinsic(c, c + np.array([1.0, 0.2, 0.1]))
    else:
        R = ring_cameras(v, 72)[view][0]
    return R, intrinsics(*RES)


def _mask(seed, level=None):
    """A soft mask of the quantised levels (exactly 0.5 on about a fifth of
    the pixels), or `level` everywhere."""
    if level is not None:
        return np.full(RES, level)
    return np.random.default_rng(seed).choice(LEVELS, RES)


def _port_view(R, K, mask, dtype):
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    cam = CameraM(t(R), t(K), t(np.linalg.inv(R)), t(np.linalg.inv(K)))
    return (None, None, t(mask), cam.R_inv[:3, 3][None].clone(), None, cam)


def _jax_view(R, K, mask, np_dtype):
    a = lambda x: jnp.asarray(np.asarray(x, np_dtype))  # noqa: E731
    cam = JCAM.CameraM(a(R), a(K), a(np.linalg.inv(R)), a(np.linalg.inv(K)))
    return (None, None, a(mask), cam.R_inv[:3, 3][None], None, cam)


def _masked(valid, every):
    """edge_valid with every `every`-th edge switched off (0: as built)."""
    if not every:
        return valid
    return valid & (np.arange(valid.shape[0]) % every != 0)


_STATES = {}


def _state(v, f, dtype):
    """The port's mesh state of (v, f), built once per dtype."""
    key = ("port", v.shape, f.shape, float(v.sum()), dtype)
    if key not in _STATES:
        _STATES[key] = build_mesh_state(v, f, dtype=dtype, device="cpu")
    return _STATES[key]


def _port(v, f, R, K, mask, dtype, budget, bilinear, every=0):
    """(loss, count, vertex gradient, state) of the port's
    silhouette_loss."""
    ms = _state(v, f, dtype)
    ms = dataclasses.replace(ms, edge_valid=torch.from_numpy(
        _masked(ms.edge_valid.numpy(), every)))
    x = ms.vertices.clone().requires_grad_(True)
    loss, count = silhouette_loss(
        dataclasses.replace(ms, vertices=x), _port_view(R, K, mask, dtype),
        get_intersect_fn("auto"), budget, *RES, bilinear_mask=bilinear)
    (g,) = torch.autograd.grad(loss, x)
    return loss.detach(), count, g, ms


def _jax(v, f, R, K, mask, np_dtype, budget, bilinear, every=0):
    """The same of drt_tpu's silhouette_loss, with jax.grad (jitted once
    per mesh, type, budget and mask read; the view and edge_valid are
    arguments)."""
    x64 = np_dtype == np.float64
    key = ("jax", v.shape, f.shape, float(v.sum()), x64, budget, bilinear)
    with jax.enable_x64(x64):
        if key not in _STATES:
            jms = JMESH.build_mesh_state(v, f, dtype=jnp.dtype(np_dtype))

            def fn(x, edge_valid, view):
                return j_silhouette_loss(
                    jms.replace(vertices=x, edge_valid=edge_valid), view,
                    j_get_fn("brute"), budget, *RES, bilinear_mask=bilinear)
            _STATES[key] = jms, jax.jit(jax.value_and_grad(fn,
                                                           has_aux=True))
        jms, grad = _STATES[key]
        (loss, count), g = grad(
            jms.vertices,
            jnp.asarray(_masked(np.asarray(jms.edge_valid), every)),
            _jax_view(R, K, mask, np_dtype))
        return float(loss), int(count), np.asarray(g)


def _close(got, want, rtol, what, scale=None):
    """got against want at rtol, entries near 0 against rtol times the
    largest (or times `scale`, the size of the terms they are a difference
    of)."""
    want = np.asarray(want)
    if scale is None:
        scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(scale, 1e-30), err_msg=what)


def _count(v, f, R, K, dtype=torch.float64):
    ms = _state(v, f, dtype)
    view = _port_view(R, K, _mask(0), dtype)
    pre = SK.silhouette_pre_plain(ms.vertices, ms.faces, ms.edge_faces,
                                  ms.edge_valid, ms.edges,
                                  SK.tuple_camera(view), 8)
    return int(pre.count)


def _budget(v, f, R, K, where="below"):
    """A budget below the view's silhouette edge count, or above it."""
    count = _count(v, f, R, K)
    assert count > 40
    return count // 3 if where == "below" else 2 * count + 7


# (mesh, ring view, budget against the silhouette's edge count)
CASES = [("icosphere", 3, "below"), ("icosphere", 3, "above"),
         ("dog20k", 5, "below")]


@pytest.mark.parametrize("bilinear", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mesh,view,where", CASES)
def test_loss_and_gradient_match_jax(meshes, mesh, view, where, dtype,
                                     bilinear):
    t_dtype, np_dtype, rtol = DTYPES[dtype]
    v, f = meshes[mesh]
    R, K = _camera(v, view)
    count = _count(v, f, R, K)
    budget = _budget(v, f, R, K, where)
    mask = _mask(view)
    loss, got_count, g, ms = _port(v, f, R, K, mask, t_dtype, budget,
                                   bilinear)
    assert not bool(ms.edge_valid.all())          # padded edges
    j_loss, j_count, j_g = _jax(v, f, R, K, mask, np_dtype, budget, bilinear)
    assert int(got_count) == j_count == count
    assert loss.dtype == t_dtype and g.dtype == t_dtype
    assert float(loss) > 0 and np.abs(j_g).max() > 0
    _close(float(loss), j_loss, rtol, "loss")
    _close(g.numpy(), j_g, rtol, "vertex gradient")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mesh,view", [("icosphere", 3), ("dog20k", 5)])
def test_edges_masked_off_match_jax(meshes, mesh, view, dtype):
    """Every third edge switched off in edge_valid on both sides."""
    t_dtype, np_dtype, rtol = DTYPES[dtype]
    v, f = meshes[mesh]
    R, K = _camera(v, view)
    budget = _budget(v, f, R, K)
    mask = _mask(view)
    loss, count, g, _ = _port(v, f, R, K, mask, t_dtype, budget, False, 3)
    j_loss, j_count, j_g = _jax(v, f, R, K, mask, np_dtype, budget, False, 3)
    assert int(count) == j_count < _count(v, f, R, K)
    _close(float(loss), j_loss, rtol, "loss")
    _close(g.numpy(), j_g, rtol, "vertex gradient")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_view_without_silhouette_edges(meshes, dtype):
    """From inside the icosphere no edge is a silhouette edge: count 0,
    every slot edge 0, the loss and gradient 0, as in the JAX package."""
    t_dtype, np_dtype, _ = DTYPES[dtype]
    v, f = meshes["icosphere"]
    R, K = _camera(v, "inside")
    mask = _mask(1)
    loss, count, g, ms = _port(v, f, R, K, mask, t_dtype, 64, True)
    j_loss, j_count, j_g = _jax(v, f, R, K, mask, np_dtype, 64, True)
    assert int(count) == j_count == 0
    assert float(loss) == j_loss == 0.0
    assert not bool(g.any()) and not np.abs(j_g).any()
    pre = SK.silhouette_pre_plain(ms.vertices, ms.faces, ms.edge_faces,
                                  ms.edge_valid, ms.edges,
                                  SK.tuple_camera(_port_view(R, K, mask,
                                                             t_dtype)), 64)
    assert not bool(pre.edge_idx.any())
    assert torch.equal(pre.ray_dir[1:64], pre.ray_dir[:1].expand(63, 3))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mesh,view", [("icosphere", 3), ("dog20k", 5)])
def test_zero_residual_gives_no_gradient(meshes, mesh, view, dtype):
    """A mask of 0.5 everywhere: every valid sample's residual is exactly 0,
    so the loss and the gradient are exactly 0 (the sign is detached, its
    subgradient 0), as in the JAX package; on the quantised mask the
    samples at 0.5 add nothing and get coefficient 0."""
    t_dtype, np_dtype, rtol = DTYPES[dtype]
    v, f = meshes[mesh]
    R, K = _camera(v, view)
    budget = _budget(v, f, R, K)
    half = _mask(0, 0.5)
    loss, _, g, ms = _port(v, f, R, K, half, t_dtype, budget, False)
    j_loss, _, j_g = _jax(v, f, R, K, half, np_dtype, budget, False)
    assert float(loss) == j_loss == 0.0
    assert not bool(g.any()) and not np.abs(j_g).any()
    # the quantised mask: which valid samples read exactly 0.5
    mask = _mask(view)
    cam = SK.tuple_camera(_port_view(R, K, mask, t_dtype))
    pre = SK.silhouette_pre_plain(ms.vertices, ms.faces, ms.edge_faces,
                                  ms.edge_valid, ms.edges, cam, budget)
    hits = get_intersect_fn("auto")(pre.origin.expand(pre.ray_dir.shape),
                                     pre.ray_dir, ms.vertices, ms.faces,
                                     ms.face_valid, coherent=False)
    _, coef = SK.silhouette_post_plain(hits.tri_id, pre.sample, pre.count,
                                       cam, *RES)
    px = pre.sample.to(torch.int32).long()
    inside = ((px[:, 0] >= 0) & (px[:, 0] < RES[1] - 1) & (px[:, 1] >= 0)
              & (px[:, 1] < RES[0] - 1))
    occ = hits.hit.to(t_dtype)
    crossing = (occ[:budget] - occ[budget:]) != 0
    on_level = torch.zeros(budget, dtype=torch.bool)
    on_level[inside] = torch.from_numpy(mask)[px[inside, 1],
                                              px[inside, 0]] == 0.5
    zero = inside & crossing & on_level
    assert int(zero.sum()) > 0 and int((inside & crossing & ~on_level).sum())
    assert not bool(coef[zero].any()) and bool(coef[inside & crossing
                                                     & ~on_level].all())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mesh,view", [("icosphere", 3), ("dog20k", 5)])
def test_pre_matches_jax_samples_and_rays(meshes, mesh, view, dtype):
    """The pre kernel's selection and count (exact), midpoints and the rays
    it gives the query against drt_tpu's primary_visibility and the rays
    it queries."""
    t_dtype, np_dtype, rtol = DTYPES[dtype]
    v, f = meshes[mesh]
    R, K = _camera(v, view)
    budget = _budget(v, f, R, K)
    ms = _state(v, f, t_dtype)
    pre = SK.silhouette_pre_plain(
        ms.vertices, ms.faces, ms.edge_faces, ms.edge_valid, ms.edges,
        SK.tuple_camera(_port_view(R, K, _mask(0), t_dtype)), budget)
    asked = []
    brute = j_get_fn("brute")

    def record(o, d, *args, **kw):
        asked.append((np.asarray(o), np.asarray(d)))
        return brute(o, d, *args, **kw)

    def samples(jms, view):
        s = JSIL.primary_visibility(jms, view[5], view[3][0], record,
                                    budget, *RES)
        silh = JSIL.silhouette_edge_mask(jms.vertices, jms.faces,
                                         jms.edge_faces, jms.edge_valid,
                                         view[3][0])
        return (jnp.nonzero(silh, size=budget, fill_value=0)[0], s.count,
                s.pixel_f)
    with jax.enable_x64(np_dtype == np.float64):
        jms = JMESH.build_mesh_state(v, f, dtype=jnp.dtype(np_dtype))
        out = samples(jms, _jax_view(R, K, _mask(0), np_dtype))
        want_idx, count, pixel_f = (np.asarray(a) for a in out)
    np.testing.assert_array_equal(pre.edge_idx.numpy(), want_idx)
    assert int(pre.count) == int(count) > budget
    np.testing.assert_array_equal(
        pre.vidx.numpy(), ms.edges.numpy()[want_idx].reshape(-1))
    (o, d), = asked
    assert pre.ray_dir.dtype == t_dtype
    _close(pre.sample.numpy(), pixel_f, rtol, "midpoints")
    # a direction is a world point less the origin, both of the origin's
    # size: held at rtol of that size
    _close(pre.ray_dir.numpy(), d, rtol, "ray directions",
           scale=np.abs(o[0]).max())
    np.testing.assert_array_equal(pre.origin.numpy(), o[0])


@pytest.mark.parametrize("bilinear", [False, True])
@pytest.mark.parametrize("mesh,view", [("icosphere", 3), ("dog20k", 5)])
def test_whole_chain_matches_parent_torch_chain(meshes, mesh, view,
                                                bilinear):
    """The chain against the parent's torch chain (primary_visibility, the
    mask read, the sign-detached residual), float32, value and vertex
    gradient at 1e-5."""
    v, f = meshes[mesh]
    R, K = _camera(v, view)
    budget = _budget(v, f, R, K, "above")
    mask = _mask(view)
    loss, count, g, ms = _port(v, f, R, K, mask, torch.float32, budget,
                               bilinear)
    x = ms.vertices.clone().requires_grad_(True)
    want, want_count = _parent_silhouette_loss(
        dataclasses.replace(ms, vertices=x),
        _port_view(R, K, mask, torch.float32), get_intersect_fn("auto"),
        budget, *RES, bilinear)
    (want_g,) = torch.autograd.grad(want, x)
    assert int(count) == int(want_count)
    _close(float(loss), float(want.detach()), 1e-5, "loss")
    _close(g.numpy(), want_g.numpy(), 1e-5, "vertex gradient")


def _parent_silhouette_loss(mesh, view, intersect_fn, budget, resy, resx,
                            bilinear):
    """The parent's silhouette_loss: primary_visibility, then the mask read
    and |mask - 0.5| with the sign detached, summed over valid samples."""
    _sp, _valid, mask_img, origin, _rd, cam = view
    s = primary_visibility(mesh, cam, origin[0], intersect_fn, budget, resy,
                           resx)
    if bilinear:
        fx, fy = s.pixel_f[:, 0], s.pixel_f[:, 1]
        x0 = torch.floor(fx).long().clamp(0, resx - 2)
        y0 = torch.floor(fy).long().clamp(0, resy - 2)
        wx = (fx - x0).clamp(0.0, 1.0)
        wy = (fy - y0).clamp(0.0, 1.0)
        picked = ((1 - wy) * ((1 - wx) * mask_img[y0, x0]
                              + wx * mask_img[y0, x0 + 1])
                  + wy * ((1 - wx) * mask_img[y0 + 1, x0]
                          + wx * mask_img[y0 + 1, x0 + 1]))
    else:
        picked = mask_img[s.pixel[:, 1].long(), s.pixel[:, 0].long()]
    diff = picked - s.output
    per_edge = torch.sign(diff).detach() * diff
    return torch.where(s.valid, per_edge, 0.0).sum(), s.count


@pytest.mark.parametrize("k", [1, 5, 1024, 16384, 16385, 40000])
def test_loss_sum_is_the_kernels_tree(k):
    """loss_sum adds slot s in virtual thread s % 16384, then the halving
    trees: against a direct statement of that order (float32)."""
    vals = torch.from_numpy(np.random.default_rng(k).standard_normal(k)
                            .astype(np.float32))
    threads = SK.SUM_BLOCKS * SK.BLOCK
    acc = [np.float32(0.0)] * threads
    for s in range(k):
        acc[s % threads] = np.float32(acc[s % threads] + vals[s].item())
    blocks = []
    for b in range(SK.SUM_BLOCKS):
        part = acc[b * SK.BLOCK:(b + 1) * SK.BLOCK]
        while len(part) > 1:
            h = len(part) // 2
            part = [np.float32(part[i] + part[i + h]) for i in range(h)]
        blocks.append(part[0])
    while len(blocks) > 1:
        h = len(blocks) // 2
        blocks = [np.float32(blocks[i] + blocks[i + h]) for i in range(h)]
    assert SK.loss_sum(vals).item() == float(blocks[0])


def _batch(v, f, dtype, views=(2, 3, 5)):
    """A ViewBatch of ring views of v (only what a silhouette view reads;
    a per-ray origin [V,N,3] whose first row is each camera's)."""
    Rs = [ring_cameras(v, 72)[i][0] for i in views]
    K = intrinsics(*RES)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    origin = t(np.stack([np.linalg.inv(R)[:3, 3] for R in Rs]))
    origin = origin[:, None].expand(len(views), 7, 3).contiguous()
    return ViewBatch(
        screen_pixel=None, valid=None,
        mask=t(np.stack([_mask(i) for i in views])), origin=origin,
        ray_dir=torch.zeros(len(views), 7, 3, dtype=dtype),
        R=t(np.stack(Rs)), K=t(np.stack([K] * len(views))),
        R_inv=t(np.stack([np.linalg.inv(R) for R in Rs])),
        K_inv=t(np.stack([np.linalg.inv(K)] * len(views))))


@pytest.mark.parametrize("bilinear", [False, True])
def test_view_by_index_tensor_int_and_tuple(meshes, bilinear):
    """view_camera(views, tensor) reads the stacked arrays at the index;
    the loss, count and gradient equal those of view_camera(views, int)
    and of the view tuple, bit for bit."""
    v, f = meshes["icosphere"]
    views = _batch(v, f, torch.float64)
    ms = _state(v, f, torch.float64)
    fn = get_intersect_fn("auto")
    got = []
    for cam in (SK.view_camera(views, torch.tensor([1])),
                SK.view_camera(views, 1),
                SK.tuple_camera((None, None, views.mask[1], views.origin[1],
                                 None, CameraM(views.R[1], views.K[1],
                                               views.R_inv[1],
                                               views.K_inv[1])))):
        x = ms.vertices.clone().requires_grad_(True)
        loss, count = SK.silhouette_view_loss(
            dataclasses.replace(ms, vertices=x), cam, fn, 300, *RES,
            bilinear)
        got.append((loss.detach(), count, torch.autograd.grad(loss, x)[0]))
    assert torch.equal(SK.view_camera(views, 1).view, torch.tensor([1]))
    assert float(got[0][0]) > 0
    for other in got[1:]:
        for a, b in zip(got[0], other):
            assert torch.equal(a, b)


def test_cpu_path_launches_nothing_and_wrappers_refuse_cpu(meshes):
    v, f = meshes["icosphere"]
    R, K = _camera(v, 3)
    before = kernels.counters.snapshot()
    _port(v, f, R, K, _mask(3), torch.float32, 100, False)
    after = kernels.counters.snapshot()
    for name in ("silhouette_pre_launches", "silhouette_post_launches",
                 "silhouette_backward_launches"):
        assert after[name] == before[name]
    ms = _state(v, f, torch.float32)
    cam = SK.tuple_camera(_port_view(R, K, _mask(3), torch.float32))
    with pytest.raises(ValueError, match="CUDA"):
        SK.silhouette_pre_cuda(ms.vertices, ms.faces, ms.edge_faces,
                               ms.edge_valid, ms.edges, cam, 16)
    with pytest.raises(ValueError, match="CUDA"):
        SK.silhouette_post_cuda(torch.zeros(32, dtype=torch.int32),
                                torch.zeros(16, 2), torch.tensor(3), cam,
                                *RES)
    with pytest.raises(ValueError, match="CUDA"):
        SK.silhouette_backward_cuda(torch.zeros(16, 2), torch.zeros(16),
                                    torch.zeros(32, 3), cam,
                                    torch.tensor(1.0))

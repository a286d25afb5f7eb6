"""The oracle's one-origin route on the CPU, through its plain versions
(`ray_order_plain`, `pack_plain` and `closest_hit_plain` with an order):
an incoherent query whose rays all read one origin row, the silhouette
sampler's, is sorted along the screen inside the oracle.

- the route's `hit` and `t` against the unsorted query's (the parent's
  route: the rays as separate rows, the same shift), bit for bit, on the
  silhouette rays of an icosphere and of dog_mid20k from the port's ring
  camera at the Pointgray resolution and the budget the step gives;
- the key orders the pixels of an axis-aligned camera along the Morton
  curve, and the sort is stable;
- the twins read through the order exactly as on the permuted rays;
- the counter `one_origin_queries`: 1 a silhouette view, 0 for the ray
  view's coherent and incoherent queries and for a coherent query of one
  origin;
- the route's sorted tiles list fewer boxes than the unsorted ones;
- a train step with the route against the parent's route: loss and state
  bit for bit.

The kernels themselves run on the card: tests/test_torch_cuda.py."""

import os

import numpy as np
import pytest
import torch

import drt_tpu_torch.intersect.cuda_kernel as CK
from drt_tpu_torch import kernels
from drt_tpu_torch.config import POINTGRAY_RES
from drt_tpu_torch.data.synthetic import (intrinsics, ring_cameras,
                                          synthesize_capture)
from drt_tpu_torch.intersect import get_intersect_fn
from drt_tpu_torch.intersect.api import Hits, one_origin
from drt_tpu_torch.mesh import build_mesh_state, load_ply
from drt_tpu_torch.optimize import (LossWeights, default_silhouette_budget,
                                    make_train_step)
from drt_tpu_torch.optimize.losses import ray_loss, silhouette_loss
from drt_tpu_torch.render.camera import CameraM
from drt_tpu_torch.render.silhouette_kernels import (one_camera,
                                                     silhouette_view_loss)
from tests.meshes import make_icosphere

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOG20K = os.path.join(ROOT, "reports", "tuning_meshes", "dog_mid20k.ply")


def _mesh(name):
    if name == "icosphere":
        v, f = make_icosphere(subdivisions=4, radius=50.0)
    else:
        v, f = load_ply(DOG20K)
    return np.asarray(v), build_mesh_state(v, f, device="cpu")


def _silhouette_query(v, ms, view, res=POINTGRAY_RES):
    """(origins, dirs) of one silhouette view's query as the step makes it
    (the pre kernel's plain version's rays, its origin expanded over them),
    from the port's ring camera of 72 views around `v`, at the step's
    budget for the mesh."""
    R, _, _ = ring_cameras(v, 72)[view]
    K = intrinsics(*res)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    cam = CameraM(f32(R), f32(K), f32(np.linalg.inv(R)),
                  f32(np.linalg.inv(K)))
    asked = []

    def record(o, d, *_, coherent):
        assert not coherent
        asked.append((o, d))
        n = o.shape[0]
        return Hits(torch.full((n,), float("inf")),
                    torch.full((n,), -1, dtype=torch.int32))
    silhouette_view_loss(ms, one_camera(cam, cam.R_inv[:3, 3],
                                        torch.zeros(res)),
                         record, default_silhouette_budget(ms.num_edges),
                         *res)
    return asked[0]


def _unsorted(o, d, vertices, faces, face_valid, **kw):
    """The query on the parent's route: its rays as separate rows, the
    shift of the one-origin tensor (as the parent computed it)."""
    return CK.intersect_cuda(o.contiguous(), d, vertices, faces, face_valid,
                             coherent=False, shift=o.float().mean(dim=0),
                             **kw)


@pytest.fixture(scope="module", params=["icosphere", "dog20k"])
def query(request):
    v, ms = _mesh(request.param)
    o, d = _silhouette_query(v, ms, view=0)
    return request.param, ms, o, d


def test_sampler_query_is_one_origin(query):
    _, _, o, d = query
    assert one_origin(o)
    assert not one_origin(o.contiguous())
    assert not one_origin(o[:1])
    assert o.shape == d.shape


def test_route_hits_equal_unsorted_query(query):
    """hit and t bit for bit (so a tri_id can differ only at a tie), at the
    route's group and at the parent's; the route counts itself once."""
    _, ms, o, d = query
    before = kernels.counters.one_origin_queries
    h = CK.intersect_cuda(o, d, ms.vertices, ms.faces, ms.face_valid,
                          coherent=False)
    assert kernels.counters.one_origin_queries == before + 1
    ref = _unsorted(o, d, ms.vertices, ms.faces, ms.face_valid)
    assert kernels.counters.one_origin_queries == before + 1
    assert int(ref.hit.sum()) > 100
    assert torch.equal(h.hit, ref.hit)
    assert torch.equal(h.t, ref.t)
    # at the parent's group too
    same_group = CK.intersect_cuda(o, d, ms.vertices, ms.faces,
                                   ms.face_valid, coherent=False,
                                   group=CK.prepare_inputs(
                                       o.contiguous(), d, ms.vertices,
                                       ms.faces, ms.face_valid,
                                       coherent=False).group)
    assert torch.equal(same_group.hit, ref.hit)
    assert torch.equal(same_group.t, ref.t)


def test_route_lists_fewer_boxes(query):
    """The sorted tiles' longest candidate list (chunk entries) is shorter
    than the unsorted tiles' at the same group and tile."""
    _, ms, o, d = query
    geom = (ms.vertices, ms.faces, ms.face_valid)
    sorted_inp = CK.prepare_inputs(o, d, *geom, coherent=False, group=1)
    assert sorted_inp.order is not None
    old = CK.RAY_TILE_INCOHERENT
    try:
        CK.RAY_TILE_INCOHERENT = CK.RAY_TILE_ONE_ORIGIN
        unsorted_inp = CK.prepare_inputs(o.contiguous(), d, *geom,
                                         coherent=False, group=1)
    finally:
        CK.RAY_TILE_INCOHERENT = old
    assert unsorted_inp.order is None
    assert int(sorted_inp.count.max()) < int(unsorted_inp.count.max())
    assert int(sorted_inp.count.sum()) < int(unsorted_inp.count.sum())


def test_twins_read_and_write_through_the_order(query):
    """`pack_plain` with an order equals it on the permuted rays, and
    `closest_hit_plain` with an order writes lane i's hit to order[i]."""
    _, ms, o, d = query
    geom = (ms.vertices, ms.faces, ms.face_valid)
    inp = CK.prepare_inputs(o, d, *geom, coherent=False)
    N = o.shape[0]
    order = inp.order
    assert order.dtype == torch.int32 and order.shape == (inp.phi.shape[1],)
    assert torch.equal(order[N:], torch.arange(N, order.shape[0],
                                               dtype=torch.int32))
    assert torch.equal(order.sort().values,
                       torch.arange(order.shape[0], dtype=torch.int32))
    shift = o.float().mean(dim=0)
    idx = order[:N].long()
    kw = dict(group=inp.group, ray_tile=CK.RAY_TILE_ONE_ORIGIN)
    got = CK.pack_plain(*geom, shift, o, d, order=order, **kw)
    want = CK.pack_plain(*geom, shift, o.contiguous()[idx], d[idx], **kw)
    for field in CK.Packed._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    t, ids = CK.closest_hit_plain(inp)
    t_lanes, id_lanes = CK.closest_hit_plain(inp._replace(order=None))
    assert torch.equal(t[order.long()], t_lanes)
    assert torch.equal(ids[order.long()], id_lanes)


def _morton2(x, y):
    key = 0
    for b in range(8):
        key |= ((x >> b) & 1) << (3 * b) | ((y >> b) & 1) << (3 * b + 1)
    return key


def test_keys_order_pixels_along_the_morton_curve():
    """An axis-aligned camera's rays through a 16 x 16 pixel grid (the z
    component one for all, x and y the pixel over 16: every step exact)
    sort into the Morton order of the pixels, x's bits lowest."""
    ys, xs = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    xs, ys = xs.ravel(), ys.ravel()
    rng = np.random.default_rng(3)
    perm = rng.permutation(xs.size)
    xs, ys = xs[perm], ys[perm]
    d = torch.tensor(np.stack([xs / 16.0, ys / 16.0, np.ones(xs.size)], 1),
                     dtype=torch.float32)
    keys = CK.ray_order_keys(d)
    cell = 2 ** (CK.ORDER_AXIS_BITS - 4)       # pixel x lands in cell x * cell
    assert keys.dtype == torch.int32
    assert int(keys.max()) < 2 ** (3 * CK.ORDER_AXIS_BITS)
    order = CK.ray_order_plain(d, 256)[:256].numpy()
    want = sorted(range(xs.size), key=lambda i: _morton2(xs[i], ys[i]))
    assert list(order) == want
    # the pixel grid's cells are the key's cells at a power of two
    assert sorted(set(keys.tolist())) == sorted(
        _morton2(cell * x, cell * y) for x in range(16) for y in range(16))


def test_order_is_stable():
    """Equal keys (the sampler's fill rays repeat edge 0's two rays) keep
    the order they came in; the lanes past the rays stay in place."""
    rng = np.random.default_rng(5)
    base = rng.normal(size=(40, 3)) + np.array([0.0, 0.0, 4.0])
    pick = rng.integers(0, 40, size=300)
    pick[100:250] = 7                       # a long run of one ray
    d = torch.tensor(base[pick], dtype=torch.float32)
    keys = CK.ray_order_keys(d).numpy()
    order = CK.ray_order_plain(d, 384).numpy()
    want = np.lexsort((np.arange(300), keys))
    assert np.array_equal(order[:300], want)
    assert np.array_equal(order[300:], np.arange(300, 384))
    run = order[:300][np.isin(order[:300], np.flatnonzero(pick == 7))]
    assert np.all(np.diff(run) > 0)


def test_keys_of_degenerate_directions():
    """A batch of one direction keys 0 (a span of 0); a NaN component keys
    0 on its axis and leaves the box to the others; an infinite span
    quantises its axis to 0 for all. The route answers a small query as
    the unsorted one does."""
    d = torch.tensor([[0.1, 0.2, 1.0]] * 5, dtype=torch.float32)
    assert CK.ray_order_keys(d).tolist() == [0] * 5
    d = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 1.0],
                      [float("nan"), 1.0, 1.0]], dtype=torch.float32)
    half = CK._spread3(torch.tensor(2 ** (CK.ORDER_AXIS_BITS - 1))).item()
    assert CK.ray_order_keys(d).tolist() == [0, half, half << 1]
    d[0, 0] = float("inf")
    assert CK.ray_order_keys(d).tolist() == [0, 0, half << 1]
    v, f = make_icosphere(subdivisions=2, radius=10.0)
    ms = build_mesh_state(v, f, device="cpu")
    rng = np.random.default_rng(1)
    d = torch.tensor(rng.normal(size=(300, 3)) * 0.1
                     + np.array([0.0, 0.0, 1.0]), dtype=torch.float32)
    o = torch.tensor([0.0, 0.0, -40.0]).expand(300, 3)
    h = CK.intersect_cuda(o, d, ms.vertices, ms.faces, ms.face_valid,
                          coherent=False)
    ref = _unsorted(o, d, ms.vertices, ms.faces, ms.face_valid)
    assert torch.equal(h.hit, ref.hit) and torch.equal(h.t, ref.t)
    assert int(h.hit.sum()) > 50


@pytest.fixture(scope="module")
def sphere_capture():
    res = (24, 32)
    gt_v, gt_f = make_icosphere(subdivisions=3, radius=50.0)
    cap = synthesize_capture(gt_v, gt_f, name="sphere", num_views=4,
                             resy=res[0], resx=res[1], ior=1.5,
                             num_view_used=4, device="cpu")
    v0, f0 = make_icosphere(subdivisions=2, radius=47.0)
    return res, cap, build_mesh_state(v0, f0, device="cpu")


def test_counter_counts_silhouette_views_only(sphere_capture):
    """The ray view's three queries (coherent camera rays, incoherent
    bounce 2 and exit) leave the counter at 0; each silhouette view adds 1;
    a coherent query of one origin keeps its route (no order)."""
    res, cap, ms = sphere_capture
    fn = get_intersect_fn("cuda")
    view = cap.views.take(0)
    kinds = []

    def spy(o, d, *args, coherent):
        before = kernels.counters.one_origin_queries
        h = fn(o, d, *args, coherent=coherent)
        kinds.append((coherent, kernels.counters.one_origin_queries - before))
        return h
    with torch.no_grad():
        ray_loss(ms, view, spy, 1.5, 1.0)
        assert kinds == [(True, 0), (False, 0), (False, 0)]
        silhouette_loss(ms, view, spy, 256, *res)
    assert kinds[3:] == [(False, 1)]
    d = torch.nn.functional.normalize(torch.randn(64, 3), dim=1)
    inp = CK.prepare_inputs(view[3][0].expand(64, 3), d, ms.vertices,
                            ms.faces,
                            ms.face_valid, coherent=True)
    assert inp.order is None
    assert inp.phi.shape[1] == CK.RAY_TILE_COHERENT


def test_one_origin_query_skips_the_resorted_route(sphere_capture):
    """incoherent="resort" keys on the origin, one point here: the query
    takes the one-origin route instead, with the same hits."""
    _, _, ms = sphere_capture
    d = torch.nn.functional.normalize(
        torch.randn(500, 3, generator=torch.Generator().manual_seed(2))
        + torch.tensor([0.0, 0.0, 3.0]), dim=1)
    o = torch.tensor([0.0, 0.0, -150.0]).expand(500, 3)
    geom = (ms.vertices, ms.faces, ms.face_valid)
    before = kernels.counters.one_origin_queries
    h = get_intersect_fn("cuda", incoherent="resort")(o, d, *geom,
                                                       coherent=False)
    assert kernels.counters.one_origin_queries == before + 1
    ref = _unsorted(o, d, ms.vertices, ms.faces, ms.face_valid)
    assert torch.equal(h.hit, ref.hit) and torch.equal(h.t, ref.t)


def test_train_step_equals_parent_route(sphere_capture):
    """Two sgd + none steps with the route and with the parent's route
    (every query's rays as separate rows, the shift the parent took): the
    loss and the whole state bit for bit."""
    res, cap, ms = sphere_capture
    w = LossWeights(ray_w=40.0, vh_w=2e-3, sm_w=0.08, ior=1.5)
    fn = get_intersect_fn("cuda")

    def parent(o, d, v, f, fv=None, *, coherent):
        if coherent or not one_origin(o):
            return fn(o, d, v, f, fv, coherent=coherent)
        return _unsorted(o.detach(), d.detach(), v.detach(), f, fv)
    out = []
    for oracle in (fn, parent):
        init, step, _ = make_train_step(oracle, w, *res, 256)
        st, losses = init(ms), []
        before = kernels.counters.one_origin_queries
        for ray, silh in ((1, [0, 1, 2, 3]), (3, [2, 2, 0, 1])):
            st, loss, _ = step(st, 0.05, ms, cap.views, ray, silh)
            losses.append(loss)
        out.append((losses, st, kernels.counters.one_origin_queries - before))
    (la, sa, na), (lb, sb, nb) = out
    assert (na, nb) == (8, 0)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k

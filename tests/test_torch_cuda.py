"""The three CUDA kernels of the oracle against their plain versions, on
the card. Marked `cuda`: it skips where torch sees no GPU. Run on a GPU
machine with `python -m pytest tests/test_torch_cuda.py -m cuda` (add
`--noconftest` where JAX is not installed). The closest-hit kernel and its
plain version round every product and sum alike, so their hits must agree
bit for bit; the prepass kernel must give the lists and counts of
`_candidates` (ray mode) and `_candidates_tile` (tile mode) exactly; the
packing kernel every output of `pack_plain` bit for bit (int32 views).
At the end, the train step as one CUDA graph (`GraphedTrainStep`) against
the eager step bit for bit, its launch counts (8 of each of
csrc/silhouette.cu's kernels a replay), its deferred bounds check and the
memory it gives back. Last, csrc/bounce.cu's four kernels (a
bounce's chain and the ray-loss tail, forward and backward) against
their plain versions bit for bit, float32 and float64, compat on and off,
Huber 0 and 0.1, on an empty batch, one lane, a batch that is no
multiple of the block, a full view's lanes and all lanes dead. Then the
oracle's one-origin route on the silhouette queries of the three dog
meshes: csrc/order.cu against `ray_order_plain`, the kernels through the
order against their plain versions, the route against the parent's route
and the brute oracle, the closest hit at other rays a warp, and a graphed
step against the parent's route, bit for bit. Then csrc/silhouette.cu's
three kernels (a silhouette view's chain before and after its query and
its backward) against their plain versions bit for bit on three views of
dog_mid20k, 45k and 90k at the step's budget and below the edge count,
float32 and float64, the mask read truncated and bilinear; a view with no
silhouette edge; and silhouette_loss on the card launching them.
Between them, the ray-mode prepass's cull by each tile's frustum: its
lists against the plain version's and its `kept` against
`frustum_kept_plain` on the step's bounce-2, exit and silhouette queries of
the three dog meshes, and on tiles of parked lanes, of every direction and
of one origin's cone."""

import os

import numpy as np
import pytest
import torch

import drt_tpu_torch.intersect.cuda_kernel as CK
from drt_tpu_torch.mesh import build_mesh_state, load_ply
# pytest puts tests/ on sys.path; `tests.meshes` could resolve to another
# installed package named `tests` on a GPU machine.
from meshes import make_cube, make_icosphere

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _rays(n, seed, inside):
    rng = np.random.default_rng(seed)
    if inside:
        o = rng.uniform(-20, 20, (n, 3))
        d = rng.normal(size=(n, 3))
    else:
        th = rng.uniform(0, 2 * np.pi, n)
        o = np.stack([np.cos(th), np.sin(th), 0.3 * np.ones(n)], 1) * 170
        d = rng.uniform(-25, 25, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32),
            torch.tensor(d, dtype=torch.float32))


@pytest.mark.parametrize("inside", [False, True])
def test_kernel_matches_plain_twin(dev, inside):
    v, f = make_icosphere(subdivisions=4, radius=50.0)
    ms = build_mesh_state(v, f, device=dev)
    o, d = (x.to(dev) for x in _rays(4096, 3, inside))
    inp = CK.prepare_inputs(o, d, ms.vertices, ms.faces, ms.face_valid,
                            coherent=not inside)
    before = CK.counters.launches
    t_k, id_k = CK.closest_hit(inp)
    torch.cuda.synchronize()
    assert CK.counters.launches == before + 1
    t_p, id_p = CK.closest_hit_plain(inp)
    assert int((id_k >= 0).sum()) > 500
    assert torch.equal(id_k, id_p)
    assert torch.equal(t_k, t_p)


@pytest.fixture(scope="module")
def dog20k(dev):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "reports", "tuning_meshes",
        "dog_mid20k.ply")
    return build_mesh_state(*load_ply(path), device=dev)


def _dog_rays(ms, n, seed, inside, dev):
    """Rays toward (or from inside) the mesh's bounding box; the inside
    rays keep unnormalised directions, every 7th ray is parked far away."""
    rng = np.random.default_rng(seed)
    v = ms.vertices[ms.vert_valid].cpu().numpy()
    c, ext = v.mean(0), np.ptp(v, axis=0).max()
    if inside:
        o = c + rng.uniform(-0.2, 0.2, (n, 3)) * ext
        d = rng.normal(size=(n, 3)) * rng.uniform(0.1, 30, (n, 1))
        o[::7] = c + 1e4
    else:
        u = rng.normal(size=(n, 3))
        o = c + 3 * ext * u / np.linalg.norm(u, axis=1, keepdims=True)
        d = c + rng.uniform(-0.4, 0.4, (n, 3)) * ext - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32, device=dev),
            torch.tensor(d, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("inside", [False, True])
def test_kernel_matches_plain_on_dog(dev, dog20k, inside):
    ms = dog20k
    o, d = _dog_rays(ms, 20000, 11, inside, dev)
    inp = CK.prepare_inputs(o, d, ms.vertices, ms.faces, ms.face_valid,
                            coherent=not inside)
    t_k, id_k = CK.closest_hit(inp)
    torch.cuda.synchronize()
    t_p, id_p = CK.closest_hit_plain(inp)
    assert int((id_k >= 0).sum()) > 2000
    assert torch.equal(id_k, id_p)
    assert torch.equal(t_k, t_p)


def _prepass_inputs(source, dev, dog20k=None):
    """(org, d, lo, hi, chunk_valid) of 64 x 256 incoherent rays against
    the icosphere (16 chunks), dog_mid20k (256 chunks) or 37 random boxes
    (a chunk count that is not a power of two, a quarter of them invalid)."""
    rng = np.random.default_rng(12)
    if source == "boxes":
        c = rng.uniform(-10, 10, (37, 3))
        h = rng.uniform(0.5, 3, (37, 3))
        lo, hi = (torch.tensor(x, dtype=torch.float32, device=dev)
                  for x in (c - h, c + h))
        cv = torch.tensor(rng.uniform(size=37) > 0.25, device=dev)
        o = torch.tensor(rng.uniform(-6, 6, (64 * 256, 3)),
                         dtype=torch.float32, device=dev)
        d = torch.tensor(rng.normal(size=(64 * 256, 3)), dtype=torch.float32,
                         device=dev)
    else:
        if source == "dog20k":
            ms = dog20k
        else:
            v, f = make_icosphere(subdivisions=3, radius=50.0)
            ms = build_mesh_state(v, f, device=dev)
        o, d = _dog_rays(ms, 64 * 256, 12, True, dev)
        shift = o.mean(dim=0)
        lo, hi, cv = CK._chunk_aabbs(ms.vertices, ms.faces, ms.face_valid,
                                     shift, CK.TRI_CHUNK)
        o = o - shift
    return o.t().contiguous(), d.t().contiguous(), lo, hi, cv


@pytest.mark.parametrize("source", ["icosphere", "dog20k", "boxes"])
@pytest.mark.parametrize("ray_tile", [64, 128, 256])
@pytest.mark.parametrize("mode", ["ray", "tile"])
def test_prepass_kernel_matches_candidates(dev, dog20k, mode, ray_tile,
                                           source):
    """Both modes of csrc/candidates.cu against their plain versions on the
    card (`_candidates`, `_candidates_tile`): the whole [T,NC] lists and the
    counts equal, one launch counted."""
    org, d, lo, hi, cv = _prepass_inputs(source, dev, dog20k)
    inv = CK._safe_inv(d)
    T = org.shape[1] // ray_tile
    plain = CK._candidates if mode == "ray" else CK._candidates_tile
    cand_p, count_p = plain(org.reshape(3, T, ray_tile).permute(1, 0, 2),
                            d.reshape(3, T, ray_tile).permute(1, 0, 2),
                            lo, hi, cv)
    assert int(count_p.max()) > 0 and not bool(cv.all())
    before = CK.counters.candidates_launches
    cand_k, count_k = CK.candidates_cuda(org, inv, lo, hi, cv, T,
                                         tile=mode == "tile")
    torch.cuda.synchronize()
    assert CK.counters.candidates_launches == before + 1
    assert torch.equal(count_k, count_p)
    assert torch.equal(cand_k, cand_p)


@pytest.mark.parametrize("nc", [6000, CK.MAX_CHUNKS])
@pytest.mark.parametrize("mode", ["ray", "tile"])
def test_prepass_kernel_at_large_chunk_counts(dev, mode, nc):
    """Above 48 KB of shared memory (the opt-in) and at the limit: one tile
    of 128 rays against `nc` random boxes, a tenth of them invalid, the
    whole list and the count equal to the plain version's. The tile mode's
    rays share a direction octant, or its frustum would take every box."""
    rng = np.random.default_rng(nc)
    c = rng.uniform(-10, 10, (nc, 3))
    h = rng.uniform(0.2, 1.0, (nc, 3))
    lo, hi = (torch.tensor(x, dtype=torch.float32, device=dev)
              for x in (c - h, c + h))
    cv = torch.tensor(rng.uniform(size=nc) > 0.1, device=dev)
    org = torch.tensor(rng.uniform(-3, 3, (3, 128)), dtype=torch.float32,
                       device=dev)
    d = rng.normal(size=(3, 128))
    if mode == "tile":
        d = np.abs(d) + 0.2
    inv = CK._safe_inv(torch.tensor(d, dtype=torch.float32, device=dev))
    cand_p, count_p = CK.candidates_plain(org, inv, lo, hi, cv, 1,
                                          tile=mode == "tile")
    assert 1000 < int(count_p[0]) < int(cv.sum())
    cand_k, count_k = CK.candidates_cuda(org, inv, lo, hi, cv, 1,
                                         tile=mode == "tile")
    torch.cuda.synchronize()
    assert torch.equal(count_k, count_p)
    assert torch.equal(cand_k, cand_p)


def test_prepass_kernel_refuses_too_many_chunks(dev):
    nc = CK.MAX_CHUNKS + 1
    org = torch.zeros(3, 128, device=dev)
    inv = torch.ones(3, 128, device=dev)
    box = torch.zeros(nc, 3, device=dev)
    cv = torch.ones(nc, dtype=torch.bool, device=dev)
    before = CK.counters.candidates_launches
    with pytest.raises(ValueError, match=f"at most MAX_CHUNKS = "
                                         f"{CK.MAX_CHUNKS}"):
        CK.candidates(org, inv, box, box, cv, 1, tile=False)
    assert CK.counters.candidates_launches == before


@pytest.mark.parametrize("coherent", [False, True])
def test_prepare_inputs_one_prepass_launch_per_query(dev, dog20k, coherent):
    ms = dog20k
    o, d = _dog_rays(ms, 20000, 11, not coherent, dev)
    before = (CK.counters.launches, CK.counters.candidates_launches)
    inp = CK.prepare_inputs(o, d, ms.vertices, ms.faces, ms.face_valid,
                            coherent=coherent)
    assert (CK.counters.launches,
            CK.counters.candidates_launches) == (before[0], before[1] + 1)
    T = inp.count.shape[0]
    lo, hi, cv = CK._chunk_aabbs(ms.vertices, ms.faces, ms.face_valid,
                                 o.mean(dim=0), CK.TRI_CHUNK)
    _, _, boxes = CK._grouped_boxes(lo, hi, cv, inp.group)
    cand, count = CK.candidates_plain(inp.phi[6:9], inp.inv, *boxes, T,
                                      tile=coherent)
    assert torch.equal(inp.cand, cand) and torch.equal(inp.count, count)


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("group", [1, 3, 4, 16])
@pytest.mark.parametrize("coherent", [False, True])
def test_grouped_kernels_match_plain(dev, dog20k, coherent, group, cut):
    """Both kernels with the launch arguments `group` and `t_min` (0, or the
    median t of the hits, which moves half of them to a farther surface)
    against their plain versions: the prepass's lists and counts over the
    group boxes (3 does not divide the 256 chunks), closest hit's t and
    tri_id bit for bit, one launch of each."""
    ms = dog20k
    geom = (ms.vertices, ms.faces, ms.face_valid)
    o, d = _dog_rays(ms, 20000, 11, not coherent, dev)
    t_min = 0.0
    if cut:
        h = CK.intersect_cuda(o, d, *geom, coherent=coherent, group=1)
        t_min = float(h.t[h.tri_id >= 0].median())
    before = (CK.counters.launches, CK.counters.candidates_launches)
    inp = CK.prepare_inputs(o, d, *geom, coherent=coherent, group=group,
                            t_min=t_min)
    t_k, id_k = CK.closest_hit(inp)
    torch.cuda.synchronize()
    assert (CK.counters.launches, CK.counters.candidates_launches) == (
        before[0] + 1, before[1] + 1)
    T = inp.count.shape[0]
    lo, hi, cv = CK._chunk_aabbs(*geom, o.mean(dim=0), CK.TRI_CHUNK)
    _, _, boxes = CK._grouped_boxes(lo, hi, cv, group)
    cand, count = CK.candidates_plain(inp.phi[6:9], inp.inv, *boxes, T,
                                      tile=coherent, t_min=t_min)
    assert torch.equal(inp.cand, cand) and torch.equal(inp.count, count)
    t_p, id_p = CK.closest_hit_plain(inp)
    assert torch.equal(id_k, id_p)
    assert torch.equal(t_k, t_p)
    assert int((id_k >= 0).sum()) > 1000
    assert bool((t_k[id_k >= 0] > t_min).all())


def test_group_none_above_a_lowered_cap(dev, dog20k, monkeypatch):
    """group=None groups a mesh above MAX_CHUNKS boxes: with the cap set to
    64, dog_mid20k's 256 chunks take groups of 4, and the hits are those of
    an explicit group=4 bit for bit."""
    ms = dog20k
    geom = (ms.vertices, ms.faces, ms.face_valid)
    o, d = _dog_rays(ms, 20000, 11, True, dev)
    want = CK.intersect_cuda(o, d, *geom, coherent=False, group=4)
    monkeypatch.setattr(CK, "MAX_CHUNKS", 64)
    assert CK.prepare_inputs(o, d, *geom, coherent=False).group == 4
    got = CK.intersect_cuda(o, d, *geom, coherent=False)
    assert torch.equal(got.tri_id, want.tri_id)
    assert torch.equal(got.t, want.t)


def test_tie_rule_on_the_card(dev):
    """Rows 38, 69 and 102 of chunk 0 and row 1 of chunk 1 hold one triangle
    (t equal to the bit), rows 33 and 64 the halves of a farther coplanar
    quad whose shared diagonal ray 2 crosses. In both ties the lowest row
    sits in a higher lane than another tied row (row = lane + 32 m): the
    warp's (t, row) minimum must be lexicographic, not the first lane's,
    and strict `<` across chunks keeps the first chunk, in a group of
    chunks too."""
    near = [[-1.0, -1, 2], [3, -1, 2], [-1, 3, 2]]
    quad = [[-1.0, -1, 4], [1, -1, 4], [1, 1, 4], [-1, 1, 4]]
    # off to the side, hit by no ray: they pull both chunks' boxes toward the
    # rays, chunk 0's nearer, so chunk 1 is entered, and entered second
    side = [[2.0, 2, z] for z in (0.5, 1.0)]
    side = [[[x, y, z], [x + 1, y, z], [x, y + 1, z]] for x, y, z in side]
    verts = torch.tensor(near + quad + side[0] + side[1],
                         dtype=torch.float32, device=dev)
    faces = torch.zeros(256, 3, dtype=torch.long, device=dev)
    valid = torch.zeros(256, dtype=torch.bool, device=dev)
    for row, tri in ((38, [0, 1, 2]), (69, [0, 1, 2]), (102, [0, 1, 2]),
                     (128 + 1, [0, 1, 2]), (33, [3, 4, 5]),
                     (64, [3, 5, 6]), (10, [7, 8, 9]),
                     (128 + 7, [10, 11, 12])):
        faces[row] = torch.tensor(tri, device=dev)
        valid[row] = True
    o = torch.zeros(64, 3, device=dev)
    d = torch.tensor([[0.0, 0.0, 1.0]], device=dev).repeat(64, 1)
    o[2] = torch.tensor([-0.5, -0.5, 3.0], device=dev)
    # group 4: one group of both chunks (and two of padding), walked in the
    # same order
    for order, group in (([33, 64], 1), ([64, 33], 1), ([33, 64], 4)):
        fc = faces.clone()
        fc[[33, 64]] = faces[order]
        inp = CK.prepare_inputs(o, d, verts, fc, valid, coherent=False,
                                group=group)
        t_k, id_k = CK.closest_hit(inp)
        torch.cuda.synchronize()
        t_p, id_p = CK.closest_hit_plain(inp)
        assert torch.equal(id_k, id_p) and torch.equal(t_k, t_p)
        assert id_k[:3].tolist() == [38, 38, 33]
        assert t_k[:3].tolist() == [2.0, 2.0, 1.0]


# --- the packing kernel -------------------------------------------------------

def _pack_case(name, vdtype, dev, n=1000, seed=9):
    """(vertices, faces, face_valid, shift, origins, dirs) on the card: the
    icosphere and the cube padded to power-of-two face arrays, dog_mid20k
    (the last chunk holds faces beyond F), dog_pillow_corrupt.ply with 1
    face in 64 degenerate and 1 in 10 invalid, and the icosphere with -0
    coordinates under a zero shift ("zeros"); `n` rays around the mesh,
    every 7th direction with a +0 and every 11th a -0 component."""
    rng = np.random.default_rng(seed)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shift = None
    if name in ("icosphere", "cube", "zeros"):
        v, f = (make_cube(size=80.0) if name == "cube"
                else make_icosphere(subdivisions=3, radius=50.0))
        ms = build_mesh_state(v, f, dtype=torch.float64, device="cpu")
        v, f, fv = (x.numpy() for x in (ms.vertices, ms.faces,
                                        ms.face_valid))
        if name == "zeros":
            v = np.where(v == 0, -0.0, v)
            v[::5, 0] = 0.0
            shift = torch.zeros(3, device=dev)
    else:
        path = (os.path.join(root, "reports", "tuning_meshes",
                             "dog_mid20k.ply") if name == "dog20k"
                else os.path.join(root, "tests", "fixtures",
                                  "dog_pillow_corrupt.ply"))
        v, f = load_ply(path)
        f = np.asarray(f, np.int64).copy()
        fv = np.ones(len(f), bool)
        if name == "pillow":
            f[::64, 2] = f[::64, 1]
            fv = rng.uniform(size=len(f)) > 0.1
    c, ext = v.mean(0), np.ptp(v, axis=0).max()
    o = torch.tensor(c + rng.normal(size=(n, 3)) * ext, dtype=torch.float32,
                     device=dev)
    d = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32,
                     device=dev)
    d[::7, 1] = 0.0
    d[::11, 2] = -0.0
    if shift is None:
        shift = o.mean(dim=0)
    return (torch.tensor(v, dtype=vdtype, device=dev),
            torch.tensor(f, device=dev), torch.tensor(fv, device=dev),
            shift, o, d)


def _assert_packed_equal(got, want):
    for field in CK.Packed._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert a.shape == b.shape and a.dtype == b.dtype, field
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), field


@pytest.mark.parametrize("coherent", [False, True])
@pytest.mark.parametrize("vdtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("group", [1, 4, 16])
@pytest.mark.parametrize("name", ["icosphere", "cube", "dog20k", "pillow",
                                  "zeros"])
def test_pack_kernel_matches_plain(dev, name, group, vdtype, coherent):
    """Every output of the packing kernel equals pack_plain's on the card,
    bit for bit as int32 views, with one launch."""
    args = _pack_case(name, vdtype, dev)
    rt = CK.RAY_TILE_COHERENT if coherent else CK.RAY_TILE_INCOHERENT
    before = CK.counters.pack_launches
    got = CK.pack_cuda(*args, group=group, ray_tile=rt)
    torch.cuda.synchronize()
    assert CK.counters.pack_launches == before + 1
    _assert_packed_equal(got, CK.pack_plain(*args, group=group,
                                            ray_tile=rt))
    assert (got.box_lo is got.lo) == (group == 1)


def test_pack_kernel_other_input_types(dev):
    """float64 rays, int32 faces and face_valid None (all valid) against the
    plain version; the full 2^20-ray view of one tile size."""
    v, f, fv, shift, o, d = _pack_case("dog20k", torch.float64, dev,
                                       n=2 ** 20 + 5, seed=3)
    for args in ((v, f.int(), fv, shift, o.double(), d.double()),
                 (v.float(), f, None, shift, o, d)):
        got = CK.pack_cuda(*args, group=4, ray_tile=128)
        torch.cuda.synchronize()
        _assert_packed_equal(got, CK.pack_plain(*args, group=4,
                                                ray_tile=128))


@pytest.mark.parametrize("coherent", [False, True])
def test_prepare_inputs_one_pack_launch_per_query(dev, dog20k, coherent):
    """A query launches the packing kernel once, and what it hands the
    other two kernels is pack_plain's."""
    ms = dog20k
    o, d = _dog_rays(ms, 20000, 11, not coherent, dev)
    before = CK.counters.pack_launches
    inp = CK.prepare_inputs(o, d, ms.vertices, ms.faces, ms.face_valid,
                            coherent=coherent)
    assert CK.counters.pack_launches == before + 1
    rt = CK.RAY_TILE_COHERENT if coherent else CK.RAY_TILE_INCOHERENT
    pk = CK.pack_plain(ms.vertices, ms.faces, ms.face_valid, o.mean(dim=0),
                       o, d, group=inp.group, ray_tile=rt)
    for field in ("phi", "inv", "coef", "lo", "hi"):
        assert torch.equal(getattr(inp, field).view(torch.int32),
                           getattr(pk, field).view(torch.int32)), field


def test_pack_kernel_raises_on_bad_input(dev):
    v, f, fv, shift, o, d = _pack_case("cube", torch.float32, dev)
    before = CK.counters.pack_launches
    for args in ((v.cpu(), f, fv, shift, o, d),
                 (v, f, fv, shift.double(), o, d),
                 (v, f.float(), fv, shift, o, d),
                 (v, f, fv, shift, o, d[:, :2])):
        with pytest.raises(ValueError):
            CK.pack_cuda(*args, group=1, ray_tile=128)
    assert CK.counters.pack_launches == before


def test_kernel_wrapper_raises_on_bad_input(dev):
    v, f = make_icosphere(subdivisions=2, radius=50.0)
    ms = build_mesh_state(v, f, device=dev)
    o, d = (x.to(dev) for x in _rays(512, 1, False))
    inp = CK.prepare_inputs(o, d, ms.vertices, ms.faces, ms.face_valid,
                            coherent=True)
    with pytest.raises(ValueError):
        CK.closest_hit_cuda(inp._replace(count=inp.count.cpu()))
    with pytest.raises(ValueError):
        CK.closest_hit_cuda(inp._replace(coef=inp.coef.double()))
    T = inp.count.shape[0]
    cv = torch.ones(inp.lo.shape[0], dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        CK.candidates_cuda(inp.phi[6:9].cpu(), inp.inv, inp.lo, inp.hi, cv,
                           T, tile=True)
    with pytest.raises(ValueError):
        CK.candidates_cuda(inp.phi[6:9], inp.inv, inp.lo, inp.hi, cv.int(),
                           T, tile=False)


# --- the routes and `optimize` on the card - ---------------------------------

def test_resorted_route_equals_per_ray_route(dev, dog20k):
    """Morton sort + tile prepass against the per-ray prepass: the same hits
    bit for bit, with one closest-hit and one prepass launch each."""
    from drt_tpu_torch.intersect import get_intersect_fn
    ms = dog20k
    o, d = _dog_rays(ms, 30001, 13, True, dev)
    geom = (ms.vertices, ms.faces, ms.face_valid)
    CK.counters.reset()
    h_ray = get_intersect_fn("cuda", incoherent="ray")(
        o, d, *geom, coherent=False)
    assert (CK.counters.launches, CK.counters.candidates_launches) == (1, 1)
    h_res = get_intersect_fn("cuda", incoherent="resort")(
        o, d, *geom, coherent=False)
    assert (CK.counters.launches, CK.counters.candidates_launches) == (2, 2)
    assert int(h_ray.hit.sum()) > 2000
    assert torch.equal(h_ray.tri_id, h_res.tri_id)
    assert torch.equal(h_ray.t, h_res.t)


def test_culled_backend_matches_kernel(dev, dog20k):
    from drt_tpu_torch.intersect import get_intersect_fn
    ms = dog20k
    o, d = _dog_rays(ms, 8192, 14, False, dev)
    geom = (ms.vertices, ms.faces, ms.face_valid)
    h_k = get_intersect_fn("cuda")(o, d, *geom, coherent=True)
    h_c = get_intersect_fn("culled")(o, d, *geom, coherent=True)
    n_hit = int((h_k.hit | h_c.hit).sum())
    assert n_hit > 2000
    assert int((h_k.tri_id != h_c.tri_id).sum()) <= max(1, 2 * n_hit // 1024)
    same = (h_k.tri_id == h_c.tri_id) & h_k.hit
    torch.testing.assert_close(h_c.t[same], h_k.t[same], rtol=1e-5,
                               atol=1e-4)


@pytest.fixture(scope="module")
def sphere_capture(dev):
    from drt_tpu_torch.data.synthetic import synthesize_capture
    gt_v, gt_f = make_icosphere(subdivisions=4, radius=50.0)
    cap = synthesize_capture(gt_v, gt_f, name="sphere", num_views=4,
                             resy=96, resx=128, ior=1.5, num_view_used=4,
                             device=dev)
    return gt_v, gt_f, cap


@pytest.mark.parametrize("one_shift", [False, True])
def test_chunked_step_matches_unchunked(dev, sphere_capture, one_shift):
    """One sgd + none step in chunks of 4,096 rays (3 chunks of the 12,288-
    ray view) against the unchunked step from the same state, and the launch
    counts of a backward that reruns the oracle. As the step runs it, each
    chunk's oracle shifts the scene by its own mean ray origin, so a float32
    shared-edge tie may fall the other way for a ray or two of the few
    thousand: loss at rtol 1e-3, the raw gradient within 1e-2 of its largest
    entry. With one shift handed to every query the chunking stands alone:
    loss at rtol 1e-5, gradient within 1e-4 (float32 sums reassociated across
    chunks; tests/test_torch_chunked.py holds float64 to 1e-10)."""
    from drt_tpu_torch.intersect import get_intersect_fn
    from drt_tpu_torch.optimize import LossWeights, make_train_step
    gt_v, gt_f, cap = sphere_capture
    v0, f0 = make_icosphere(subdivisions=3, radius=47.0)
    ms = build_mesh_state(v0, f0, device=dev)
    w = LossWeights(ray_w=40.0, vh_w=2e-3, sm_w=0.08, ior=1.5)
    fn = get_intersect_fn("auto")
    if one_shift:
        shift = torch.zeros(3, device=dev)

        def fn(o, d, v, f, fv=None, *, coherent):
            return CK.intersect_cuda(o.detach(), d.detach(), v.detach(), f,
                                     fv, coherent=coherent, shift=shift)
    out = {}
    for chunk, launches in ((0, (3 + 4, 3 + 4)),
                            (4096, (2 * 3 * 3 + 4, 2 * 3 * 3 + 4))):
        init, step, _ = make_train_step(fn, w, 96, 128, 1024,
                                        grad_clamp=0.0, ray_chunk=chunk)
        CK.counters.reset()
        st, loss, _ = step(init(ms), 0.1, ms, cap.views, 1, [0, 1, 2, 3])
        assert (CK.counters.launches,
                CK.counters.candidates_launches) == launches
        out[chunk] = (float(loss), st["m"])
    (l0, g0), (l1, g1) = out[0], out[4096]
    l_tol, g_tol = (1e-5, 1e-4) if one_shift else (1e-3, 1e-2)
    assert abs(l1 - l0) <= l_tol * abs(l0)
    assert float((g1 - g0).abs().max()) <= g_tol * float(g0.abs().max())


def test_optimize_one_pass_with_remesh_on_the_card(dev, sphere_capture,
                                                   tmp_path):
    from drt_tpu_torch.config import HyperParams
    from drt_tpu_torch.optimize import optimize
    gt_v, gt_f, cap = sphere_capture
    v0, f0 = make_icosphere(subdivisions=3, radius=47.0)
    hp = HyperParams(name="sphere", ior=1.5, num_passes=1, iters=4,
                     start_len=4.0, end_len=4.0, num_view=4,
                     optimizer="uadam", precond="h1")
    info = {}
    CK.counters.reset()
    out = optimize(hp, cap, v0, f0, remesh_fn="isotropic",
                   checkpoint_dir=str(tmp_path), log_fn=lambda s: None,
                   run_info=info, device=dev)
    assert out.vertices.is_cuda and bool(torch.isfinite(out.vertices).all())
    assert out.num_faces != len(f0) and info["remesh_failures"] == 0
    assert CK.counters.launches == CK.counters.candidates_launches == 4 * 11
    assert os.listdir(tmp_path) == ["sphere_pass00.ply"]
    v_ck, f_ck = load_ply(str(tmp_path / "sphere_pass00.ply"))
    assert len(f_ck) == out.num_faces


def test_carve_occupancy_card_matches_cpu(dev, sphere_capture):
    """The occupancy of the sphere capture's views on the card against the
    CPU: field within 1e-6, `seen` equal, at most 1 in 10^4 voxels on the
    other side of 0.5 and each within 1e-5 of it. The projection and blend
    are elementwise with their roundings pinned, so neither a matmul order
    nor TF32 can move them: the flag stays off, and turning it on changes
    nothing."""
    from drt_tpu_torch.data.carve import carve_occupancy, rig_working_volume
    _, _, cap = sphere_capture
    assert torch.backends.cuda.matmul.allow_tf32 is False
    lo, hi = rig_working_volume(cap)
    v = cap.views
    fk, sk, _, _ = carve_occupancy(v.mask, v.R, v.K, lo, hi, 96, device=dev)
    fc, sc, _, _ = carve_occupancy(v.mask.cpu(), v.R.cpu(), v.K.cpu(), lo,
                                   hi, 96, device="cpu")
    np.testing.assert_array_equal(sk, sc)
    assert float(np.abs(fk - fc).max()) <= 1e-6
    flipped = (fk > 0.5) != (fc > 0.5)
    assert int(flipped.sum()) <= 1e-4 * fk.size
    if flipped.any():
        assert float(np.abs(fc[flipped] - 0.5).max()) <= 1e-5
    assert 0 < int((fk > 0.5).sum()) < fk.size
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ft, _, _, _ = carve_occupancy(v.mask, v.R, v.K, lo, hi, 96,
                                      device=dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    np.testing.assert_array_equal(ft, fk)


def test_cli_render_on_the_card(dev, tmp_path, capsys):
    """`render` through the kernels: 4 closest-hit and 4 prepass launches
    (mask, two bounces, exit) and three PNGs."""
    from drt_tpu_torch.cli import main
    from drt_tpu_torch.mesh import save_ply
    v, f = make_icosphere(subdivisions=3, radius=40.0)
    src = str(tmp_path / "ball.ply")
    save_ply(src, v, f)
    CK.counters.reset()
    main(["render", "--mesh", src, "--res", "64", "--backend", "cuda",
          "--out-dir", str(tmp_path / "img")])
    assert (CK.counters.launches, CK.counters.candidates_launches) == (4, 4)
    assert sorted(os.listdir(tmp_path / "img")) == [
        "ball_exitdir.png", "ball_mask.png", "ball_valid.png"]
    assert "wrote ball_mask/valid/exitdir.png" in capsys.readouterr().out


def _scatter_inputs(n_rows, n_cols, num, dtype, seed, heavy):
    """rows [R,C], idx [R] int64 on the CPU from a numpy seed. heavy: half
    of the rows on destination 0, 90% of the rows all +0 or all -0 (the
    dead lanes of a view), some entries -0, the last destination empty."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, max(num - 1, 1), n_rows)
    rows = rng.standard_normal((n_rows, n_cols))
    if heavy:
        idx[rng.random(n_rows) < 0.5] = 0
        zero = rng.random(n_rows) < 0.9
        rows[zero] = np.where(rng.random((int(zero.sum()), 1)) < 0.5, 0.0,
                              -0.0)
        rows[rng.random((n_rows, n_cols)) < 0.05] = -0.0
    return (torch.from_numpy(rows).to(dtype), torch.from_numpy(idx))


def _same_bits(a, b):
    view = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.shape == b.shape and torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("shape", [(5000, 3, 700), (300000, 9, 65536),
                                   (200000, 3, 70000), (4096, 1, 300),
                                   (0, 3, 10), (7, 9, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scatter_kernel_matches_cpu_plain(dev, dtype, shape, heavy):
    """The scatter kernel against scatter_rows_plain run on the CPU, bit for
    bit (int views): 1, 2 and 3 radix passes (700, 65,536 and 70,000
    destinations), many tiles, random and duplicate-heavy indices, C = 1, 3,
    9, no rows; one launch counted; a second run gives the same bits."""
    from drt_tpu_torch.geometry.scatter import (scatter_rows,
                                                scatter_rows_plain)
    n_rows, n_cols, num = shape
    rows, idx = _scatter_inputs(n_rows, n_cols, num, dtype, 4, heavy)
    want = scatter_rows_plain(rows, idx, num)
    before = CK.counters.scatter_launches
    got = scatter_rows(rows.to(dev), idx.to(dev), num)
    again = scatter_rows(rows.to(dev), idx.to(dev), num)
    torch.cuda.synchronize()
    assert CK.counters.scatter_launches == before + 2
    assert _same_bits(got.cpu(), want)
    assert _same_bits(again, got)


def test_scatter_kernel_raises_on_bad_input(dev):
    from drt_tpu_torch.geometry.scatter import scatter_rows_cuda
    rows = torch.ones(8, 3, device=dev)
    idx = torch.zeros(8, dtype=torch.int64, device=dev)
    for bad_rows, bad_idx in ((rows.half(), idx), (rows, idx.int()),
                              (rows[:, 0], idx), (rows, idx[:5]),
                              (rows.t(), idx), (torch.ones(8, 17, device=dev),
                                                idx), (rows, idx.cpu())):
        with pytest.raises(ValueError):
            scatter_rows_cuda(bad_rows, bad_idx, 4)


@pytest.mark.parametrize("bad", [4, 1000, -1, -4])
def test_scatter_kernel_raises_on_index_out_of_range(dev, bad):
    """An index outside [0, num), negative or too large, raises on the card
    as in the CPU plain version (`index_add_`), whether its row is live or
    all zeros; the launch is counted, and a good call after it runs."""
    from drt_tpu_torch.geometry.scatter import (gather_rows, scatter_rows,
                                                scatter_rows_plain)
    rows, idx = _scatter_inputs(5000, 3, 4, torch.float32, 5, True)
    idx[[17, 4000]] = bad
    with pytest.raises(RuntimeError, match="out of bounds"):
        scatter_rows_plain(rows, idx, 4)
    before = CK.counters.scatter_launches
    for r in (rows, torch.zeros_like(rows)):
        with pytest.raises(RuntimeError, match="out of bounds"):
            scatter_rows(r.to(dev), idx.to(dev), 4)
    assert CK.counters.scatter_launches == before + 2
    # gather_rows wraps a negative index forward, as x[idx] does, and its
    # backward raises on it on both devices
    x = torch.ones(4, 3, dtype=torch.float64, requires_grad=True)
    for d in ("cpu", dev):
        if bad < 0:
            y = gather_rows(x.to(d), idx.to(d))
            with pytest.raises(RuntimeError, match="out of bounds"):
                y.sum().backward()
    good = idx.clamp(0, 3)
    assert _same_bits(scatter_rows(rows.to(dev), good.to(dev), 4).cpu(),
                      scatter_rows_plain(rows, good, 4))


def test_step_scatters_match_cpu_plain(dev, sphere_capture):
    """Every scatter of one sgd + none step on the card (the normals, the
    silhouette and dihedral gathers' backward, both bounces' `_gather_tri9`
    backward on its soup route), recorded and held against scatter_rows_plain
    on the CPU bit for bit; the launches counted are the recorded calls; the
    step makes no other vertex scatter than these."""
    from drt_tpu_torch.geometry import scatter as S
    from drt_tpu_torch.intersect import get_intersect_fn
    from drt_tpu_torch.optimize import LossWeights, make_train_step
    _, _, cap = sphere_capture
    v0, f0 = make_icosphere(subdivisions=3, radius=47.0)
    ms = build_mesh_state(v0, f0, device=dev)
    w = LossWeights(ray_w=40.0, vh_w=2e-3, sm_w=0.08, ior=1.5)
    init, step, _ = make_train_step(get_intersect_fn("auto"), w, 96, 128,
                                    1024)
    calls, real = [], S.scatter_rows_cuda

    def spy(rows, idx, num):
        out = real(rows, idx, num)
        calls.append((rows.clone(), idx.clone(), num, out.clone()))
        return out
    S.scatter_rows_cuda = spy
    try:
        CK.counters.reset()
        step(init(ms), 0.1, ms, cap.views, 1, [0, 1, 2, 3])
        torch.cuda.synchronize()
    finally:
        S.scatter_rows_cuda = real
    # normals 1, silhouette 4, dihedral 1, two bounces x 2 (soup route)
    assert len(calls) == CK.counters.scatter_launches == 1 + 4 + 1 + 2 * 2
    for rows, idx, num, out in calls:
        assert _same_bits(out.cpu(), S.scatter_rows_plain(rows.cpu(),
                                                          idx.cpu(), num))


def _scatter_both_routes(rows, idx, num, dev):
    """The kernel's output on each route (forced through `route`), each
    launch counted once on its route's counter."""
    from drt_tpu_torch.geometry.scatter import ROUTES, scatter_rows_cuda
    c = CK.counters
    outs = {}
    for route in ROUTES:
        before = (c.scatter_launches, c.scatter_cluster_launches,
                  c.scatter_grid_launches)
        outs[route] = scatter_rows_cuda(rows.to(dev), idx.to(dev), num,
                                        route=route)
        torch.cuda.synchronize()
        after = (c.scatter_launches, c.scatter_cluster_launches,
                 c.scatter_grid_launches)
        assert after == (before[0] + 1,
                         before[1] + (route == "cluster"),
                         before[2] + (route == "grid"))
    return outs


def _plain_cpu(rows, idx, num):
    from drt_tpu_torch.geometry.scatter import scatter_rows_plain
    return scatter_rows_plain(rows, idx, num)


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("num", [1, 256, 257, 65536, 65537, 2 ** 24])
@pytest.mark.parametrize("n_cols", [1, 3, 9, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scatter_routes_match_cpu_plain(dev, dtype, n_cols, num, heavy):
    """Both routes of the scatter kernel, forced through `route`, against
    scatter_rows_plain on the CPU bit for bit (int views): 1, 2 and 3 radix
    passes (up to 256, 65,536 and 2^24 destinations), C = 1 to 16, 40,000
    rows over 10 tiles of the grid route and every CTA of the cluster,
    random and duplicate-heavy indices; the last destination gets no row,
    so zeros are written too."""
    rows, idx = _scatter_inputs(40000, n_cols, num, dtype, 6, heavy)
    want = _plain_cpu(rows, idx, num)
    for route, got in _scatter_both_routes(rows, idx, num, dev).items():
        assert _same_bits(got.cpu(), want), route



@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_scatter_routes_at_the_cap(dev, delta):
    """At CLUSTER_MAX_ROWS - 1, CLUSTER_MAX_ROWS and CLUSTER_MAX_ROWS + 1
    rows: `scatter_route` takes the cluster route up to the cap and the
    grid route above it, the default call counts a launch on that route,
    and both routes give the CPU plain version's bits."""
    from drt_tpu_torch.geometry.scatter import (CLUSTER_MAX_ROWS,
                                                scatter_route, scatter_rows)
    n_rows = CLUSTER_MAX_ROWS + delta
    rows, idx = _scatter_inputs(n_rows, 3, 32768, torch.float32, 7, True)
    want = _plain_cpu(rows, idx, 32768)
    route = scatter_route(n_rows, 3, 32768)
    assert route == ("grid" if delta > 0 else "cluster")
    c = CK.counters
    before = (c.scatter_cluster_launches, c.scatter_grid_launches)
    got = scatter_rows(rows.to(dev), idx.to(dev), 32768)
    torch.cuda.synchronize()
    assert (c.scatter_cluster_launches - before[0],
            c.scatter_grid_launches - before[1]) == (
        (0, 1) if route == "grid" else (1, 0))
    assert _same_bits(got.cpu(), want)
    for r, out in _scatter_both_routes(rows, idx, 32768, dev).items():
        assert _same_bits(out.cpu(), want), r


@pytest.mark.parametrize("case", ["all dead", "nan and -0", "heavy"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scatter_routes_dead_nan_and_signed_zeros(dev, dtype, case):
    """Both routes on rows that are all +-0 (every output element +0), on
    rows with NaN entries (live: the NaN reaches its destination) and -0
    entries, and on `_scatter_inputs(heavy=True)`: the CPU plain version's
    bits, and the same bits from each route and from a second run."""
    rows, idx = _scatter_inputs(70000, 9, 3000, dtype, 8, True)
    if case == "all dead":
        rows = torch.where(torch.rand(rows.shape[0], 1,
                                      generator=torch.Generator()
                                      .manual_seed(1)) < 0.5,
                           torch.zeros_like(rows), -torch.zeros_like(rows))
    elif case == "nan and -0":
        rng = np.random.default_rng(9)
        nan = torch.from_numpy(rng.random(rows.shape) < 0.001)
        rows = torch.where(nan, torch.full_like(rows, float("nan")), rows)
        rows[::97] = -0.0
    want = _plain_cpu(rows, idx, 3000)
    if case == "all dead":
        assert _same_bits(want, torch.zeros_like(want))
    if case == "nan and -0":
        assert torch.isnan(want).any()
    first = _scatter_both_routes(rows, idx, 3000, dev)
    again = _scatter_both_routes(rows, idx, 3000, dev)
    for route in first:
        assert _same_bits(first[route].cpu(), want), route
        assert _same_bits(again[route], first[route]), route


@pytest.mark.parametrize("route", ["cluster", "grid"])
@pytest.mark.parametrize("bad", [4, 1000, -1, -4])
def test_scatter_routes_raise_on_index_out_of_range(dev, route, bad):
    """An index outside [0, num) raises on either route, whether its row is
    live or all zeros; the launch is counted; a good call on the same route
    after it gives the plain version's bits (the cluster route writes its
    flag with no clear before it, on fresh scratch every call)."""
    from drt_tpu_torch.geometry.scatter import scatter_rows_cuda
    rows, idx = _scatter_inputs(5000, 3, 4, torch.float32, 5, True)
    idx[[17, 4000]] = bad
    before = CK.counters.scatter_launches
    for r in (rows, torch.zeros_like(rows)):
        with pytest.raises(RuntimeError, match="out of bounds"):
            scatter_rows_cuda(r.to(dev), idx.to(dev), 4, route=route)
    assert CK.counters.scatter_launches == before + 2
    good = idx.clamp(0, 3)
    for _ in range(3):
        got = scatter_rows_cuda(rows.to(dev), good.to(dev), 4, route=route)
        assert _same_bits(got.cpu(), _plain_cpu(rows, good, 4))


def test_scatter_cluster_size_and_unknown_route(dev):
    """The cluster route's CTAs a cluster (a power of two up to 16, from
    the card's occupancy), and a route the kernel lacks raises before any
    launch."""
    from drt_tpu_torch.geometry.scatter import cluster_size, scatter_rows_cuda
    n = cluster_size()
    assert n in (1, 2, 4, 8, 16)
    rows = torch.ones(8, 3, device=dev)
    idx = torch.zeros(8, dtype=torch.int64, device=dev)
    before = CK.counters.scatter_launches
    with pytest.raises(ValueError, match="route"):
        scatter_rows_cuda(rows, idx, 4, route="atomics")
    assert CK.counters.scatter_launches == before


# --- the train step as one CUDA graph (optimize/loop.py GraphedTrainStep) --

def _graph_case(sphere_capture, dev, optimizer, precond, ray_chunk=-1):
    from drt_tpu_torch.intersect import get_intersect_fn
    from drt_tpu_torch.optimize import LossWeights, make_train_step
    _, _, cap = sphere_capture
    v0, f0 = make_icosphere(subdivisions=3, radius=47.0)
    ms = build_mesh_state(v0, f0, device=dev)
    w = LossWeights(ray_w=40.0, vh_w=2e-3, sm_w=0.08, ior=1.5)
    init, step, _ = make_train_step(get_intersect_fn("auto"), w, 96, 128,
                                    1024, optimizer=optimizer,
                                    precond=precond, ray_chunk=ray_chunk)
    ray = [[1], [3], [0], [2]]
    silh = [[0, 1, 2, 3, 0, 1, 2, 3], [3, 2, 1, 0, 1, 1, 2, 2],
            [2, 0, 3, 1, 1, 0, 3, 2], [1, 1, 1, 1, 2, 2, 2, 2]]
    return step, init(ms), ms, cap.views, ray, silh


@pytest.mark.parametrize("case", ["sgd+none", "adam+none", "uadam+h1",
                                  "sgd+sobolev", "sgd+none chunked"])
def test_graphed_steps_equal_eager_steps(dev, sphere_capture, case):
    """4 steps through GraphedTrainStep (1 eager warm-up, the capture, 3
    replays) against 4 eager steps from the same state and views: params,
    m, v and the loss equal bit for bit after every step, and each replay
    adds one step's launches to the counters (11 of each oracle kernel in
    the unchunked step: 3 ray queries and 8 silhouette views, of which 10
    prepasses in ray mode, counted in `prepass_cull_launches`)."""
    from drt_tpu_torch.optimize.loop import GraphedTrainStep
    pair, _, chunked = case.partition(" ")
    optimizer, precond = pair.split("+")
    step, state, ms, views, ray, silh = _graph_case(
        sphere_capture, dev, optimizer, precond,
        ray_chunk=4096 if chunked else -1)
    lr = 0.05 if optimizer == "sgd" else 0.01
    eager = []
    st = state
    for r, s in zip(ray, silh):
        st, loss, _ = step(st, lr, ms, views, r, s)
        eager.append((float(loss), {k: v.clone() for k, v in st.items()}))
    run = GraphedTrainStep(step, state, lr, ms, views,
                           torch.tensor(ray, device=dev),
                           torch.tensor(silh, device=dev))
    per_step = None
    for it, (loss_e, st_e) in enumerate(eager):
        before = CK.counters.snapshot()
        loss, _ = run()
        torch.cuda.synchronize()
        launched = {k: CK.counters.snapshot()[k] - before[k]
                    for k in before}
        if it == 0:
            per_step = launched
            if not chunked:
                assert launched["launches"] == 11
                # the ray mode's, culled: bounce 2, exit, 8 silhouettes
                assert launched["prepass_cull_launches"] == 10
            # csrc/silhouette.cu: one of each kernel a silhouette view
            for k in ("silhouette_pre_launches", "silhouette_post_launches",
                      "silhouette_backward_launches"):
                assert launched[k] == 8, (k, launched[k])
        else:
            assert launched == per_step, it
        assert float(loss) == loss_e, it
        for k in ("params", "m", "v", "v_per", "count", "silh_max"):
            assert torch.equal(run.state[k], st_e[k]), (it, k)
    out = run.close()
    assert torch.equal(out["params"], eager[-1][1]["params"])
    assert int(run.bounds_word) == 0
    assert run.setup["pool_bytes"] > 0 and run.setup["capture_s"] > 0


def test_graphed_step_defers_an_index_out_of_range(dev, sphere_capture,
                                                   monkeypatch):
    """A scatter given an index past its output inside the graphed step
    (added to the loss's forward) raises nothing at its calls (warm-up,
    capture, replays); the word the wrapper owns holds it, and `optimize`
    raises RuntimeError at the pass's one read, after every step ran."""
    import drt_tpu_torch.optimize.loop as LOOP
    from drt_tpu_torch.config import HyperParams
    from drt_tpu_torch.geometry.scatter import scatter_rows
    from drt_tpu_torch.optimize import optimize
    real = LOOP.total_loss
    rows = torch.ones(4, 3, device=dev)
    idx = torch.tensor([0, 1, 2, 4], device=dev)          # 4 of 4: too far

    def bad_total_loss(mesh, *args, **kwargs):
        scatter_rows(rows, idx, 4)
        return real(mesh, *args, **kwargs)
    step, state, ms, views, ray, silh = _graph_case(sphere_capture, dev,
                                                    "sgd", "none")
    monkeypatch.setattr(LOOP, "total_loss", bad_total_loss)
    run = LOOP.GraphedTrainStep(step, state, 0.05, ms, views,
                                torch.tensor(ray, device=dev),
                                torch.tensor(silh, device=dev))
    for _ in ray:
        run()
    run.close()
    assert int(run.bounds_word) == 1
    _, _, cap = sphere_capture
    v0, f0 = make_icosphere(subdivisions=3, radius=47.0)
    hp = HyperParams(name="sphere", ior=1.5, num_passes=1, iters=4,
                     start_len=4.0, end_len=4.0, num_view=4)
    lines = []
    with pytest.raises(RuntimeError, match="out of bounds"):
        optimize(hp, cap, v0, f0, log_fn=lines.append, log_every=1,
                 device=dev)
    assert sum("iter" in ln for ln in lines) == 4   # every step ran first


def test_graph_memory_returns_after_the_pass(dev, sphere_capture):
    """What a pass's graph holds (its memory pool, its outputs) is given
    back when the pass closes it: from one pass to the next, the memory
    allocated after a pass and the memory reserved do not grow."""
    from drt_tpu_torch.optimize.loop import GraphedTrainStep
    step, state, ms, views, ray, silh = _graph_case(sphere_capture, dev,
                                                    "sgd", "none")
    allocated, reserved, pools = [], [], []
    for _ in range(3):
        run = GraphedTrainStep(step, state, 0.05, ms, views,
                               torch.tensor(ray, device=dev),
                               torch.tensor(silh, device=dev))
        for _ in ray:
            loss, aux = run()
        del loss, aux
        out = run.close()
        pools.append(run.setup["pool_bytes"])
        del run, out
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated(dev))
        reserved.append(torch.cuda.memory_reserved(dev))
    assert min(pools) > 0
    assert allocated[2] == allocated[1] <= allocated[0] + 2 ** 16
    assert reserved[2] <= reserved[1] <= reserved[0] + 2 ** 21


# -- the Sobolev preconditioner's CG solve (csrc/cg.cu) ----------------------

def _cg_case(source, dtype, dev, seed, dog20k=None):
    """(b, neighbors, neighbor_valid, x0) on `source`'s neighbour table."""
    from drt_tpu_torch.optimize import precondition as PC  # noqa: F401
    if source == "dog20k":
        ms = dog20k
    else:
        v, f = (make_icosphere(subdivisions=3, radius=10.0)
                if source == "icosphere" else make_cube(size=4.0))
        ms = build_mesh_state(v, f, device=dev)
    rng = np.random.default_rng(seed)
    shape = tuple(ms.vertices.shape)
    b = torch.tensor(rng.normal(size=shape), dtype=dtype, device=dev)
    x0 = torch.tensor(0.1 * rng.normal(size=shape), dtype=dtype, device=dev)
    return b, ms.neighbors, ms.neighbor_valid, x0


def _cg_bits(a, b):
    iv = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(iv), b.view(iv))


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("maxiter,tol", [(64, 1e-6), (256, 1e-8),
                                         (64, 1e-3), (0, 1e-6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("source", ["icosphere", "cube", "dog20k"])
def test_cg_kernel_matches_plain(dev, dog20k, source, dtype, maxiter, tol,
                                 given):
    """One launch a solve, the plain version's bits and trip count on the
    card, and the same bits from a second launch."""
    from drt_tpu_torch import kernels
    from drt_tpu_torch.optimize import precondition as PC
    b, nbr, valid, x0 = _cg_case(source, dtype, dev, 7, dog20k)
    x0 = x0 if given else None
    before = kernels.counters.cg_launches
    xk, tk = PC.cg_cuda(b, nbr, valid, 29.0, tol=tol, maxiter=maxiter,
                        x0=x0)
    torch.cuda.synchronize()
    assert kernels.counters.cg_launches == before + 1
    xk2, tk2 = PC.cg_cuda(b, nbr, valid, 29.0, tol=tol, maxiter=maxiter,
                          x0=x0)
    xp, tp = PC.cg_plain(b, nbr, valid, 29.0, tol=tol, maxiter=maxiter,
                         x0=x0)
    assert int(tk) == int(tp) == int(tk2) <= maxiter
    assert _cg_bits(xk, xp)
    assert _cg_bits(xk, xk2)


@pytest.mark.parametrize("case", ["zero rhs", "one thread's share",
                                  "no neighbours", "nan"])
def test_cg_kernel_edge_cases(dev, case):
    """b = 0 (no trip), a vector below one element a thread, a table
    without valid entries (A = I), and a NaN in b (no trip runs)."""
    from drt_tpu_torch.optimize import precondition as PC
    b, nbr, valid, _ = _cg_case("cube", torch.float32, dev, 8)
    if case == "zero rhs":
        b = torch.zeros_like(b)
    elif case == "one thread's share":
        b, nbr, valid = b[:5].contiguous(), nbr[:5] % 5, valid[:5]
        nbr, valid = nbr.contiguous(), valid.contiguous()
    elif case == "no neighbours":
        valid = torch.zeros_like(valid)
    else:
        b[3, 1] = float("nan")
    xk, tk = PC.cg_cuda(b, nbr, valid, 9.0, tol=1e-6, maxiter=20)
    xp, tp = PC.cg_plain(b, nbr, valid, 9.0, tol=1e-6, maxiter=20)
    assert int(tk) == int(tp)
    assert _cg_bits(xk, xp)
    if case == "zero rhs":
        assert int(tk) == 0 and not xk.any()
    if case == "no neighbours":
        assert int(tk) == 1 and _cg_bits(xk, b)


def test_sobolev_solve_on_the_card_equals_plain_with_gradient(dev, dog20k):
    """sobolev_solve on CUDA tensors launches the kernel (forward and
    backward), and its value and input gradient are the plain version's
    bits on the card."""
    from drt_tpu_torch import kernels
    from drt_tpu_torch.optimize import precondition as PC
    b, nbr, valid, _ = _cg_case("dog20k", torch.float32, dev, 9, dog20k)
    w = torch.randn(b.shape, generator=torch.Generator().manual_seed(1)).to(
        dev)
    u = b.clone().requires_grad_(True)
    before = kernels.counters.cg_launches
    v = PC.sobolev_solve(u, nbr, valid, 29.0, maxiter=64)
    (g,) = torch.autograd.grad((v * w).sum(), u)
    assert kernels.counters.cg_launches == before + 2
    vp, _ = PC.cg_plain(b, nbr, valid, 29.0, tol=1e-6, maxiter=64)
    gp, _ = PC.cg_plain(w, nbr, valid, 29.0, tol=1e-6, maxiter=64)
    assert _cg_bits(v.detach(), vp)
    assert _cg_bits(g, gp)


def test_cg_kernel_in_a_cuda_graph(dev, dog20k):
    """A captured launch replays to the eager launch's bits, and the capture
    waits on nothing."""
    from drt_tpu_torch.optimize import precondition as PC
    b, nbr, valid, _ = _cg_case("dog20k", torch.float32, dev, 10, dog20k)
    eager, trips = PC.cg_cuda(b, nbr, valid, 29.0, tol=1e-6, maxiter=64)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        PC.cg_cuda(b, nbr, valid, 29.0, tol=1e-6, maxiter=64)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        xg, tg = PC.cg_cuda(b, nbr, valid, 29.0, tol=1e-6, maxiter=64)
    graph.replay()
    torch.cuda.synchronize()
    assert _cg_bits(xg, eager) and int(tg) == int(trips)


def test_cg_kernel_raises_on_bad_input(dev):
    from drt_tpu_torch.optimize import precondition as PC
    b, nbr, valid, _ = _cg_case("cube", torch.float32, dev, 11)
    with pytest.raises(ValueError):
        PC.cg_cuda(b, nbr.cpu(), valid, 1.0)
    with pytest.raises(ValueError):
        PC.cg_cuda(b, nbr, valid, 1.0, maxiter=-1)
    with pytest.raises(ValueError):
        PC.cg_cuda(b[:, :2], nbr, valid, 1.0)


def test_cg_kernel_takes_negative_entries_as_torch_indexing_does(dev):
    """A valid entry in [-Vp, 0) is x[n + Vp] in the kernel, as torch's
    indexing in the plain version takes it: the same bits as the table
    written with n + Vp."""
    from drt_tpu_torch.optimize import precondition as PC
    b, nbr, valid, _ = _cg_case("icosphere", torch.float32, dev, 12)
    rows = torch.arange(nbr.shape[0], device=dev)[:, None] % 2 == 0
    neg = torch.where(valid & rows, nbr - nbr.shape[0], nbr)
    assert (neg < 0).any()
    xn, tn = PC.cg_cuda(b, neg, valid, 29.0, tol=1e-6, maxiter=64)
    xw, tw = PC.cg_cuda(b, nbr, valid, 29.0, tol=1e-6, maxiter=64)
    xp, tp = PC.cg_plain(b, neg, valid, 29.0, tol=1e-6, maxiter=64)
    assert int(tn) == int(tw) == int(tp)
    assert _cg_bits(xn, xw) and _cg_bits(xn, xp)


# -- csrc/cg.cu's two routes ---------------------------------------------------

@pytest.fixture(scope="module")
def dogs(dev, dog20k):
    """dog_mid{20k,45k,90k}'s mesh states on the card (Vp 16,384, 32,768
    and 65,536; 8 neighbours)."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = {"dog20k": dog20k}
    for name in ("dog45k", "dog90k"):
        path = os.path.join(here, "reports", "tuning_meshes",
                            f"dog_mid{name[3:]}.ply")
        out[name] = build_mesh_state(*load_ply(path), device=dev)
    return out


def _route_case(source, dtype, dev, dogs, seed):
    if source in ("dog20k", "dog45k", "dog90k"):
        return _cg_case("dog20k", dtype, dev, seed, dogs[source])
    return _cg_case(source, dtype, dev, seed)


def _ring(vp, d, c, dtype, dev, seed):
    """A ring of vp vertices, each joined to the d nearest (alternating
    sides, every third entry invalid where d > 2), and a seeded b [vp, c]."""
    ids = torch.arange(vp, device=dev)
    steps = [(k // 2 + 1) * (1 if k % 2 == 0 else -1) for k in range(d)]
    nbr = torch.stack([(ids + s) % vp for s in steps], dim=1)
    valid = torch.ones_like(nbr, dtype=torch.bool)
    if d > 2:
        valid[::3, 2] = False
    rng = np.random.default_rng(seed)
    b = torch.tensor(rng.normal(size=(vp, c)), dtype=dtype, device=dev)
    return b, nbr.contiguous(), valid.contiguous()


def _both_runs(b, nbr, valid, route, x0=None, maxiter=64, tol=1e-6):
    """The forced route twice and the plain version: bits and trips."""
    from drt_tpu_torch import kernels
    from drt_tpu_torch.optimize import precondition as PC
    counter = f"cg_{route}_launches"
    before = getattr(kernels.counters, counter)
    xk, tk = PC.cg_cuda(b, nbr, valid, 29.0, tol=tol, maxiter=maxiter,
                        x0=x0, route=route)
    xk2, tk2 = PC.cg_cuda(b, nbr, valid, 29.0, tol=tol, maxiter=maxiter,
                          x0=x0, route=route)
    torch.cuda.synchronize()
    assert getattr(kernels.counters, counter) == before + 2
    xp, tp = PC.cg_plain(b, nbr, valid, 29.0, tol=tol, maxiter=maxiter,
                         x0=x0)
    assert int(tk) == int(tk2) == int(tp) <= maxiter
    assert _cg_bits(xk, xp)
    assert _cg_bits(xk, xk2)


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("maxiter", [64, 0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("route", ["global", "shared"])
@pytest.mark.parametrize("source", ["icosphere", "cube", "dog20k", "dog45k",
                                    "dog90k"])
def test_cg_routes_match_plain(dev, dogs, source, route, dtype, maxiter,
                               given):
    """Each route, forced, against the plain version bit for bit with equal
    trips, and a second launch's bits; the shared route refuses what
    `cg_route` does not give it (float64 on dog_mid45k and dog_mid90k)."""
    from drt_tpu_torch.optimize import precondition as PC
    b, nbr, valid, x0 = _route_case(source, dtype, dev, dogs, 13)
    x0 = x0 if given else None
    if route == "shared" and PC.cg_route(*b.shape, nbr.shape[1],
                                         dtype) != "shared":
        assert source in ("dog45k", "dog90k") and dtype == torch.float64
        with pytest.raises(ValueError, match="shared route"):
            PC.cg_cuda(b, nbr, valid, 29.0, route=route)
        return
    _both_runs(b, nbr, valid, route, x0=x0, maxiter=maxiter)


@pytest.mark.parametrize("source", ["dog20k", "dog45k", "dog90k"])
def test_cg_default_route_of_the_step_sizes_is_shared(dev, dogs, source):
    """The step's float32 solves on the three meshes take the shared route
    by default, and its bits are the global route's."""
    from drt_tpu_torch import kernels
    from drt_tpu_torch.optimize import precondition as PC
    b, nbr, valid, _ = _route_case(source, torch.float32, dev, dogs, 14)
    assert PC.cg_route(*b.shape, nbr.shape[1], b.dtype) == "shared"
    before = kernels.counters.snapshot()
    xs, ts = PC.cg_cuda(b, nbr, valid, 29.0, tol=1e-6, maxiter=64)
    got = kernels.counters.snapshot()
    assert got["cg_shared_launches"] == before["cg_shared_launches"] + 1
    assert got["cg_global_launches"] == before["cg_global_launches"]
    xg, tg = PC.cg_cuda(b, nbr, valid, 29.0, tol=1e-6, maxiter=64,
                        route="global")
    assert int(ts) == int(tg) and _cg_bits(xs, xg)


@pytest.mark.parametrize("vp,dtype,takes", [
    (65536, torch.float32, True), (65537, torch.float32, False),
    (21845, torch.float64, True), (21846, torch.float64, False)])
def test_cg_shared_route_at_its_largest_size(dev, vp, dtype, takes):
    """The largest Vp the shared route takes (C = 3, 8 neighbours) and the
    first it refuses: both routes bit for bit with the plain version where
    it takes the solve; where it does not, the default is the global route
    and forcing the shared one raises."""
    from drt_tpu_torch.optimize import precondition as PC
    b, nbr, valid = _ring(vp, 8, 3, dtype, dev, 15)
    assert (PC.cg_route(vp, 3, 8, dtype) == "shared") == takes
    _both_runs(b, nbr, valid, "global", maxiter=16)
    if takes:
        _both_runs(b, nbr, valid, "shared", maxiter=16)
    else:
        with pytest.raises(ValueError, match="shared route"):
            PC.cg_cuda(b, nbr, valid, 29.0, route="shared")


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("d", [1, 8, 9])
@pytest.mark.parametrize("route", ["global", "shared"])
def test_cg_routes_at_one_and_eight_neighbours(dev, route, d, c):
    """d = 1 and d = 8 on both routes, C = 1 and 3; d = 9 only on the
    global route."""
    from drt_tpu_torch.optimize import precondition as PC
    b, nbr, valid = _ring(5000, d, c, torch.float32, dev, 16)
    if route == "shared" and d > PC.CG_SHARED_MAX_D:
        assert PC.cg_route(5000, c, d, torch.float32) == "global"
        with pytest.raises(ValueError, match="shared route"):
            PC.cg_cuda(b, nbr, valid, 29.0, route=route)
        return
    _both_runs(b, nbr, valid, route, maxiter=64, tol=1e-8)


@pytest.mark.parametrize("route", ["global", "shared"])
def test_cg_routes_take_negative_entries_as_torch_indexing_does(dev, dogs,
                                                                route):
    from drt_tpu_torch.optimize import precondition as PC
    b, nbr, valid, x0 = _route_case("dog45k", torch.float32, dev, dogs, 17)
    rows = torch.arange(nbr.shape[0], device=dev)[:, None] % 2 == 0
    neg = torch.where(valid & rows, nbr - nbr.shape[0], nbr)
    xn, tn = PC.cg_cuda(b, neg, valid, 29.0, tol=1e-6, maxiter=64, x0=x0,
                        route=route)
    xw, tw = PC.cg_cuda(b, nbr, valid, 29.0, tol=1e-6, maxiter=64, x0=x0,
                        route=route)
    assert int(tn) == int(tw) and _cg_bits(xn, xw)
    _both_runs(b, neg, valid, route, x0=x0)


@pytest.mark.parametrize("route", ["global", "shared"])
def test_cg_routes_in_a_cuda_graph(dev, dogs, route):
    """Each route captured: the replay gives the eager launch's bits, and
    the capture's launch is counted by route."""
    from drt_tpu_torch.optimize import precondition as PC
    b, nbr, valid, x0 = _route_case("dog45k", torch.float32, dev, dogs, 18)
    eager, trips = PC.cg_cuda(b, nbr, valid, 29.0, x0=x0, route=route)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        PC.cg_cuda(b, nbr, valid, 29.0, x0=x0, route=route)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        xg, tg = PC.cg_cuda(b, nbr, valid, 29.0, x0=x0, route=route)
    graph.replay()
    torch.cuda.synchronize()
    assert _cg_bits(xg, eager) and int(tg) == int(trips)


def test_cg_shared_bytes_agree_with_the_source(dev):
    """csrc/cg.cu's cg_shared_bytes against `cg_shared_bytes` over sizes
    and types, and the card's budget against CG_SHARED_BUDGET."""
    from drt_tpu_torch import kernels
    from drt_tpu_torch.optimize import precondition as PC
    lib = kernels.library("cg")
    assert lib.cg_shared_budget() >= PC.CG_SHARED_BUDGET
    for vp in (0, 1, 5, 1023, 1024, 5461, 16384, 16385, 21845, 21846,
               32768, 49152, 65536, 65537):
        for c in (1, 2, 3, 4, 16):
            for d in (0, 1, 8, 9):
                for f64 in (0, 1):
                    want = PC.cg_shared_bytes(
                        vp, c, d, torch.float64 if f64 else torch.float32)
                    got = lib.cg_shared_bytes(vp, c, d, f64)
                    assert got == (-1 if want is None else want), (vp, c, d)


# -- csrc/bounce.cu: a bounce's chain and the ray loss's tail ------------------

def _bits(t):
    """A tensor's bits (so that -0 is not +0 and NaNs compare)."""
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _bounce_inputs(dev, dtype, n, seed=0, dead=False):
    """A bounce's inputs on the card, as the step gives them: rays at (and
    from inside) a 50-unit icosphere, their hits from the kernel oracle,
    each lane's triangle (`_gather_tri9`), every tenth lane dead (all of
    them with dead=True), the parked origin; a few lanes on a triangle
    shrunk to a point and at cos_i = +-1 exactly."""
    from drt_tpu_torch.render.trace import _gather_tri9, _park_rays
    v, f = make_icosphere(subdivisions=3, radius=50.0)
    ms = build_mesh_state(v, f, dtype=dtype, device=dev)
    keep, n = n, max(n, 8)
    o1, d1 = _rays((n + 1) // 2, seed, inside=False)
    o2, d2 = _rays(n - (n + 1) // 2, seed + 1, inside=True)
    o = torch.cat([o1, o2]).to(dev, dtype)
    d = torch.cat([d1, d2]).to(dev, dtype)
    hits = CK.intersect_cuda(o, d, ms.vertices, ms.faces, ms.face_valid,
                             coherent=False)
    hit = hits.hit.clone()
    safe_id = torch.where(hit, hits.tri_id, 0).long()
    g9 = _gather_tri9(ms.vertices, ms.faces, safe_id).detach().clone()
    g9[:2] = g9[:2, :3].repeat(1, 3)                      # a point: det 0
    g9[2:4] = torch.tensor([0, 0, 0, 1, 0, 0, 0, 1, 0], dtype=dtype)
    o[2:4] = torch.tensor([[0.2, 0.3, 5.0], [0.1, 0.1, -5.0]], dtype=dtype)
    d[2:4] = torch.tensor([[0, 0, -1.0], [0, 0, 1.0]], dtype=dtype)
    hit[:4] = True
    active = (torch.arange(n, device=dev) % 10 != 7) & (not dead)
    return tuple(x[:keep].contiguous() for x in (o, d, g9, hit, active,
                                                 safe_id)) + (
        _park_rays(ms, dtype),)


@pytest.mark.parametrize("n", [4099, 0, 1])
@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bounce_kernel_matches_plain(dev, dtype, compat, n):
    """Forward, and backward with cotangents on d_out alone and on both
    outputs: every output bit for bit with the plain version on the card;
    n = 4099 is no multiple of the block, 0 and 1 the smallest batches."""
    import drt_tpu_torch.render.bounce as TB
    args = _bounce_inputs(dev, dtype, n)
    k = (1.4723, 1.00029, 1e-5, compat)
    before = CK.counters.snapshot()
    got = TB.bounce_cuda(*args, *k)
    torch.cuda.synchronize()
    want = TB.bounce_plain(*args, *k)
    assert CK.counters.bounce_launches == before["bounce_launches"] + (n > 0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))
    if n > 100:
        assert int(got[2].sum()) > n // 10
    gen = torch.Generator(device="cpu").manual_seed(3)
    go, gd = (torch.randn(n, 3, generator=gen, dtype=dtype).to(dev)
              for _ in range(2))
    for cot_o in (None, go):
        for need_o, need_d in ((True, True), (False, True), (True, False)):
            g = TB.bounce_cuda_backward(*args[:3], got[2], cot_o, gd, *k,
                                        need_origin=need_o,
                                        need_direction=need_d)
            w = TB.bounce_plain_backward(*args[:3], want[2], cot_o, gd, *k,
                                         need_origin=need_o,
                                         need_direction=need_d)
            torch.cuda.synchronize()
            for a, b in zip(g, w):
                assert (a is None) == (b is None)
                if a is not None:
                    assert torch.equal(_bits(a), _bits(b))
    g = TB.bounce_cuda_backward(*args[:3], got[2], go, None, *k)
    w = TB.bounce_plain_backward(*args[:3], want[2], go, None, *k)
    for a, b in zip(g, w):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bounce_kernel_all_lanes_dead(dev, dtype):
    """Every lane dead: parked rays, face id 0, zero gradients."""
    import drt_tpu_torch.render.bounce as TB
    args = _bounce_inputs(dev, dtype, 1000, dead=True)
    k = (1.4723, 1.00029, 1e-5, False)
    got = TB.bounce_cuda(*args, *k)
    want = TB.bounce_plain(*args, *k)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    assert not got[2].any() and not got[3].any()
    assert torch.equal(got[0], args[6].expand(1000, 3))
    gd = torch.ones(1000, 3, dtype=dtype, device=dev)
    d_o, d_d, dg9 = TB.bounce_cuda_backward(*args[:3], got[2], gd, gd, *k)
    assert not d_o.any() and not d_d.any() and not dg9.any()


def _tail_inputs(dev, dtype, n, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    o = torch.randn(n, 3, generator=gen, dtype=dtype) * 5
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen,
                                                  dtype=dtype), dim=1)
    sp = torch.randn(n, 3, generator=gen, dtype=dtype) * 40
    masks = [torch.rand(n, generator=gen) > p for p in (0.1, 0.3, 0.8)]
    return [x.to(dev) for x in (o, d, sp, *masks)]


@pytest.mark.parametrize("n", [1228800, 4099, 1, 0])
@pytest.mark.parametrize("huber", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ray_tail_kernel_matches_plain(dev, dtype, huber, n):
    """The loss (its fixed-order sum) and its gradient bit for bit with the
    plain version on the card, twice for the same bits; a full view's
    lanes, a batch that is no multiple of the block, one lane, none."""
    import drt_tpu_torch.render.bounce as TB
    args = _tail_inputs(dev, dtype, n)
    before = CK.counters.ray_tail_launches
    got = TB.ray_tail_cuda(*args, huber)
    again = TB.ray_tail_cuda(*args, huber)
    want = TB.ray_tail_plain(*args, huber)
    torch.cuda.synchronize()
    assert CK.counters.ray_tail_launches == before + 2
    assert got.shape == () and got.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(again), _bits(want))
    g = torch.full((), 0.75, dtype=dtype, device=dev)
    d_k = TB.ray_tail_cuda_backward(*args, huber, g)
    d_p = TB.ray_tail_plain_backward(*args, huber, g)
    assert torch.equal(_bits(d_k), _bits(d_p))
    if n > 1:
        assert d_k.abs().sum() > 0


def test_bounce_and_tail_functions_on_the_card_take_the_kernels(dev):
    """The autograd Functions on CUDA tensors: one kernel launch each way,
    and the plain versions never called."""
    import drt_tpu_torch.render.bounce as TB
    calls = []
    saved = {name: getattr(TB, name) for name in (
        "bounce_plain", "bounce_plain_backward", "ray_tail_plain",
        "ray_tail_plain_backward")}

    def spy(name):
        def fn(*a, **k):
            calls.append(name)
            return saved[name](*a, **k)
        return fn
    for name in saved:
        setattr(TB, name, spy(name))
    try:
        args = _bounce_inputs(dev, torch.float32, 4099)
        leaves = [a.clone().requires_grad_(True) for a in args[:3]]
        before = CK.counters.snapshot()
        o, d, alive, _ = TB.bounce_chain(*leaves, *args[3:], 1.4723,
                                         1.00029, 1e-5)
        t = _tail_inputs(dev, torch.float32, 4099)
        loss = TB.ray_tail(o, d, t[2], t[3], alive, t[5], 0.1)
        loss.backward()
        torch.cuda.synchronize()
        after = CK.counters.snapshot()
    finally:
        for name, fn in saved.items():
            setattr(TB, name, fn)
    assert calls == []
    assert after["bounce_launches"] - before["bounce_launches"] == 2
    assert after["bounce_backward_launches"] \
        - before["bounce_backward_launches"] == 1
    assert after["ray_tail_launches"] - before["ray_tail_launches"] == 2
    assert leaves[0].grad is None          # the exit origin is detached
    assert leaves[1].grad.abs().sum() > 0 and leaves[2].grad.abs().sum() > 0


# --- the one-origin route (csrc/order.cu, the order in pack and closest hit)

def _silhouette_queries(ms, dev, views=(0, 20, 45)):
    """The silhouette queries of `views` of the ring of 72 cameras around
    dog_mid90k at 1280x960 on mesh state `ms`, at the step's budget, as
    the step makes them (csrc/silhouette.cu's pre kernel's rays, its origin
    expanded over them)."""
    from drt_tpu_torch.config import POINTGRAY_RES as RES
    from drt_tpu_torch.data.synthetic import intrinsics, ring_cameras
    from drt_tpu_torch.intersect.api import Hits
    from drt_tpu_torch.optimize import default_silhouette_budget
    from drt_tpu_torch.render.camera import CameraM
    from drt_tpu_torch.render.silhouette_kernels import (one_camera,
                                                         silhouette_view_loss)
    ring = ring_cameras(load_ply(_tuning_mesh("dog_mid90k"))[0], 72)
    out = []
    for view in views:
        R = ring[view][0]
        cam = CameraM(*(torch.as_tensor(a, dtype=torch.float32, device=dev)
                        for a in (R, intrinsics(*RES), np.linalg.inv(R),
                                  np.linalg.inv(intrinsics(*RES)))))

        def record(o, d, *_, coherent):
            out.append((o.detach(), d.detach()))
            n = o.shape[0]
            return Hits(torch.full((n,), float("inf"), device=dev),
                        torch.full((n,), -1, dtype=torch.int32, device=dev))
        with torch.no_grad():
            silhouette_view_loss(
                ms, one_camera(cam, cam.R_inv[:3, 3].contiguous(),
                               torch.zeros(RES, device=dev)),
                record, default_silhouette_budget(ms.num_edges), *RES)
    return out


def _tuning_mesh(name):
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "reports", "tuning_meshes",
        f"{name}.ply")


@pytest.fixture(scope="module")
def silhouette_rays(dev):
    out = {}
    for name in ("dog_mid20k", "dog_mid45k", "dog_mid90k"):
        ms = build_mesh_state(*load_ply(_tuning_mesh(name)), device=dev)
        out[name] = (ms, _silhouette_queries(ms, dev))
    return out


def _unsorted(o, d, *geom, **kw):
    """The query on the parent's route: its rays as separate rows, the
    shift of the one-origin tensor."""
    return CK.intersect_cuda(o.contiguous(), d, *geom, coherent=False,
                             shift=o.float().mean(dim=0), **kw)


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("mesh", ["dog_mid20k", "dog_mid45k", "dog_mid90k"])
def test_order_kernel_matches_plain(dev, silhouette_rays, mesh, f64):
    """csrc/order.cu against `ray_order_plain` on the CPU: the same order
    of the three views' silhouette rays, float32 and float64 directions."""
    _, queries = silhouette_rays[mesh]
    for _, d in queries:
        d = d.double() if f64 else d
        n_pad = -(-d.shape[0] // 128) * 128 + 128
        got = CK.ray_order_cuda(d, n_pad)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), CK.ray_order_plain(d.cpu(), n_pad))


@pytest.mark.parametrize("case", ["two", "odd", "runs", "nan and inf",
                                  "one direction", "large"])
def test_order_kernel_edge_cases(dev, case):
    """Few rays, counts that are no multiple of a warp or of the cluster's
    shares, long runs of one key, NaN and infinite components, one
    direction for all, and more rays than a cluster holds at once."""
    rng = np.random.default_rng(4)
    n = {"two": 2, "odd": 1031, "runs": 5000, "nan and inf": 3000,
         "one direction": 700, "large": 300001}[case]
    d = rng.normal(size=(n, 3)) + np.array([0.0, 0.0, 3.0])
    if case == "runs":
        d = d[rng.integers(0, 9, size=n)]
    if case == "nan and inf":
        d[rng.integers(0, n, size=40), rng.integers(0, 3, size=40)] = np.nan
        d[rng.integers(0, n, size=5), 1] = np.inf
    if case == "one direction":
        d[:] = d[0]
    d = torch.tensor(d, dtype=torch.float32)
    got = CK.ray_order_cuda(d.to(dev), n + 77)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), CK.ray_order_plain(d, n + 77))


@pytest.mark.parametrize("mesh", ["dog_mid20k", "dog_mid45k", "dog_mid90k"])
def test_route_kernels_match_plain(dev, silhouette_rays, mesh):
    """On the route's inputs: the packing kernel with the order against
    `pack_plain` (int32 views), the prepass against its plain version, the
    closest hit through the order against its plain version, bit for
    bit; one order, pack, prepass and closest-hit launch a query."""
    ms, queries = silhouette_rays[mesh]
    geom = (ms.vertices, ms.faces, ms.face_valid)
    for o, d in queries:
        before = CK.counters.snapshot()
        inp = CK.prepare_inputs(o, d, *geom, coherent=False)
        after = CK.counters.snapshot()
        assert inp.order is not None and inp.group >= CK.GROUP_ONE_ORIGIN
        assert inp.phi.shape[1] // inp.count.shape[0] \
            == CK.RAY_TILE_ONE_ORIGIN
        assert (after["pack_launches"] - before["pack_launches"],
                after["candidates_launches"]
                - before["candidates_launches"]) == (1, 1)
        kw = dict(group=inp.group, ray_tile=CK.RAY_TILE_ONE_ORIGIN,
                  order=inp.order)
        shift = o.float().mean(dim=0)
        got = CK.pack_cuda(*geom, shift, o, d, **kw)
        want = CK.pack_plain(*geom, shift, o, d, **kw)
        _assert_packed_equal(got, want)
        T = inp.count.shape[0]
        cand, count = CK.candidates_plain(inp.phi[6:9], inp.inv, want.box_lo,
                                          want.box_hi, want.box_valid, T,
                                          tile=False)
        assert torch.equal(count, inp.count)
        assert torch.equal(cand, inp.cand)
        t_k, id_k = CK.closest_hit_cuda(inp)
        t_p, id_p = CK.closest_hit_plain(inp)
        assert torch.equal(id_k, id_p)
        assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))


@pytest.mark.parametrize("mesh", ["dog_mid20k", "dog_mid45k", "dog_mid90k"])
def test_route_against_parent_route_and_brute(dev, silhouette_rays, mesh):
    """The route's hit and t against the parent's route bit for bit (a
    tri_id may differ only where both name a triangle at one t), its
    tri_ids against the brute oracle on the first view within the tie
    allowance, and the counter: 1 a routed query, 0 on the parent's."""
    from drt_tpu_torch.intersect.brute import intersect_brute
    ms, queries = silhouette_rays[mesh]
    geom = (ms.vertices, ms.faces, ms.face_valid)
    for k, (o, d) in enumerate(queries):
        before = CK.counters.one_origin_queries
        h = CK.intersect_cuda(o, d, *geom, coherent=False)
        ref = _unsorted(o, d, *geom)
        assert CK.counters.one_origin_queries == before + 1
        assert int(ref.hit.sum()) > 1000
        assert torch.equal(h.hit, ref.hit)
        assert torch.equal(h.t, ref.t)
        if k == 0:
            hb = intersect_brute(o, d, *geom,
                                 tri_chunk=max(512, ms.faces.shape[0] // 512))
            n_hit = int((hb.hit | h.hit).sum())
            assert int((hb.tri_id != h.tri_id).sum()) <= max(
                1, 2 * n_hit // 1024)


def test_graphed_step_route_equals_parent_route(dev, sphere_capture):
    """Three replays of the sgd + none step as one CUDA graph with the
    route and with the parent's route: loss and state bit for bit; the
    route's replays add 8 one-origin queries each, the parent's none."""
    from drt_tpu_torch.intersect import get_intersect_fn
    from drt_tpu_torch.intersect.api import one_origin
    from drt_tpu_torch.optimize import LossWeights, make_train_step
    from drt_tpu_torch.optimize.loop import GraphedTrainStep
    _, _, cap = sphere_capture
    v0, f0 = make_icosphere(subdivisions=3, radius=47.0)
    ms = build_mesh_state(v0, f0, device=dev)
    w = LossWeights(ray_w=40.0, vh_w=2e-3, sm_w=0.08, ior=1.5)
    base = get_intersect_fn("cuda")

    def parent(o, d, v, f, fv=None, *, coherent):
        if coherent or not one_origin(o):
            return base(o, d, v, f, fv, coherent=coherent)
        return _unsorted(o.detach(), d.detach(), v.detach(), f, fv)
    ray = [[1], [3], [0]]
    silh = [[0, 1, 2, 3, 0, 1, 2, 3], [3, 2, 1, 0, 1, 1, 2, 2],
            [2, 0, 3, 1, 1, 0, 3, 2]]
    runs = []
    for oracle in (base, parent):
        init, step, _ = make_train_step(oracle, w, 96, 128, 1024)
        run = GraphedTrainStep(step, init(ms), 0.05, ms, cap.views,
                               torch.tensor(ray, device=dev),
                               torch.tensor(silh, device=dev))
        got = []
        for _ in ray:
            before = CK.counters.one_origin_queries
            loss, _ = run()
            torch.cuda.synchronize()
            got.append((loss.clone(), {k: v.clone()
                                       for k, v in run.state.items()},
                        CK.counters.one_origin_queries - before))
        run.close()
        runs.append(got)
    for (la, sa, na), (lb, sb, nb) in zip(*runs):
        assert (na, nb) == (8, 0)
        assert torch.equal(la, lb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("lanes,block", [(8, 8), (8, 16), (16, 32),
                                         (32, 64), (4, 32)])
def test_closest_hit_rays_a_warp_match_plain(dev, silhouette_rays,
                                             monkeypatch, lanes, block):
    """The one-origin route's closest hit with `lanes` rays a warp and
    `block` rays a block (BLOCK_RAYS_ONE_ORIGIN, RAY_LANES_ONE_ORIGIN)
    against its plain version, bit for bit."""
    monkeypatch.setattr(CK, "RAY_LANES_ONE_ORIGIN", lanes)
    monkeypatch.setattr(CK, "BLOCK_RAYS_ONE_ORIGIN", block)
    ms, queries = silhouette_rays["dog_mid45k"]
    o, d = queries[1]
    inp = CK.prepare_inputs(o, d, ms.vertices, ms.faces, ms.face_valid,
                            coherent=False)
    t_k, id_k = CK.closest_hit_cuda(inp)
    t_p, id_p = CK.closest_hit_plain(inp)
    assert int((id_k >= 0).sum()) > 1000
    assert torch.equal(id_k, id_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))


# --- the ray-mode prepass's cull by each tile's frustum --------------------

# The capture each mesh's ray-view queries are made under: never the mesh's
# own, so the exit rays still hit the queried one.
_CAPTURE_OF = {"dog_mid20k": "dog_mid90k", "dog_mid45k": "dog_mid90k",
               "dog_mid90k": "dog_mid45k"}


@pytest.fixture(scope="module")
def step_queries(dev, silhouette_rays):
    """{mesh: (mesh state, [(kind, origins, dirs)])}: the bounce-2 and exit
    queries of one 1280x960 view, recorded from `ray_loss` under a capture
    of another mesh, and the three silhouette views' one-origin queries."""
    from drt_tpu_torch.config import POINTGRAY_RES as RES, HyperParams
    from drt_tpu_torch.data.synthetic import synthesize_capture
    from drt_tpu_torch.intersect.api import get_intersect_fn
    from drt_tpu_torch.optimize.losses import ray_loss
    hp, caps, out = HyperParams(), {}, {}
    oracle = get_intersect_fn("cuda")
    for mesh, (ms, silhouettes) in silhouette_rays.items():
        src = _CAPTURE_OF[mesh]
        if src not in caps:
            caps[src] = synthesize_capture(
                *load_ply(_tuning_mesh(src)), name="dog", num_views=1,
                resy=RES[0], resx=RES[1], ior=hp.ior, ext_ior=hp.ext_ior,
                num_view_used=1, device=dev)
        queries = []

        def record(o, d, *geom, coherent):
            queries.append((o.detach().clone(), d.detach().clone(),
                            coherent))
            return oracle(o, d, *geom, coherent=coherent)
        with torch.no_grad():
            ray_loss(ms, caps[src].views.take(0), record, hp.ior, hp.ext_ior)
        kinds = ["bounce2", "exit"]
        ray_view = [(k, o, d) for k, (o, d, coh) in zip(kinds, queries[1:])]
        assert [coh for _, _, coh in queries] == [True, False, False]
        out[mesh] = (ms, ray_view + [("silhouette", o, d)
                                     for o, d in silhouettes])
    return out


@pytest.mark.parametrize("mesh", ["dog_mid20k", "dog_mid45k", "dog_mid90k"])
def test_culled_prepass_on_step_queries(dev, step_queries, mesh):
    """The ray mode's lists and counts on the step's bounce-2, exit and
    silhouette queries, at the groups and ray tiles the step takes, equal
    `candidates_plain(tile=False)` bit for bit, and its `kept` the row sums
    of `frustum_kept_plain`; the cull leaves out most boxes of the bounce-2
    and exit queries (their tiles of parked lanes list nothing) and some of
    every silhouette query's."""
    ms, queries = step_queries[mesh]
    geom = (ms.vertices, ms.faces, ms.face_valid)
    for kind, o, d in queries:
        inp = CK.prepare_inputs(o, d, *geom, coherent=False)
        T = inp.count.shape[0]
        lo, hi, cv = CK._chunk_aabbs(*geom, o.float().mean(dim=0),
                                     CK.TRI_CHUNK)
        _, _, boxes = CK._grouped_boxes(lo, hi, cv, inp.group)
        args = (inp.phi[6:9], inp.inv, *boxes, T)
        cand, count = CK.candidates_plain(*args, tile=False)
        assert torch.equal(inp.cand, cand), kind
        assert torch.equal(inp.count, count), kind
        kept = torch.empty(T, dtype=torch.int32, device=dev)
        cand_k, count_k = CK.candidates_cuda(*args, tile=False, kept=kept)
        assert torch.equal(cand_k, cand) and torch.equal(count_k, count)
        want = CK.frustum_kept_plain(*args).sum(dim=1).int()
        assert torch.equal(kept, want), kind
        assert bool((kept >= count).all()), kind
        share = float(kept.sum()) / (T * int(boxes[2].sum()))
        assert share < (0.2 if kind != "silhouette" else 0.9), (kind, share)


def test_kept_on_parked_and_straddling_tiles(dev, dog20k):
    """`kept` of one tile of parked lanes (`_park_rays`, PARK_DIRECTION)
    reads 0, and its list is the chunks in order with a count of 0; one
    tile of rays in every direction, which straddles every axis sign,
    reads every valid box; a tile of one origin's thin cone reads some."""
    from drt_tpu_torch.render.bounce import PARK_DIRECTION
    from drt_tpu_torch.render.trace import _park_rays
    ms = dog20k
    RT = CK.RAY_TILE_INCOHERENT
    rng = np.random.default_rng(5)
    v = ms.vertices[ms.vert_valid]
    c = v.mean(dim=0)
    park = _park_rays(ms, torch.float32).expand(RT, 3)
    inside = c + torch.tensor(rng.uniform(-5, 5, (RT, 3)),
                              dtype=torch.float32, device=dev)
    cam = c + torch.tensor([0.0, -300.0, 40.0], device=dev)
    o = torch.cat([park, inside, cam.expand(RT, 3)])
    cone = c + torch.tensor(rng.uniform(-3, 3, (RT, 3)), dtype=torch.float32,
                            device=dev) - cam
    d = torch.cat([torch.full((RT, 3), PARK_DIRECTION, device=dev),
                   torch.tensor(rng.normal(size=(RT, 3)),
                                dtype=torch.float32, device=dev), cone])
    shift = o.mean(dim=0)
    lo, hi, cv = CK._chunk_aabbs(ms.vertices, ms.faces, ms.face_valid, shift,
                                 CK.TRI_CHUNK)
    args = ((o - shift).t().contiguous(), CK._safe_inv(d).t().contiguous(),
            lo, hi, cv, 3)
    assert CK.tile_straddles(args[1], 3).tolist() == [False, True, False]
    kept = torch.full((3,), -1, dtype=torch.int32, device=dev)
    cand, count = CK.candidates_cuda(*args, tile=False, kept=kept)
    n_valid = int(cv.sum())
    assert kept.tolist()[:2] == [0, n_valid]
    assert 0 < int(kept[2]) < n_valid
    assert torch.equal(kept, CK.frustum_kept_plain(*args).sum(dim=1).int())
    assert int(count[0]) == 0
    assert torch.equal(cand[0], torch.arange(cand.shape[1], device=dev,
                                             dtype=torch.int32))
    want = CK.candidates_plain(*args, tile=False)
    assert torch.equal(cand, want[0]) and torch.equal(count, want[1])
    assert int(count[1]) > 0 and int(count[2]) > 0


# --- csrc/silhouette.cu: a silhouette view's chain around its query -------

def _bits(t):
    """A tensor's bits (so that -0 is not +0), on the CPU."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a), _bits(b))


def _silhouette_views(dev, ring_mesh, dtype, views=(0, 27, 54)):
    """A ViewBatch of the ring views `views` of 72 around ring_mesh at
    1280x960 holding what a silhouette view reads: cameras, per-ray origins
    (their first row each camera's) and soft masks of quantised levels."""
    from drt_tpu_torch.config import POINTGRAY_RES as RES
    from drt_tpu_torch.data.synthetic import intrinsics, ring_cameras
    from drt_tpu_torch.data.views import ViewBatch
    ring = ring_cameras(load_ply(_tuning_mesh(ring_mesh))[0], 72)
    Rs = np.stack([ring[v][0] for v in views])
    K = np.stack([intrinsics(*RES)] * len(views))
    rng = np.random.default_rng(7)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    origin = t(np.linalg.inv(Rs)[:, :3, 3])[:, None].expand(
        len(views), 5, 3).contiguous()
    return ViewBatch(
        screen_pixel=None, valid=None,
        mask=t(rng.choice([0.0, 0.25, 0.5, 0.75, 1.0],
                          (len(views), *RES))),
        origin=origin, ray_dir=None, R=t(Rs), K=t(K),
        R_inv=t(np.linalg.inv(Rs)), K_inv=t(np.linalg.inv(K)))


@pytest.fixture(scope="module")
def silhouette_meshes(dev):
    out = {}
    for name in ("dog_mid20k", "dog_mid45k", "dog_mid90k"):
        v, f = load_ply(_tuning_mesh(name))
        out[name] = {dt: build_mesh_state(v, f, dtype=dt, device=dev)
                     for dt in (torch.float32, torch.float64)}
    return out


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("budget", ["step", 256])
@pytest.mark.parametrize("mesh", ["dog_mid20k", "dog_mid45k", "dog_mid90k"])
def test_silhouette_kernels_match_plain(dev, silhouette_meshes, mesh,
                                        budget, f64):
    """csrc/silhouette.cu's three kernels against their plain versions run
    on the card, bit for bit, on three ring views of each dog mesh read by
    device index, at the step's budget (above the silhouette's edge
    count: edge 0 fills the rest) and at 256 (below it); the post kernel
    with the mask read truncated and bilinear; one launch of each."""
    from drt_tpu_torch.config import POINTGRAY_RES as RES
    from drt_tpu_torch.intersect import get_intersect_fn
    from drt_tpu_torch.optimize import default_silhouette_budget
    from drt_tpu_torch.render import silhouette_kernels as SK
    dtype = torch.float64 if f64 else torch.float32
    ms = silhouette_meshes[mesh][dtype]
    views = _silhouette_views(dev, "dog_mid90k", dtype)
    if budget == "step":
        budget = default_silhouette_budget(ms.num_edges)
    fn = get_intersect_fn("auto")
    g = torch.tensor(0.37, dtype=dtype, device=dev)
    for i in range(views.R.shape[0]):
        cam = SK.view_camera(views, torch.tensor([i], device=dev))
        args = (ms.vertices, ms.faces, ms.edge_faces, ms.edge_valid,
                ms.edges, cam, budget)
        before = CK.counters.snapshot()
        got = SK.silhouette_pre_cuda(*args)
        want = SK.silhouette_pre_plain(*args)
        for a, b in zip(got, want):
            _same(a, b)
        count = int(got.count)
        assert count > 300 and (count < budget) == (budget > 256)
        hits = fn(got.origin.expand(got.ray_dir.shape), got.ray_dir,
                  ms.vertices, ms.faces, ms.face_valid, coherent=False)
        assert int(hits.hit.sum()) > 100
        for bilinear in (False, True):
            lk, ck = SK.silhouette_post_cuda(hits.tri_id, got.sample,
                                             got.count, cam, *RES, bilinear)
            lp, cp = SK.silhouette_post_plain(hits.tri_id, got.sample,
                                              got.count, cam, *RES,
                                              bilinear)
            _same(lk, lp)
            _same(ck, cp)
            assert float(lk) > 0 and int((ck != 0).sum()) > 20
            dk = SK.silhouette_backward_cuda(got.normal, ck, got.pix, cam,
                                             g)
            dp = SK.silhouette_backward_plain(got.normal, ck, got.pix, cam,
                                              g)
            _same(dk, dp)
        torch.cuda.synchronize()
        after = CK.counters.snapshot()
        assert [after[k] - before[k] for k in (
            "silhouette_pre_launches", "silhouette_post_launches",
            "silhouette_backward_launches")] == [1, 2, 2]


def test_silhouette_kernels_view_without_edges_and_by_int(dev):
    """From inside an icosphere no edge is a silhouette edge: count 0, every
    slot edge 0, loss 0, gradient 0; and a view taken by int (no device
    index) as the plain version takes it, bit for bit."""
    from drt_tpu_torch.data.synthetic import intrinsics, look_at_extrinsic
    from drt_tpu_torch.data.views import ViewBatch
    from drt_tpu_torch.intersect import get_intersect_fn
    from drt_tpu_torch.render import silhouette_kernels as SK
    v, f = make_icosphere(subdivisions=4, radius=50.0)
    ms = build_mesh_state(v, f, device=dev)
    R = look_at_extrinsic(np.zeros(3), np.array([1.0, 0.2, 0.1]))
    K = intrinsics(96, 128)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                  device=dev)[None]
    views = ViewBatch(None, None, torch.full((1, 96, 128), 0.75, device=dev),
                      t(np.zeros((1, 3))), None, t(R), t(K),
                      t(np.linalg.inv(R)), t(np.linalg.inv(K)))
    cam = SK.view_camera(views, 0)
    args = (ms.vertices, ms.faces, ms.edge_faces, ms.edge_valid, ms.edges,
            cam, 512)
    got = SK.silhouette_pre_cuda(*args)
    for a, b in zip(got, SK.silhouette_pre_plain(*args)):
        _same(a, b)
    assert int(got.count) == 0 and not bool(got.edge_idx.any())
    hits = get_intersect_fn("auto")(got.origin.expand(got.ray_dir.shape),
                                    got.ray_dir, ms.vertices, ms.faces,
                                    ms.face_valid, coherent=False)
    loss, coef = SK.silhouette_post_cuda(hits.tri_id, got.sample, got.count,
                                         cam, 96, 128)
    assert float(loss) == 0.0 and not bool(coef.any())
    dV = SK.silhouette_backward_cuda(got.normal, coef, got.pix, cam,
                                     torch.tensor(1.0, device=dev))
    assert not bool(dV.any())


def test_silhouette_loss_on_the_card_takes_the_kernels(dev, sphere_capture,
                                                       monkeypatch):
    """silhouette_loss on CUDA tensors launches the three kernels (one
    each, the backward's once) and none of the torch chain's
    (`primary_visibility` is not called); its loss and gradient equal the
    plain versions' on the CPU to float32 rounding of the query's
    hits."""
    import dataclasses

    import drt_tpu_torch.render.silhouette as SIL
    from drt_tpu_torch.intersect import get_intersect_fn
    from drt_tpu_torch.optimize.losses import silhouette_loss
    _, _, cap = sphere_capture
    v0, f0 = make_icosphere(subdivisions=3, radius=47.0)
    monkeypatch.setattr(SIL, "primary_visibility", None)  # must not run
    out = {}
    for where in ("cuda", "cpu"):
        ms = build_mesh_state(v0, f0, device=dev if where == "cuda"
                              else "cpu")
        views = cap.views if where == "cuda" else type(cap.views)(
            *(None if a is None else a.cpu() for a in cap.views))
        x = ms.vertices.clone().requires_grad_(True)
        before = CK.counters.snapshot()
        loss, count = silhouette_loss(
            dataclasses.replace(ms, vertices=x), views.take(1, rays=False),
            get_intersect_fn("auto"), 1024, 96, 128)
        (g,) = torch.autograd.grad(loss, x)
        after = CK.counters.snapshot()
        out[where] = (float(loss.detach()), int(count), g.cpu(),
                      [after[k] - before[k] for k in (
                          "silhouette_pre_launches",
                          "silhouette_post_launches",
                          "silhouette_backward_launches")])
    assert out["cuda"][3] == [1, 1, 1] and out["cpu"][3] == [0, 0, 0]
    assert out["cuda"][1] == out["cpu"][1] > 0
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    gc, gp = out["cuda"][2], out["cpu"][2]
    assert float((gc - gp).abs().max()) <= 1e-4 * float(gp.abs().max())


@pytest.mark.parametrize("bilinear", [False, True])
def test_silhouette_post_reads_a_mask_larger_than_the_view(
        dev, silhouette_meshes, bilinear):
    """A mask with more rows and columns than the loss's resy and resx (a
    step built for a smaller view reads the capture's masks in place, as
    the parent's indexing did): the post kernel reads it at its own row
    stride, bit for bit with the plain version."""
    from drt_tpu_torch.intersect import get_intersect_fn
    from drt_tpu_torch.render import silhouette_kernels as SK
    ms = silhouette_meshes["dog_mid45k"][torch.float32]
    views = _silhouette_views(dev, "dog_mid90k", torch.float32)
    cam = SK.view_camera(views, torch.tensor([1], device=dev))
    pre = SK.silhouette_pre_cuda(ms.vertices, ms.faces, ms.edge_faces,
                                 ms.edge_valid, ms.edges, cam, 4096)
    hits = get_intersect_fn("auto")(pre.origin.expand(pre.ray_dir.shape),
                                    pre.ray_dir, ms.vertices, ms.faces,
                                    ms.face_valid, coherent=False)
    args = (hits.tri_id, pre.sample, pre.count, cam, 700, 900, bilinear)
    got = SK.silhouette_post_cuda(*args)
    want = SK.silhouette_post_plain(*args)
    for a, b in zip(got, want):
        _same(a, b)
    assert float(got[0]) > 0

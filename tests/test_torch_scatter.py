"""The row scatter-add (drt_tpu_torch/geometry/scatter.py, whose CUDA kernel
is csrc/scatter.cu) and the step's gathers built on it, against the JAX
package on the CPU. The plain version sums each destination's rows in
ascending row order, as JAX's CPU scatter does, so the scatter and the
`_gather_tri9` VJP on both of its routes agree with JAX bit for bit in
float32; the gradients of whole loss terms, whose chains before the
scatter round on their own, are held at a stated tolerance."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drt_tpu.geometry.normals as JN
import drt_tpu.mesh as JMESH
import drt_tpu.render.camera as JCAM
import drt_tpu.render.silhouette as JSIL
import drt_tpu_torch.render.camera as TCAM
import drt_tpu_torch.render.silhouette as TSIL
from drt_tpu.intersect import get_intersect_fn as j_get_fn
from drt_tpu.optimize.losses import smooth_loss as j_smooth
from drt_tpu.render.trace import _gather_tri9 as j_gather_tri9
from drt_tpu_torch.data.synthetic import intrinsics, look_at_extrinsic
from drt_tpu_torch.geometry.normals import vertex_normals
from drt_tpu_torch.geometry.scatter import (CLUSTER_MAX_OUT,
                                            CLUSTER_MAX_ROWS, ROUTES,
                                            gather_rows, scatter_route,
                                            scatter_rows, scatter_rows_cuda,
                                            scatter_rows_plain)
from drt_tpu_torch.intersect import cuda_kernel as CK
from drt_tpu_torch.intersect import get_intersect_fn
from drt_tpu_torch.mesh import build_mesh_state, load_ply
from drt_tpu_torch.optimize import default_silhouette_budget
from drt_tpu_torch.optimize.losses import smooth_loss
from drt_tpu_torch.render.trace import _SOUP_BWD_MAX_FACES, _gather_tri9
from tests.meshes import make_icosphere

# The test workers run side by side on few cores: torch's intra-op pool at
# its default size oversubscribes them and slows every worker down.
torch.set_num_threads(min(2, torch.get_num_threads()))

DTYPES = {"float32": (torch.float32, np.float32),
          "float64": (torch.float64, np.float64)}
DOG90 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "reports", "tuning_meshes", "dog_mid90k.ply")


def _bits(a):
    """An array's bits (so that -0 is not +0 and NaNs compare)."""
    a = np.ascontiguousarray(a)
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


def _scatter_case(case, n_cols, np_dtype, seed=0):
    """(rows [R,C], idx [R], num) from a numpy seed. "heavy": half of the
    rows land on destination 0, 30% of the rows are all +0 or all -0, some
    entries of live rows are -0, and the last destination gets no rows.
    "empty": no rows at all."""
    num = 300
    if case == "empty":
        return np.zeros((0, n_cols), np_dtype), np.zeros(0, np.int64), num
    rng = np.random.default_rng(seed)
    R = 4000
    idx = rng.integers(0, num - 1, R)
    idx[rng.random(R) < 0.5] = 0
    rows = rng.standard_normal((R, n_cols)).astype(np_dtype)
    zero = rng.random(R) < 0.3
    rows[zero] = np.where(rng.random((int(zero.sum()), 1)) < 0.5, 0.0, -0.0)
    rows[rng.random((R, n_cols)) < 0.05] = -0.0
    return rows, idx, num


@pytest.mark.parametrize("case", ["heavy", "empty"])
@pytest.mark.parametrize("n_cols", [3, 9])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_scatter_rows_plain_equals_jax_bit_for_bit(dtype, n_cols, case):
    """(a) scatter_rows_plain against jnp.zeros(...).at[idx].add(rows)."""
    t_dtype, np_dtype = DTYPES[dtype]
    rows, idx, num = _scatter_case(case, n_cols, np_dtype)
    got = scatter_rows_plain(torch.from_numpy(rows), torch.from_numpy(idx),
                             num).numpy()
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jnp.zeros((num, n_cols), np_dtype)
                          .at[jnp.asarray(idx)].add(jnp.asarray(rows)))
    assert got.dtype == want.dtype == np_dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not got[num - 1].any()
    # the wrapper's dispatch on CPU tensors gives the same bits
    again = scatter_rows(torch.from_numpy(rows), torch.from_numpy(idx), num)
    np.testing.assert_array_equal(_bits(again.numpy()), _bits(got))


def _jax_tri9_vjp(vertices, faces, safe_id, g9):
    fwd, vjp = jax.vjp(lambda v: j_gather_tri9(v, jnp.asarray(faces),
                                               jnp.asarray(safe_id)),
                       jnp.asarray(vertices))
    (dv,) = vjp(jnp.asarray(g9))
    return np.asarray(fwd), np.asarray(dv)


@pytest.mark.parametrize("mesh", ["icosphere", "dog_mid90k"])
def test_gather_tri9_value_and_vjp_equal_jax(mesh):
    """(b) the port's `_gather_tri9` against `drt_tpu.render.trace.
    _gather_tri9` in float32, value and VJP bit for bit: the icosphere
    (F <= 2^16, the soup route of the backward; N >= F, the soup forward)
    and dog_mid90k (Fp = 131,072, the direct route; 4,096 rays, the direct
    forward). About 90% of the safe_ids are 0 with zero cotangent rows
    there, as the dead lanes of a view give."""
    if mesh == "icosphere":
        v, f = make_icosphere(subdivisions=3, radius=20.0)
        n_rays = 4096
    else:
        v, f = load_ply(DOG90)
        n_rays = 4096
    ms = build_mesh_state(v, f, device="cpu")
    jms = JMESH.build_mesh_state(v, f)
    np.testing.assert_array_equal(np.asarray(jms.faces), ms.faces.numpy())
    F = ms.faces.shape[0]
    assert (F <= _SOUP_BWD_MAX_FACES) == (mesh == "icosphere")
    assert (n_rays >= F) == (mesh == "icosphere")
    rng = np.random.default_rng(7)
    safe_id = rng.integers(1, ms.num_faces, n_rays)
    dead = rng.random(n_rays) < 0.9
    safe_id[dead] = 0
    g9 = rng.standard_normal((n_rays, 9)).astype(np.float32)
    g9[dead] = 0.0
    vertices = ms.vertices.numpy()
    np.testing.assert_array_equal(vertices, np.asarray(jms.vertices))

    v_t = ms.vertices.clone().requires_grad_(True)
    out = _gather_tri9(v_t, ms.faces, torch.from_numpy(safe_id))
    (dv,) = torch.autograd.grad(out, v_t, torch.from_numpy(g9))
    j_out, j_dv = _jax_tri9_vjp(vertices, ms.faces.numpy(), safe_id, g9)
    np.testing.assert_array_equal(_bits(out.detach().numpy()), _bits(j_out))
    np.testing.assert_array_equal(_bits(dv.numpy()), _bits(j_dv))
    assert np.abs(j_dv).max() > 0


def _cam_np(i, res, np_dtype):
    th = 0.7 + i
    pos = 175.0 * np.array([np.cos(th), np.sin(th), 0.2])
    R = look_at_extrinsic(pos, np.zeros(3))
    K = intrinsics(*res)
    return [c.astype(np_dtype) for c in (R, K, np.linalg.inv(R),
                                         np.linalg.inv(K))]


@pytest.fixture(scope="module")
def bumpy():
    """A bumpy rotated icosphere (host arrays), so that its dihedral angles
    and silhouette vary from edge to edge."""
    v, f = make_icosphere(subdivisions=3, radius=50.0)
    rng = np.random.default_rng(3)
    v = v * np.clip(1 + 0.05 * rng.standard_normal(len(v))[:, None],
                    0.9, 1.1)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return v @ q.T, f


# Float32 gradients of whole loss terms: the chains before the scatter
# (normals, projection, logs) round on their own in each package, so a
# float32 entry may differ in its last bits; held to 1e-5 of the largest
# entry. Float64: rtol 1e-12.
F32_TOL = 1e-5


def _compare_grads(got, want, dtype):
    scale = np.abs(want).max()
    assert scale > 0
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * scale)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_smooth_loss_vertex_gradient_matches_jax(bumpy, dtype):
    """(c) the dihedral term's [V,3] gradient (its gather goes through
    gather_rows) against jax.grad of drt_tpu's smooth_loss."""
    t_dtype, np_dtype = DTYPES[dtype]
    v, f = bumpy
    ms = build_mesh_state(v, f, dtype=t_dtype, device="cpu")
    x = ms.vertices.clone().requires_grad_(True)
    loss = smooth_loss(dataclasses.replace(ms, vertices=x))
    (g,) = torch.autograd.grad(loss, x)
    with jax.enable_x64(dtype == "float64"):
        jms = JMESH.build_mesh_state(v, f, dtype=jnp.dtype(np_dtype))
        jl, jg = jax.value_and_grad(
            lambda x: j_smooth(jms.replace(vertices=x)))(jms.vertices)
        jl, jg = float(jl), np.asarray(jg)
    np.testing.assert_allclose(float(loss.detach()), jl,
                               rtol=1e-12 if dtype == "float64" else 1e-6)
    _compare_grads(g.numpy(), jg, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_primary_visibility_vertex_gradient_matches_jax(bumpy, dtype):
    """(c) the silhouette samples' [V,3] gradient (the endpoint gather goes
    through gather_rows) against jax.grad of drt_tpu's primary_visibility,
    for a seeded weighting of the samples' outputs."""
    t_dtype, np_dtype = DTYPES[dtype]
    v, f = bumpy
    res, budget = (24, 32), 512
    cam_np = _cam_np(1, res, np_dtype)
    origin = cam_np[2][:3, 3]
    w = np.random.default_rng(5).standard_normal(budget).astype(np_dtype)
    ms = build_mesh_state(v, f, dtype=t_dtype, device="cpu")
    x = ms.vertices.clone().requires_grad_(True)
    ts = TSIL.primary_visibility(
        dataclasses.replace(ms, vertices=x),
        TCAM.CameraM(*[torch.tensor(c) for c in cam_np]),
        torch.tensor(origin), get_intersect_fn("auto"), budget, *res)
    (g,) = torch.autograd.grad((ts.output * torch.tensor(w)).sum(), x)
    with jax.enable_x64(dtype == "float64"):
        jms = JMESH.build_mesh_state(v, f, dtype=jnp.dtype(np_dtype))
        jcam = JCAM.CameraM(*[jnp.asarray(c) for c in cam_np])

        def j_fn(x):
            s = JSIL.primary_visibility(jms.replace(vertices=x), jcam,
                                        jnp.asarray(origin),
                                        j_get_fn("brute"), budget, *res)
            return jnp.sum(s.output * jnp.asarray(w)), s.valid
        (_, j_valid), jg = jax.value_and_grad(j_fn, has_aux=True)(
            jms.vertices)
        j_valid, jg = np.asarray(j_valid), np.asarray(jg)
    np.testing.assert_array_equal(ts.valid.numpy(), j_valid)
    assert int(ts.valid.sum()) > 20
    _compare_grads(g.numpy(), jg, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_vertex_normals_match_jax(bumpy, dtype):
    """(d) vertex_normals (a gather_rows, then a scatter_rows of the corner
    contributions) against drt_tpu's segment_sum version."""
    t_dtype, np_dtype = DTYPES[dtype]
    v, f = bumpy
    ms = build_mesh_state(v, f, dtype=t_dtype, device="cpu")
    got = vertex_normals(ms.vertices, ms.faces, ms.face_valid).numpy()
    with jax.enable_x64(dtype == "float64"):
        jms = JMESH.build_mesh_state(v, f, dtype=jnp.dtype(np_dtype))
        want = np.asarray(JN.vertex_normals(jms.vertices, jms.faces,
                                            jms.face_valid))
    assert got.dtype == want.dtype == np_dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 if dtype == "float64" else 1e-6)
    np.testing.assert_array_equal(ms.normals.numpy(), got)


def test_scatter_dispatch_by_device():
    """(e) CPU tensors take the plain version (no launch counted); a device
    the kernel does not serve raises, and so does the kernel's own wrapper
    on CPU tensors."""
    rows, idx, num = _scatter_case("heavy", 3, np.float32)
    rows, idx = torch.from_numpy(rows), torch.from_numpy(idx)
    before = CK.counters.scatter_launches
    out = scatter_rows(rows, idx, num)
    assert CK.counters.scatter_launches == before
    assert torch.equal(out, scatter_rows_plain(rows, idx, num))
    with pytest.raises(ValueError, match="unsupported device"):
        scatter_rows(rows.to("meta"), idx.to("meta"), num)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        scatter_rows_cuda(rows, idx, num)


@pytest.mark.parametrize("bad", [4, -1])
def test_scatter_rows_index_out_of_range_raises(bad):
    """(e) an index outside [0, num) raises on the CPU, the negative one too
    (the kernel flags the same indices and its wrapper raises alike); the
    backward of gather_rows, whose forward wraps a negative index as x[idx]
    does, raises on it."""
    rows = torch.ones(8, 3)
    idx = torch.zeros(8, dtype=torch.int64)
    idx[5] = bad
    with pytest.raises(RuntimeError, match="out of bounds"):
        scatter_rows(rows, idx, 4)
    if bad < 0:
        x = torch.ones(4, 3, requires_grad=True)
        y = gather_rows(x, idx)
        assert torch.equal(y[5], x[-1].detach())
        with pytest.raises(RuntimeError, match="out of bounds"):
            y.sum().backward()


@pytest.mark.parametrize("bad", ["float idx", "1-d rows", "float16",
                                 "length"])
def test_scatter_rejects_bad_input(bad):
    """(e) the checks the wrapper makes before either version runs."""
    rows = torch.ones(8, 3)
    idx = torch.zeros(8, dtype=torch.int64)
    if bad == "float idx":
        idx = idx.float()
    elif bad == "1-d rows":
        rows = rows[:, 0]
    elif bad == "float16":
        rows = rows.half()
    else:
        idx = idx[:5]
    with pytest.raises(ValueError):
        scatter_rows(rows, idx, 4)


def test_gather_rows_backward_matches_advanced_indexing():
    """(f) gather_rows's value and backward against the parent's advanced
    indexing (x[idx], IndexBackward0) in float64, duplicates included."""
    rng = np.random.default_rng(11)
    x_np = rng.standard_normal((50, 3))
    idx = torch.from_numpy(rng.integers(0, 49, 1000))
    idx[::3] = 0
    g = torch.from_numpy(rng.standard_normal((1000, 3)))
    x1 = torch.tensor(x_np, requires_grad=True)
    x2 = torch.tensor(x_np, requires_grad=True)
    y1, y2 = gather_rows(x1, idx), x2[idx]
    assert torch.equal(y1, y2)
    (g1,) = torch.autograd.grad(y1, x1, g)
    (g2,) = torch.autograd.grad(y2, x2, g)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-12,
                               atol=1e-12)
    assert not g1[49].any()
    assert torch.autograd.gradgradcheck(lambda x: gather_rows(x, idx[:40]),
                                        (x1,))


# --- the kernel's routes (csrc/scatter.cu): which one a call takes --------

N_RAYS = 1280 * 960            # one Pointgray view, the step's ray view


def _step_scatter_shapes(faces_padded, edges_padded, budget, n_rays,
                         n_silh=8):
    """(kind, rows, columns, destinations into V) of every scatter call of
    one step with every loss weight on, in no particular order: the
    normals ([3F,3]), each silhouette view's endpoint gather (2 budget
    rows), the dihedral term ([6E,3]), and `_gather_tri9`'s backward in
    both bounces, on its soup route up to 2^16 padded faces (the [N,9]
    soup into F, then [3F,3]) and direct above ([3N,3])."""
    F, E = faces_padded, edges_padded
    calls = [("normals", 3 * F, 3, "V"), ("dihedral", 6 * E, 3, "V")]
    calls += [("silhouette", 2 * budget, 3, "V")] * n_silh
    if F <= _SOUP_BWD_MAX_FACES:
        calls += [("soup", n_rays, 9, F), ("second stage", 3 * F, 3, "V")] * 2
    else:
        calls += [("direct", 3 * n_rays, 3, "V")] * 2
    return calls


def test_step_scatter_shapes_match_a_recorded_step(monkeypatch):
    """The reckoning above against the scatter calls one sgd + none step
    really makes on the CPU (HyperParams() weights, a 20x24 view, 2
    silhouette views, an icosphere mesh): the same multiset of (rows,
    columns, destinations)."""
    from drt_tpu_torch.config import HyperParams
    from drt_tpu_torch.data.synthetic import synthesize_capture
    from drt_tpu_torch.geometry import scatter as SC
    from drt_tpu_torch.optimize import (LossWeights,
                                        default_silhouette_budget,
                                        make_train_step)
    hp = HyperParams()
    gt_v, gt_f = make_icosphere(subdivisions=3, radius=20.0)
    cap = synthesize_capture(gt_v, gt_f, name="ball", num_views=2, resy=20,
                             resx=24, ior=hp.ior, ext_ior=hp.ext_ior,
                             num_view_used=2, device="cpu")
    v0, f0 = make_icosphere(subdivisions=2, radius=19.0)
    ms = build_mesh_state(v0, f0, device="cpu")
    budget = default_silhouette_budget(ms.num_edges)
    w = LossWeights(ray_w=hp.ray_w, vh_w=hp.vh_w, sm_w=hp.sm_w, ior=hp.ior,
                    ext_ior=hp.ext_ior)
    init, step, _ = make_train_step(get_intersect_fn("auto"), w, 20, 24,
                                    budget)
    calls, real = [], SC.scatter_rows_plain

    def spy(rows, idx, num):
        calls.append((rows.shape[0], rows.shape[1], num))
        return real(rows, idx, num)
    monkeypatch.setattr(SC, "scatter_rows_plain", spy)
    step(init(ms), hp.start_lr, ms, cap.views, 0, [0, 1])
    V = ms.vertices.shape[0]
    want = [(r, c, V if n == "V" else n) for _, r, c, n in
            _step_scatter_shapes(ms.faces.shape[0], ms.edges.shape[0],
                                 budget, 20 * 24, n_silh=2)]
    assert sorted(calls) == sorted(want)


@pytest.mark.parametrize("mesh", ["dog_mid20k", "dog_mid45k", "dog_mid90k"])
def test_scatter_route_on_the_step_calls(mesh):
    """`scatter_route` on every scatter call of the reference-parity step
    (1280x960, 8 silhouette views) on the three dog meshes: the cluster
    route for every call up to CLUSTER_MAX_ROWS rows and CLUSTER_MAX_OUT
    output elements, which takes every silhouette view on all three (16,384,
    32,768 and 65,536 rows); the grid route for the bounces' soup and direct
    scatters (1,228,800 rows of 9, 3,686,400 of 3) and every call above the
    cap (where the grid route measured as fast or faster)."""
    path = os.path.join(os.path.dirname(DOG90), f"{mesh}.ply")
    ms = build_mesh_state(*load_ply(path), device="cpu")
    budget = default_silhouette_budget(ms.num_edges)
    V = ms.vertices.shape[0]
    calls = _step_scatter_shapes(ms.faces.shape[0], ms.edges.shape[0],
                                 budget, N_RAYS)
    assert len(calls) == (14 if ms.faces.shape[0] <= 2 ** 16 else 12)
    for kind, rows, cols, num in calls:
        num = V if num == "V" else num
        route = scatter_route(rows, cols, num)
        fits = rows <= CLUSTER_MAX_ROWS and num * cols <= CLUSTER_MAX_OUT
        assert route == ("cluster" if fits else "grid"), (kind, rows)
        if kind == "silhouette":
            assert route == "cluster"
        if kind in ("soup", "direct"):
            assert route == "grid"


def test_scatter_route_at_and_above_the_cap():
    """The cluster route up to the cap in rows and in output elements, the
    grid route one above either, and at 2^24 destinations."""
    assert scatter_route(CLUSTER_MAX_ROWS, 3, 100) == "cluster"
    assert scatter_route(CLUSTER_MAX_ROWS + 1, 3, 100) == "grid"
    assert scatter_route(0, 3, 10) == "cluster"
    assert scatter_route(1000, 16, CLUSTER_MAX_OUT // 16) == "cluster"
    assert scatter_route(1000, 16, CLUSTER_MAX_OUT // 16 + 1) == "grid"
    assert scatter_route(1000, 1, 2 ** 24) == "grid"
    assert scatter_route(2 ** 24, 9, 65536) == "grid"
    assert set(ROUTES) == {"cluster", "grid"}


def test_scatter_signature_and_routes_match_the_source():
    """csrc/scatter.cu read as text: its scatter_signature() is the
    argument list of its row in kernels.LAUNCHES (one ctypes type an
    argument), its route numbers are the wrapper's
    ROUTES in order, and MAX_COLS is 16."""
    import re
    from drt_tpu_torch import kernels
    src = open(os.path.join(os.path.dirname(kernels.__file__), "csrc",
                            "scatter.cu")).read()
    sig = re.search(r'scatter_signature\(\) \{\s*return "([^"]*)";', src)
    assert sig and sig.group(1).split() == list(kernels.ROWS["scatter"][0])
    assert len(sig.group(1).split()) == len(kernels.ROWS["scatter"][1])
    for i, route in enumerate(ROUTES):
        assert re.search(rf"#define ROUTE_{route.upper()} {i}\b", src)
    assert re.search(r"#define MAX_COLS 16\b", src)


def test_scatter_kinds_label_the_step_calls():
    """chip_smoke.py's `scatter_kinds`, which names each recorded call of
    the profiled step, on the reckoned calls of dog_mid45k (the soup
    route) and a mesh above 2^16 padded faces (the direct route), in the
    order the step makes them (normals first, the second stages after
    their soups)."""
    import types
    import chip_smoke
    for F, E, budget in ((65536, 65536, 16384), (131072, 131072, 32768)):
        calls = _step_scatter_shapes(F, E, budget, N_RAYS)
        order = ([calls[0]] + [c for c in calls if c[0] == "silhouette"]
                 + [calls[1]] + [c for c in calls if c[0] in (
                     "soup", "second stage", "direct")])
        mesh = types.SimpleNamespace(faces=torch.zeros(F, 3),
                                     edges=torch.zeros(E, 2))
        kinds = chip_smoke.scatter_kinds([(r, c, n) for _, r, c, n in order],
                                         mesh, budget, N_RAYS)
        assert kinds == [k for k, _, _, _ in order]
